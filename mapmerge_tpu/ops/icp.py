"""Iterative Closest Point refinement.

JAX equivalent of pcl::IterativeClosestPoint as configured by the
reference (src/matching.cpp:196-221): point-to-point ICP seeded by an
initial guess, correspondences bounded by max_correspondence_distance,
transformation-epsilon convergence, max-iterations cap; the result composes
with the guess (the reference pre-transforms the source and returns
icp_result * initial_guess — here the accumulated transform starts at the
guess, which is algebraically identical).

Correspondence search is the exact tiled dense 1-NN (ops/neighbors) — no
kd-tree; each iteration is two dense passes (NN + weighted Kabsch). The whole
loop is a lax.while_loop, so vmapping over a batch of pairs runs all pairs
until each converges (SURVEY.md §2c: batched ICP over all map pairs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.neighbors import nearest_neighbor
from mapmerge_tpu.ops.rigid import kabsch


def icp_refine(
    source: PointCloud,
    target: PointCloud,
    initial: jax.Array,
    max_correspondence_distance: float,
    outlier_rejection_threshold: float,
    max_iterations: int,
    transform_epsilon: float,
    tile: int = 1024,
    anneal: float = 0.85,
    min_correspondence_distance: float | None = None,
    scan_cap: int = 256,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Refine `initial` (source->target).
    Returns (transform, converged, scan_overflow).

    `scan_overflow` is the worst per-iteration count of moved-source query
    points the grid engine dropped at its query-side bucket cap — those
    points silently lose their correspondence, so callers surface the
    counter (a source cloud denser than the target grid's buckets is
    otherwise invisible). Always 0 on the dense engine.

    Coarse-to-fine: the correspondence bound starts at
    `max_correspondence_distance` and shrinks by `anneal` each iteration
    down to `min_correspondence_distance` (default bound/8). A wide first
    bound captures the basin; the tightening schedule sheds the
    wrong-surface attractions that bias plain bounded ICP on partially
    overlapping maps (SURVEY.md §7: coarse-to-fine ladder). Set anneal=1.0
    for strict PCL fixed-bound semantics.

    `outlier_rejection_threshold` is the batched analog of PCL's
    setRANSACOutlierRejectionThreshold (reference src/matching.cpp:206,
    set to inlier_threshold at :253): each iteration fits on the bounded
    correspondences, rejects those whose residual under that fit exceeds
    the threshold, and refits on the surviving set — a trimmed two-pass
    refit instead of PCL's sequential per-iteration RANSAC. <= 0 disables.

    `converged` is False when no iteration ever found >= 3 bounded
    correspondences (e.g. a zero/failed initial guess) — callers keep the
    unrefined transform then (pipeline/registration.py).
    """
    eps = jnp.float32(transform_epsilon)
    d_hi = jnp.float32(max_correspondence_distance)
    d_lo = jnp.float32(
        min_correspondence_distance
        if min_correspondence_distance is not None
        else max_correspondence_distance / 8.0
    )
    reject2 = jnp.float32(outlier_rejection_threshold) ** 2

    # the target never moves: under the cell-grid engine, build its grid
    # ONCE here instead of re-sorting it every while_loop iteration. The
    # bound is the widest cell in the whole pipeline — double capacity.
    from mapmerge_tpu.ops.neighbors import GRID_NN_THRESHOLD, _resolve_engine

    use_grid = (
        _resolve_engine("auto", target.capacity, GRID_NN_THRESHOLD) == "grid"
    )
    if use_grid:
        from mapmerge_tpu.ops.grid import build_grid, grid_nn_query

        target_grid = build_grid(
            target.xyz, target.mask,
            float(max_correspondence_distance), cap=scan_cap,
        )

    def _nn(moved):
        # q_mask: only the valid source points count toward query overflow
        # (padded slots never need a correspondence)
        if use_grid:
            return grid_nn_query(
                target_grid, moved, target.capacity, q_mask=source.mask
            )
        return nearest_neighbor(
            moved, target.xyz, p_mask=target.mask, tile=tile,
            bound=float(max_correspondence_distance), scan_cap=scan_cap,
            q_mask=source.mask,
        )

    def step(state):
        t, _, it, _, ever_ok, prev_mse, worst_of = state
        dist = jnp.maximum(d_hi * jnp.float32(anneal) ** it, d_lo)
        moved = tf.apply(t, source.xyz)
        idx, d2, overflow = _nn(moved)
        worst_of = jnp.maximum(worst_of, overflow)
        w = (source.mask & (d2 <= dist * dist)).astype(jnp.float32)
        matched = target.xyz[idx]
        delta, ok = kabsch(moved, matched, w)
        if outlier_rejection_threshold > 0:
            # trimmed refit: drop correspondences that the first fit says
            # are outliers, refit on the survivors
            resid2 = jnp.sum((tf.apply(delta, moved) - matched) ** 2, axis=-1)
            w_in = w * (resid2 <= reject2)
            delta2, ok2 = kabsch(moved, matched, w_in)
            delta = jnp.where(ok2, delta2, delta)
            ok = ok | ok2
        t_new = jnp.where(ok, tf.compose(delta, t), t)
        # convergence needs BOTH gates (PCL DefaultConvergenceCriteria
        # combines a transform-change epsilon with a relative-MSE check):
        # the transform gate alone fires during slow-tail convergence and
        # strands degrees of residual error
        change = jnp.sqrt(jnp.sum((t_new - t) ** 2))
        mse = jnp.sum(jnp.where(w > 0, d2, 0.0)) / jnp.maximum(jnp.sum(w), 1.0)
        rel_mse = jnp.abs(mse - prev_mse) / jnp.maximum(prev_mse, 1e-12)
        if anneal >= 1.0:  # fixed-bound mode: no ladder to descend
            at_floor = jnp.asarray(True)
        else:
            at_floor = d_hi * jnp.float32(anneal) ** it <= d_lo
        done = jnp.where(
            ok, (change < eps) & (rel_mse < 1e-4) & at_floor, True
        )
        return t_new, done, it + 1, ok, ever_ok | ok, mse, worst_of

    def cond(state):
        _, done, it, _, _, _, _ = state
        return jnp.logical_not(done) & (it < max_iterations)

    init = (
        initial.astype(jnp.float32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(1.0e30, jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    t, _, _, _, ever_ok, _, worst_of = jax.lax.while_loop(cond, step, init)
    return t, ever_ok, worst_of
