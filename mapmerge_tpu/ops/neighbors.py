"""Dense tiled neighbor engine — the replacement for PCL kd-trees.

Every neighborhood query in the reference goes through pcl::search::KdTree
(radius search in RadiusOutlierRemoval/NormalEstimation/descriptor
estimators, k-NN in matching — see SURVEY.md §2b). Pointer-chasing trees
do not batch, so here *all* neighbor queries are exact dense distance
computations, tiled over the query axis so only a (tile, P) slab is ever
materialized. Squared distances come from the matmul identity
|q-p|^2 = |q|^2 + |p|^2 - 2 q.p; inputs are centered first to keep the
cancellation error well below the radii in play.

All functions are mask-aware: invalid points are parked at FAR by the cloud
model, and masks are applied explicitly on top.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import FAR
from mapmerge_tpu import pallas

#: squared-distance value used to exclude masked pairs
BIG = 1.0e12

#: capacity above which "auto" switches radius queries from the dense
#: O(Q*P) engine to the cell-grid engine (ops/grid.py): the grid wins once
#: the quadratic slab traffic dominates. Chosen on the earlier
#: accelerator; not measured on the H100.
GRID_AUTO_THRESHOLD = 131072
#: bounded 1-NN (ICP correspondence + transform score) switches earlier.
#: Chosen on the earlier accelerator; not measured on the H100.
GRID_NN_THRESHOLD = 49152


def _resolve_engine(engine: str, p_count: int, threshold: int | None = None) -> str:
    """'auto' -> dense for small clouds (exact oracle, no caps), grid past
    the op-specific threshold where dense slab traffic becomes the wall.
    Env MAPMERGE_ENGINE=dense|grid forces one engine everywhere."""
    import os

    forced = os.environ.get("MAPMERGE_ENGINE", "")
    if forced in ("dense", "grid"):
        return forced
    if engine != "auto":
        return engine
    cut = GRID_AUTO_THRESHOLD if threshold is None else threshold
    return "grid" if p_count >= cut else "dense"


def _center(q: jax.Array, p: jax.Array, p_mask: jax.Array | None):
    """Shift both point sets by the (valid-)mean of p to tame cancellation."""
    if p_mask is None:
        mean = jnp.mean(p, axis=0)
    else:
        w = p_mask.astype(p.dtype)
        mean = jnp.sum(p * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    return q - mean, p - mean


def sq_dists(q: jax.Array, p: jax.Array) -> jax.Array:
    """(Q, 3) x (P, 3) -> (Q, P) squared distances via one matmul."""
    qq = jnp.sum(q * q, axis=-1, keepdims=True)
    pp = jnp.sum(p * p, axis=-1, keepdims=True)
    qp = jnp.dot(
        q,
        p.T,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return jnp.maximum(qq + pp.T - 2.0 * qp, 0.0)


def _pad_queries(q: jax.Array, tile: int) -> tuple[jax.Array, int]:
    n = q.shape[0]
    num_tiles = -(-n // tile)
    pad = num_tiles * tile - n
    if pad:
        q = jnp.concatenate([q, jnp.full((pad, q.shape[1]), FAR, q.dtype)], axis=0)
    return q, n


def tiled_query(
    q: jax.Array,
    p: jax.Array,
    tile_fn: Callable[[jax.Array], jax.Array | tuple],
    tile: int = 1024,
):
    """Run `tile_fn` over (tile, 3) query slabs and concatenate results.

    `tile_fn` receives a (tile, 3) slab of queries and returns array(s) whose
    leading dim is `tile`. Sequential `lax.map` over slabs bounds peak memory
    at one (tile, P) distance slab.
    """
    q_padded, n = _pad_queries(q, tile)
    slabs = q_padded.reshape(-1, tile, q.shape[1])
    out = jax.lax.map(tile_fn, slabs)
    return jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:])[:n], out
    )


def radius_count(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
    include_self: bool = True,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """Counts of p-points within `radius` of each query: ((Q,) int32,
    query-overflow count).

    Backs the RadiusOutlierRemoval equivalent (reference
    src/features.cpp:31-43). `include_self=False` subtracts the query point
    itself when q is drawn from p (a zero-distance hit). The overflow
    scalar counts queries the grid engine dropped at its query-side bucket
    cap (always 0 on the exact dense path) — callers surface it.
    """
    if _resolve_engine(engine, p.shape[0]) == "grid":
        from mapmerge_tpu.ops.grid import grid_radius_count

        return grid_radius_count(
            q, p, radius, p_mask=p_mask,
            include_self=include_self, scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = jnp.float32(radius * radius)
    pm = None if p_mask is None else p_mask

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        within = d2 <= r2
        if pm is not None:
            within = within & pm[None, :]
        counts = jnp.sum(within, axis=-1).astype(jnp.int32)
        return counts

    counts = tiled_query(qc, pc, tile_fn, tile)
    if not include_self:
        counts = counts - 1
    return counts, jnp.zeros((), jnp.int32)


def radius_neighbors(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    k: int,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
    exclude_self: bool = False,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Up to `k` nearest p-points within `radius` per query.

    Returns (idx (Q, k) int32, d2 (Q, k) f32, valid (Q, k) bool, overflow
    () int32), nearest first. This is the fixed-degree gather that replaces
    PCL's variable-size radiusSearch results (SURVEY.md §7 "Hard parts":
    capped neighborhoods). `overflow` counts queries the grid engine
    dropped at its query-side bucket cap (0 on the dense path).
    """
    if _resolve_engine(engine, p.shape[0]) == "grid":
        from mapmerge_tpu.ops.grid import grid_radius_neighbors

        return grid_radius_neighbors(
            q, p, radius, k, p_mask=p_mask,
            exclude_self=exclude_self, scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = jnp.float32(radius * radius)
    k_eff = min(k, p.shape[0])


    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        if p_mask is not None:
            d2 = jnp.where(p_mask[None, :], d2, BIG)
        if exclude_self:
            d2 = jnp.where(d2 <= 1e-12, BIG, d2)
        neg, idx = jax.lax.top_k(-d2, k_eff)
        d2k = -neg
        valid = d2k <= r2
        return idx.astype(jnp.int32), d2k, valid

    idx, d2k, valid = tiled_query(qc, pc, tile_fn, tile)
    if k_eff < k:  # pad back to the requested fixed width
        pad = k - k_eff
        idx = jnp.pad(idx, ((0, 0), (0, pad)))
        d2k = jnp.pad(d2k, ((0, 0), (0, pad)), constant_values=BIG)
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    return idx, d2k, valid, jnp.zeros((), jnp.int32)


def nearest_neighbor(
    q: jax.Array,
    p: jax.Array,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
    bound: float | None = None,
    q_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact 1-NN: (idx (Q,), squared distance (Q,), overflow () int32).

    Backs ICP correspondence search and transformScore (reference
    src/matching.cpp:196-221, 259-268). On the GPU the dense path is the
    fused kernel (pallas/nn.py); on the CPU it is the tiled jnp path
    below (pallas.use_kernels decides).

    With `bound` given, matches beyond it may be reported with d2 = BIG —
    exact for consumers that discard matches past the bound (ICP, score).
    A bound is required for the grid engine; without one, large clouds
    stay on the dense path. `overflow` counts queries the grid engine
    dropped at its query-side bucket cap — those come back unmatched
    (d2 = BIG); 0 on the dense paths. `q_mask` marks the queries
    that actually need answers: masked-out queries are excluded from the
    overflow count (they return the unmatched default either way).
    """
    if bound is not None and (
        _resolve_engine(engine, p.shape[0], GRID_NN_THRESHOLD) == "grid"
    ):
        from mapmerge_tpu.ops.grid import grid_nearest_neighbor

        return grid_nearest_neighbor(
            q, p, bound=bound, p_mask=p_mask, scan_cap=scan_cap,
            q_mask=q_mask,
        )
    if pallas.use_kernels():
        from mapmerge_tpu.pallas.nn import nearest_neighbor_pallas

        idx, d2 = nearest_neighbor_pallas(q, p, p_mask)
        return idx, d2, jnp.zeros((), jnp.int32)
    qc, pc = _center(q, p, p_mask)

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        if p_mask is not None:
            d2 = jnp.where(p_mask[None, :], d2, BIG)
        idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        return idx, jnp.min(d2, axis=-1)

    idx, d2 = tiled_query(qc, pc, tile_fn, tile)
    return idx, d2, jnp.zeros((), jnp.int32)


def radius_reduce(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    values: jax.Array,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
    reduce: str = "sum",
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reduce `values` (P, C) over each query's radius neighborhood.

    reduce="sum": returns (count (Q,), sums (Q, C), overflow) via one
    matmul per tile (w @ values with w the within-radius {0,1} matrix).
    reduce="max": returns (count (Q,), maxes (Q, C), overflow) via masked
    max. The workhorse behind Harris response accumulation and non-max
    suppression — any per-neighborhood statistic without a kd-tree.
    `overflow` counts grid-engine query-side bucket-cap drops (0 dense).
    """
    if _resolve_engine(engine, p.shape[0]) == "grid":
        from mapmerge_tpu.ops.grid import grid_radius_reduce

        return grid_radius_reduce(
            q, p, radius, values, p_mask=p_mask,
            reduce=reduce, scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = jnp.float32(radius * radius)

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        within = d2 <= r2
        if p_mask is not None:
            within = within & p_mask[None, :]
        count = jnp.sum(within, axis=-1).astype(jnp.int32)
        if reduce == "sum":
            w = within.astype(jnp.float32)
            out = jnp.dot(
                w, values, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
        elif reduce == "max":
            out = jnp.max(
                jnp.where(within[:, :, None], values[None], -BIG), axis=1
            )
        else:
            raise ValueError(f"unknown reduce: {reduce}")
        return count, out

    count, out = tiled_query(qc, pc, tile_fn, tile)
    return count, out, jnp.zeros((), jnp.int32)


def neighbor_moments(
    q: jax.Array,
    p: jax.Array,
    radius: float,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Zeroth/first/second moments of the radius neighborhood of each query.

    Returns (count (Q,), mean (Q, 3), cov (Q, 3, 3), overflow () int32)
    where cov is the neighborhood covariance — everything NormalEstimation
    needs (reference src/features.cpp:168-179), computed entirely as
    matmuls: w @ 1, w @ p, and w @ (p ⊗ p) with w the {0,1} within-radius
    matrix. `overflow` counts grid-engine query-bucket drops (0 dense).
    """
    if _resolve_engine(engine, p.shape[0]) == "grid":
        from mapmerge_tpu.ops.grid import grid_neighbor_moments

        return grid_neighbor_moments(
            q, p, radius, p_mask=p_mask, scan_cap=scan_cap,
        )
    qc, pc = _center(q, p, p_mask)
    r2 = jnp.float32(radius * radius)
    # outer products flattened to (P, 9): upper triangle would suffice but 9
    # keeps the layout trivially matmul-able
    pp = (pc[:, :, None] * pc[:, None, :]).reshape(-1, 9)

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        within = d2 <= r2
        if p_mask is not None:
            within = within & p_mask[None, :]
        w = within.astype(jnp.float32)
        s0 = jnp.sum(w, axis=-1)
        s1 = jnp.dot(
            w, pc, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        s2 = jnp.dot(
            w, pp, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        denom = jnp.maximum(s0, 1.0)[:, None]
        mean = s1 / denom
        e_outer = s2 / denom[..., None].reshape(-1, 1)
        cov = e_outer.reshape(-1, 3, 3) - mean[:, :, None] * mean[:, None, :]
        return s0, mean, cov

    count, mean, cov = tiled_query(qc, pc, tile_fn, tile)
    # un-center the mean back to the input frame
    if p_mask is None:
        shift = jnp.mean(p, axis=0)
    else:
        w = p_mask.astype(p.dtype)
        shift = jnp.sum(p * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    return count, mean + shift, cov, jnp.zeros((), jnp.int32)
