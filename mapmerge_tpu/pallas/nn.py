"""Fused exact 1-nearest-neighbour kernel (Pallas, Triton route).

ICP correspondence search and transformScore query every source point
against the whole target cloud on every iteration (reference analog: the
kd-tree query inside pcl::IterativeClosestPoint,
map_merge_3d/src/matching.cpp:196-221, and the validator
src/matching.cpp:259-268). The plain path (ops/neighbors.nearest_neighbor)
writes a (tile, P) squared-distance slab to device memory per query tile
and reduces it. This kernel keeps the running (min, argmin) of a block of
queries in registers while it loops over target tiles, so device memory
sees only the points themselves and the Q results. Tile sizes were chosen
by scripts/kernel_sweep.py on an H100 (PERF.md).

Distances use the direct (q-p)^2 expansion: it is exact enough without
the centering pass the matmul identity |q|^2+|p|^2-2qp needs, and a
contraction over 3 components gains nothing from the tensor cores.

Layout: one program per block of `tile_q` queries; targets arrive as one
component-major (4, P) array [x, y, z, mask penalty], so every load is a
power-of-two row slice, as Triton requires. Ties break to the first
occurrence (jnp.argmin semantics): strictly-better updates keep each
lane's earliest tile, and the final cross-lane reduction takes the
smallest index at the minimum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: squared-distance penalty for masked target points (matches
#: ops/neighbors.BIG)
BIG = 1.0e12
#: coordinate of padded query rows (far from every real point)
_PAD_Q = 1.0e8


def _nn_kernel(q_ref, p_ref, idx_ref, d2_ref, *, tile_p: int, n_tiles: int):
    """q_ref (4, TQ) query block, p_ref (4, P) all targets; writes the
    block's (TQ,) argmin indices and squared distances.

    The running (min, argmin) is kept per (query, lane) across target
    tiles and reduced across lanes once at the end: a cross-lane argmin
    per tile costs more than the distances themselves."""
    qx = q_ref[0, :][:, None]
    qy = q_ref[1, :][:, None]
    qz = q_ref[2, :][:, None]
    tq = qx.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (tq, tile_p), 1)

    def body(t, carry):
        best_d2, best_idx = carry
        sl = pl.ds(pl.multiple_of(t * tile_p, tile_p), tile_p)
        dx = qx - p_ref[0, sl][None, :]
        dy = qy - p_ref[1, sl][None, :]
        dz = qz - p_ref[2, sl][None, :]
        # the mask penalty keeps invalid targets out without a select
        d2 = dx * dx + dy * dy + dz * dz + p_ref[3, sl][None, :]
        better = d2 < best_d2  # strict: an earlier tile wins a tie
        return (
            jnp.where(better, d2, best_d2),
            jnp.where(better, lane + t * tile_p, best_idx),
        )

    init = (
        jnp.full((tq, tile_p), jnp.inf, jnp.float32),
        jnp.zeros((tq, tile_p), jnp.int32),
    )
    best_d2, best_idx = jax.lax.fori_loop(0, n_tiles, body, init)
    # first occurrence across lanes: the smallest index at the minimum
    m = jnp.min(best_d2, axis=1)
    idx_ref[:] = jnp.min(
        jnp.where(best_d2 == m[:, None], best_idx, jnp.int32(2**31 - 1)),
        axis=1,
    )
    d2_ref[:] = m


def _pad_cols(a: jax.Array, multiple: int, value: float) -> jax.Array:
    pad = (-a.shape[-1]) % multiple
    if pad:
        a = jnp.concatenate(
            [a, jnp.full(a.shape[:-1] + (pad,), value, a.dtype)], axis=-1
        )
    return a


@functools.partial(
    jax.jit,
    static_argnames=("tile_q", "tile_p", "num_warps", "interpret"),
)
def nearest_neighbor_pallas(
    q: jax.Array,
    p: jax.Array,
    p_mask: jax.Array | None = None,
    tile_q: int = 32,
    tile_p: int = 128,
    num_warps: int = 4,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Exact 1-NN: (idx (Q,) int32, squared distance (Q,) f32).

    Drop-in for the dense path of ops/neighbors.nearest_neighbor.
    `interpret=True` runs the same kernel through the Pallas interpreter
    (CPU testing)."""
    n_q = q.shape[0]
    f32 = jnp.float32
    if p_mask is None:
        pen = jnp.zeros((p.shape[0],), f32)
    else:
        pen = jnp.where(p_mask, 0.0, f32(BIG))
    qt = _pad_cols(
        jnp.concatenate([q.astype(f32).T, jnp.zeros((1, n_q), f32)]),
        tile_q, _PAD_Q,
    )  # (4, Qpad)
    pt = jnp.concatenate(
        [_pad_cols(p.astype(f32).T, tile_p, 0.0),
         _pad_cols(pen[None, :], tile_p, BIG)]
    )  # (4, Ppad); padded targets carry the mask penalty
    n_tiles = pt.shape[1] // tile_p

    kernel = functools.partial(_nn_kernel, tile_p=tile_p, n_tiles=n_tiles)
    idx, d2 = pl.pallas_call(
        kernel,
        grid=(qt.shape[1] // tile_q,),
        in_specs=[
            pl.BlockSpec((4, tile_q), lambda i: (0, i)),
            pl.BlockSpec((4, pt.shape[1]), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((tile_q,), lambda i: (i,)),
            pl.BlockSpec((tile_q,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qt.shape[1],), jnp.int32),
            jax.ShapeDtypeStruct((qt.shape[1],), f32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        interpret=interpret,
        name="nearest_neighbor",
    )(qt, pt)
    return idx[:n_q], d2[:n_q]


@functools.partial(jax.jit, static_argnames=("tile",))
def nearest_neighbor_direct(
    q: jax.Array,
    p: jax.Array,
    p_mask: jax.Array | None = None,
    tile: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Plain jnp 1-NN in the kernel's own direct-difference arithmetic:
    the float32 reference the kernel is checked against, and the version
    XLA compiles on its own that the kernel has to beat."""
    from mapmerge_tpu.ops.neighbors import tiled_query

    q = q.astype(jnp.float32)
    p = p.astype(jnp.float32)
    pen = (
        jnp.zeros((p.shape[0],), jnp.float32)
        if p_mask is None
        else jnp.where(p_mask, 0.0, jnp.float32(BIG))
    )

    def tile_fn(q_slab):
        d = q_slab[:, None, :] - p[None, :, :]
        d2 = jnp.sum(d * d, axis=-1) + pen[None, :]
        return jnp.argmin(d2, axis=-1).astype(jnp.int32), jnp.min(d2, axis=-1)

    return tiled_query(q, p, tile_fn, tile)
