"""Fused SPFH sweep kernel (Pallas, Triton route).

The hot inner computation of FPFH (reference workload:
pcl::FPFHEstimation, map_merge_3d/src/dispatch_descriptors.h:40): for every
needed surface point, bin the Darboux pair features of all in-radius
candidates into the 33-bin SPFH histogram. The plain formulation
(ops/descriptors/fpfh.py) evaluates the pair features and then 33 masked
reductions over the candidate axis. This kernel evaluates the Darboux frame
once per pair, bins it, and keeps the 33 bins plus the pair count in
registers while it loops over candidate chunks; only the finished
histograms are written to device memory. Block and chunk sizes were chosen
by scripts/kernel_sweep.py on an H100 (PERF.md).

Layout: one program per block of `block_q` queries of one slab. Queries
arrive component-major as (B, 8, Cq) [x y z nx ny nz 0 0] and candidates as
(Bc, 8, M) [x y z nx ny nz ok 0], so every load is a power-of-two row
slice, as Triton requires. Pair planes are (block_q, chunk) tiles: about
fifteen of them plus 34 accumulator planes are live at once, so registers
bound the tile size. With
Bc == 1 every slab shares one candidate array (the dense all-in-radius
sweep), read through the index map instead of replicated.

The math is that of ops/descriptors/darboux.pair_features and bin_index,
step for step, with PCL's sum-100 SPFH normalisation applied at the end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BINS = 11
_EPS = 1.0e-12
_PI = float(jnp.pi)
#: output rows: 33 histogram bins + the pair count
_ROWS = 3 * _BINS + 1


def _bin(value, lo: float, hi: float):
    """darboux.bin_index: PCL floor-and-clip binning."""
    idx = jnp.floor((value - lo) / (hi - lo) * _BINS).astype(jnp.int32)
    return jnp.clip(idx, 0, _BINS - 1)


def _spfh_kernel(q_ref, c_ref, out_ref, *, r2: float, chunk: int,
                 n_chunks: int):
    """q_ref (8, block_q), c_ref (8, M), out_ref (34, block_q).

    Each bin keeps a (block_q, chunk) plane of partial sums, one per
    thread's lanes, and reduces it across lanes once at the end: a
    cross-lane reduction per chunk and bin costs more than the whole pair
    evaluation."""
    qx, qy, qz, qnx, qny, qnz = (q_ref[k, :][:, None] for k in range(6))

    def body(t, acc):
        sl = pl.ds(pl.multiple_of(t * chunk, chunk), chunk)
        cx, cy, cz, cnx, cny, cnz, cok = (
            c_ref[k, sl][None, :] for k in range(7)
        )
        # pair geometry (block_q, chunk): d = candidate - query
        dx = cx - qx
        dy = cy - qy
        dz = cz - qz
        dist2 = dx * dx + dy * dy + dz * dz
        dist = jnp.sqrt(jnp.maximum(dist2, _EPS))
        dhx = dx / dist
        dhy = dy / dist
        dhz = dz / dist

        # role swap: the source is the point whose normal is better
        # aligned with the connecting line
        cos1 = qnx * dhx + qny * dhy + qnz * dhz
        cos2 = -(cnx * dhx + cny * dhy + cnz * dhz)
        swap = jnp.abs(cos1) < jnp.abs(cos2)
        nsx = jnp.where(swap, cnx, qnx)
        nsy = jnp.where(swap, cny, qny)
        nsz = jnp.where(swap, cnz, qnz)
        ntx = jnp.where(swap, qnx, cnx)
        nty = jnp.where(swap, qny, cny)
        ntz = jnp.where(swap, qnz, cnz)
        dsx = jnp.where(swap, -dhx, dhx)
        dsy = jnp.where(swap, -dhy, dhy)
        dsz = jnp.where(swap, -dhz, dhz)
        phi = jnp.where(swap, cos2, cos1)

        # Darboux frame u = ns, v = normalize(ds x u), w = u x v
        vx = dsy * nsz - dsz * nsy
        vy = dsz * nsx - dsx * nsz
        vz = dsx * nsy - dsy * nsx
        vnorm2 = vx * vx + vy * vy + vz * vz
        vn = jnp.sqrt(jnp.maximum(vnorm2, _EPS))
        vx = vx / vn
        vy = vy / vn
        vz = vz / vn
        wx = nsy * vz - nsz * vy
        wy = nsz * vx - nsx * vz
        wz = nsx * vy - nsy * vx

        alpha = vx * ntx + vy * nty + vz * ntz
        theta = jnp.arctan2(
            wx * ntx + wy * nty + wz * ntz, nsx * ntx + nsy * nty + nsz * ntz
        )
        ok = (
            (dist2 > _EPS) & (vnorm2 > _EPS) & (dist * dist <= r2)
            & (cok > 0.0)
        )
        w = jnp.where(ok, 1.0, 0.0)

        cols = [
            jnp.where(src == b, w, 0.0)
            for src in (
                _bin(theta, -_PI, _PI), _bin(alpha, -1.0, 1.0),
                _bin(phi, -1.0, 1.0),
            )
            for b in range(_BINS)
        ] + [w]
        return tuple(a + c for a, c in zip(acc, cols))

    acc = jax.lax.fori_loop(
        0, n_chunks, body,
        tuple(
            jnp.zeros((qx.shape[0], chunk), jnp.float32) for _ in range(_ROWS)
        ),
    )
    acc = [jnp.sum(a, axis=1) for a in acc]
    total = acc[-1]
    scale = jnp.where(total > 0, 100.0 / jnp.maximum(total, 1.0), 0.0)
    for k in range(_ROWS - 1):
        out_ref[k, :] = acc[k] * scale
    out_ref[_ROWS - 1, :] = total


def _pad_last(a: jax.Array, multiple: int, value: float) -> jax.Array:
    pad = (-a.shape[-1]) % multiple
    if pad:
        a = jnp.concatenate(
            [a, jnp.full(a.shape[:-1] + (pad,), value, a.dtype)], axis=-1
        )
    return a


@functools.partial(
    jax.jit,
    static_argnames=("r2", "block_q", "chunk", "num_warps", "interpret"),
)
def spfh_tile_pallas(
    q_xyz: jax.Array,  # (B, Cq, 3)
    q_nrm: jax.Array,  # (B, Cq, 3)
    cand_xyz: jax.Array,  # (Bc, M, 3), Bc in {1, B}
    cand_nrm: jax.Array,  # (Bc, M, 3)
    cand_ok: jax.Array,  # (Bc, M) bool
    r2: float,
    block_q: int = 4,
    chunk: int = 64,
    num_warps: int = 4,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """SPFH histograms for query slabs: ((B, Cq, 33) f32, (B, Cq) counts).

    Drop-in for the plain slab/tile functions of ops/descriptors/fpfh.py
    (same math, PCL sum-100 normalisation applied). `interpret=True` runs
    the same kernel through the Pallas interpreter (CPU testing)."""
    b, cq, _ = q_xyz.shape
    bc = cand_xyz.shape[0]
    shared = bc == 1 and b > 1
    f32 = jnp.float32
    block_q = min(block_q, pl.next_power_of_2(cq))
    qpack = _pad_last(
        jnp.concatenate(
            [
                jnp.swapaxes(q_xyz.astype(f32), 1, 2),  # (B, 3, Cq)
                jnp.swapaxes(q_nrm.astype(f32), 1, 2),
                jnp.zeros((b, 2, cq), f32),
            ],
            axis=1,
        ),
        block_q, 0.0,
    )  # (B, 8, Cq padded); padded queries are dropped below
    cpack = _pad_last(
        jnp.concatenate(
            [
                jnp.swapaxes(cand_xyz.astype(f32), 1, 2),  # (Bc, 3, M)
                jnp.swapaxes(cand_nrm.astype(f32), 1, 2),
                cand_ok.astype(f32)[:, None, :],
                jnp.zeros((bc, 1, cand_ok.shape[-1]), f32),
            ],
            axis=1,
        ),
        chunk, 0.0,
    )  # (Bc, 8, M padded); padded candidates carry ok = 0
    cq_pad, m = qpack.shape[-1], cpack.shape[-1]

    kernel = functools.partial(
        _spfh_kernel, r2=float(r2), chunk=chunk, n_chunks=m // chunk
    )
    out = pl.pallas_call(
        kernel,
        grid=(b, cq_pad // block_q),
        in_specs=[
            pl.BlockSpec((None, 8, block_q), lambda i, j: (i, 0, j)),
            pl.BlockSpec(
                (None, 8, m),
                (lambda i, j: (0, 0, 0)) if shared
                else (lambda i, j: (i, 0, 0)),
            ),
        ],
        out_specs=pl.BlockSpec((None, _ROWS, block_q), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((b, _ROWS, cq_pad), f32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        interpret=interpret,
        name="spfh_sweep",
    )(qpack, cpack)
    out = jnp.swapaxes(out[:, :, :cq], 1, 2)  # (B, Cq, 34)
    return out[..., : 3 * _BINS], out[..., 3 * _BINS]
