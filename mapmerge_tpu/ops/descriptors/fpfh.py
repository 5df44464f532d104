"""FPFH-33 descriptors.

JAX equivalent of pcl::FPFHEstimation (reference
dispatch_descriptors.h:40, FPFHSignature33): Simplified Point Feature
Histograms per surface point, then distance-weighted aggregation over each
keypoint's neighborhood.

PCL semantics kept:
- SPFH sub-histograms (11 bins each for theta/alpha/phi) normalized to
  sum 100 over the neighborhood;
- FPFH(keypoint) = sum over its surface neighbors j (distance > 0) of
  (1/d_j) SPFH_j, then each 11-bin block renormalized to 100 (PCL's
  weightPointSPFHSignature, which skips zero-distance self hits);
- descriptors with empty neighborhoods are invalid (the reference drops
  them with their keypoints, features.cpp:118-141; we mask);
- SPFH is computed ONLY at the keypoints' neighbor points — exactly PCL's
  computeSPFHSignatures optimization (fpfh.hpp collects the distinct
  neighbor set of the requested indices).

Two engines, dispatched like every neighbor op (ops/neighbors.py):
- dense (small clouds): SPFH neighborhoods via the capped radius gather
  (radius_neighbors, nearest-first, max_neighbors cap), histograms as
  one-hot matmuls in lax.map slabs.
- grid (at scale): SPFH accumulated DIRECTLY on the cell grid — one pass
  computes the Darboux pair features of every (needed point, in-radius
  candidate) pair and reduces them into the 33 bins in place. No top-k, no
  per-neighbor index materialization, no per-row gathers, and no
  max_neighbors cap (all in-radius points contribute, like PCL; the only
  cap is the grid bucket capacity, which is counted as overflow). The
  "needed point" mask (union of the keypoints' neighborhoods, deduplicated
  by construction — each cloud point's SPFH is computed once however many
  keypoints share it) makes grid_query's empty-tile skipping effective.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.descriptors.darboux import bin_index, pair_features
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.neighbors import _resolve_engine, radius_neighbors
from mapmerge_tpu.ops.normals import SurfaceNormals
from mapmerge_tpu import pallas

_BINS = 11
_PI = float(jnp.pi)


def spfh_tile_plain(
    q_xyz: jax.Array,  # (B, Cq, 3)
    q_nrm: jax.Array,  # (B, Cq, 3)
    cand_xyz: jax.Array,  # (Bc, M, 3), Bc in {1, B}
    cand_nrm: jax.Array,  # (Bc, M, 3)
    cand_ok: jax.Array,  # (Bc, M) bool
    r2: float,
) -> tuple[jax.Array, jax.Array]:
    """SPFH histograms of query slabs against their candidates, in plain
    jnp: ((B, Cq, 33) PCL sum-100 histograms, (B, Cq) pair counts).

    The Darboux features of every (query, candidate) pair are binned in
    place — the 33 bins are separate masked reductions over the candidate
    axis (no (B, Cq, M, 33) one-hot tensor, no neighbor index lists). With
    Bc == 1 every slab sweeps the same candidates, one slab at a time.
    This is the reference the kernel (pallas/spfh.py) is checked against,
    and the path the CPU takes."""
    r2 = jnp.float32(r2)

    def tile(q_blk, qn_blk, c_xyz, c_nrm, c_ok):
        theta, alpha, phi, dist, pair_ok = pair_features(
            q_blk[:, :, None, :], qn_blk[:, :, None, :],
            c_xyz[:, None, :, :], c_nrm[:, None, :, :],
        )  # (B, Cq, M)
        d2 = dist * dist
        # pair_ok already excludes the zero-distance self hit (PCL pairs a
        # point with its neighbors, not itself)
        w = (c_ok[:, None, :] & pair_ok & (d2 <= r2)).astype(jnp.float32)
        t_i = bin_index(theta, -_PI, _PI, _BINS)
        a_i = bin_index(alpha, -1.0, 1.0, _BINS)
        p_i = bin_index(phi, -1.0, 1.0, _BINS)
        cols = [
            jnp.sum(w * (src == b), axis=-1)
            for src in (t_i, a_i, p_i)
            for b in range(_BINS)
        ]
        hist = jnp.stack(cols, axis=-1)  # (B, Cq, 33)
        total = jnp.sum(w, axis=-1)
        scale = jnp.where(total > 0, 100.0 / jnp.maximum(total, 1.0), 0.0)
        return hist * scale[..., None], total

    if cand_xyz.shape[0] == 1 and q_xyz.shape[0] > 1:
        spfh, total = jax.lax.map(
            lambda a: tile(a[0][None], a[1][None], cand_xyz, cand_nrm,
                           cand_ok),
            (q_xyz, q_nrm),
        )  # (B, 1, Cq, ...)
        return spfh[:, 0], total[:, 0]
    return tile(q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok)


def _spfh_tiles():
    """The SPFH sweep for this platform: the fused kernel on the GPU, the
    plain jnp version on the CPU (pallas.use_kernels)."""
    if pallas.use_kernels():
        from mapmerge_tpu.pallas.spfh import spfh_tile_pallas

        return spfh_tile_pallas
    return spfh_tile_plain


def _spfh_dense(
    q_xyz: jax.Array,
    q_nrm: jax.Array,
    q_ok: jax.Array,
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    max_neighbors: int,
    tile: int,
    scan_cap: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """SPFH (Q, 33) at the given oriented query points + validity (Q,).

    Dense-engine path: a masked ALL-in-radius sweep against the full cloud
    — every valid point within `radius` contributes to the histogram,
    exactly PCL's SPFH (no neighbor cap), and the same semantics as the
    grid-engine sweep. This replaced a top-k neighbor-list formulation
    (capped nearest-48 gather + one-hot histograms): the k-selection over
    (Q, P) distance slabs dominated the stage, while the pure masked
    reduction sweep is elementwise and reduction work. `max_neighbors` is
    unused here (kept for signature parity — it still caps the
    keypoint-neighborhood gather in compute_fpfh).
    """
    p_ok = cloud.mask & normals.valid
    q = q_xyz.shape[0]
    # slab rows per step: bounds the (Cq, P) pair planes of the plain path.
    # Chosen on the earlier accelerator; not measured on the H100.
    cq = min(q, 128)
    pad = (-q) % cq

    def pad0(a):
        return (
            jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
            if pad
            else a
        )

    # shared-candidate mode: candidate leading dim 1 — every query slab
    # sweeps the same cloud
    spfh, total = _spfh_tiles()(
        pad0(q_xyz).reshape(-1, cq, 3), pad0(q_nrm).reshape(-1, cq, 3),
        cloud.xyz[None], normals.normals[None], p_ok[None],
        r2=float(radius) * float(radius),
    )  # (b, cq, 33), (b, cq)
    spfh = spfh.reshape(-1, 3 * _BINS)[:q]
    total = total.reshape(-1)[:q]
    # q_ok gates validity only (masked-out queries are swept — their FAR
    # coordinates make every pair fail the radius test, so total = 0)
    return spfh, q_ok & (total > 0)


def _spfh_grid(
    cloud: PointCloud,
    normals: SurfaceNormals,
    needed: jax.Array,
    radius: float,
    scan_cap: int,
    tile: int = 8,
    grid=None,
) -> tuple[jax.Array, jax.Array]:
    """SPFH (P, 33) at every cloud point flagged `needed` + pair counts (P,).

    One grid pass: every (needed point, valid in-radius candidate) pair of
    each cell tile goes through the SPFH sweep (_spfh_tiles).

    `grid`: optional prebuilt CellGrid of the cloud at `radius` (shared
    with the keypoint-neighborhood query by compute_fpfh). The query-side
    grid is DERIVED from it by masking (masked_query_grid) — the queries
    are the grid's own points — so the whole FPFH stage pays for exactly
    one 1M-point sort instead of three."""
    from mapmerge_tpu.ops.grid import (
        build_grid,
        grid_query,
        masked_query_grid,
    )

    p_ok = cloud.mask & normals.valid
    if grid is None:
        grid = build_grid(cloud.xyz, p_ok, radius, None, scan_cap)
    qg = masked_query_grid(grid, needed & p_ok, cloud.capacity)
    sweep = _spfh_tiles()

    def tile_fn(q_block, cand_xyz, cand_ok, cand_idx, q_nrm, cand_nrm):
        return sweep(
            q_block, q_nrm, cand_xyz, cand_nrm, cand_ok,
            r2=float(radius) * float(radius),
        )

    nrm = normals.normals
    (spfh, total), _ = grid_query(
        cloud.xyz, grid, tile_fn,
        (jnp.zeros((3 * _BINS,), jnp.float32), jnp.float32(0)),
        tile=tile, q_values=nrm, p_values=nrm, qg=qg,
    )
    return spfh, total


def compute_fpfh(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """FPFH-33 at each keypoint over the full-resolution search surface
    (reference features.cpp:99-150 template instantiated with
    pcl::FPFHEstimation)."""
    p_ok = cloud.mask & normals.valid
    n = cloud.capacity
    if _resolve_engine(engine, n) == "grid":
        # ONE shared grid build for the whole stage: the keypoint
        # neighborhood query (small-Q gather path) and the SPFH sweep use
        # the same cell size (descriptor radius) — reusing the grid, and
        # deriving the sweep's query grid by masking, cuts three 1M-point
        # sorts down to one
        from mapmerge_tpu.ops.grid import (
            SMALL_Q_THRESHOLD,
            _radius_neighbors_smallq,
            build_grid,
            grid_radius_neighbors,
        )

        grid = build_grid(cloud.xyz, p_ok, radius, None, scan_cap)
        if keypoints.xyz.shape[0] <= SMALL_Q_THRESHOLD:
            idx, d2, nmask = _radius_neighbors_smallq(
                keypoints.xyz, grid, cloud.xyz.shape[0], radius,
                max_neighbors, exclude_self=False,
            )
        else:
            idx, d2, nmask, _ = grid_radius_neighbors(
                keypoints.xyz, cloud.xyz, radius, max_neighbors,
                p_mask=p_ok, scan_cap=scan_cap,
            )
        # deduplicated needed-point mask: each cloud point in any keypoint
        # neighborhood gets its SPFH computed exactly once
        sel = jnp.where(nmask, idx, n).reshape(-1)
        needed = jnp.zeros((n + 1,), bool).at[sel].set(True)[:n]
        spfh_all, npairs = _spfh_grid(
            cloud, normals, needed, radius, scan_cap, grid=grid,
        )
        flat = idx.reshape(-1)
        spfh = spfh_all[flat].reshape(idx.shape + (3 * _BINS,))
        spfh_ok = (npairs[flat].reshape(idx.shape) > 0) & nmask
    else:
        idx, d2, nmask, _ = radius_neighbors(
            keypoints.xyz, cloud.xyz, radius, max_neighbors,
            p_mask=p_ok, tile=tile, engine=engine, scan_cap=scan_cap,
        )  # (K, M) keypoint neighborhoods
        # SPFH only at the gathered neighbor points (PCL
        # computeSPFHSignatures); duplicates recompute — a fixed-shape
        # gather program cannot dedupe, and K*M stays far below P
        flat_idx = idx.reshape(-1)  # (K*M,)
        q_xyz = cloud.xyz[flat_idx]
        q_nrm = normals.normals[flat_idx]
        q_ok = p_ok[flat_idx] & nmask.reshape(-1)
        spfh_flat, spfh_ok_flat = _spfh_dense(
            cloud=cloud, normals=normals, q_xyz=q_xyz, q_nrm=q_nrm,
            q_ok=q_ok, radius=radius, max_neighbors=max_neighbors,
            tile=tile, scan_cap=scan_cap,
        )
        spfh = spfh_flat.reshape(idx.shape[0], idx.shape[1], 3 * _BINS)
        spfh_ok = spfh_ok_flat.reshape(idx.shape)

    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    w = jnp.where(
        nmask & spfh_ok & (dist > 1e-9) & keypoints.mask[:, None],
        1.0 / jnp.maximum(dist, 1e-9),
        0.0,
    )  # (K, M)
    fpfh = jnp.einsum(
        "km,kmd->kd", w, spfh, precision=jax.lax.Precision.HIGHEST
    )

    # renormalize each 11-bin block to sum 100
    blocks = fpfh.reshape(-1, 3, _BINS)
    sums = jnp.sum(blocks, axis=-1, keepdims=True)
    blocks = jnp.where(sums > 0, blocks * (100.0 / jnp.maximum(sums, 1e-9)), 0.0)
    data = blocks.reshape(-1, 3 * _BINS)

    valid = keypoints.mask & (jnp.sum(w, axis=-1) > 0)
    return Descriptors(data=jnp.where(valid[:, None], data, 0.0), valid=valid)
