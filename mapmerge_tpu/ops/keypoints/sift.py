"""SIFT 3D keypoint detection on color intensity.

JAX equivalent of pcl::SIFTKeypoint<PointXYZRGB, PointWithScale> as
configured by the reference (src/features.cpp:45-62, 92): scale-space
difference-of-Gaussians over the RGB intensity channel
(PCL IntensityFieldAccessor: (299 R + 587 G + 114 B) / 1000 with 8-bit
channels), fixed 3 octaves x 3 scales per octave with min_scale =
registration resolution, and min_contrast = keypoint_threshold.

Per octave (base scale doubling each octave, PCL sift_keypoint.hpp):
  1. nr_scales+3 Gaussian-smoothed intensity fields, each one tiled
     (tile, P) matmul pass: w_s = exp(-d^2 / 2 sigma_s^2) bounded at 3 sigma_max;
     smoothed = (w @ I) / (w @ 1);
  2. DoG between adjacent scales;
  3. extrema: a point is a keypoint at interior DoG level s if its value is
     the strict max or min among its 25 spatial nearest neighbors' values at
     levels s-1, s, s+1 and |DoG| > min_contrast (PCL compares the same
     spatial neighborhood across the three levels);
  4. between octaves the cloud is voxel-downsampled with leaf = 2 * octave
     scale (PCL detectKeypoints' VoxelGrid step) — this bounds neighborhood
     sizes at higher octaves (the octave radius doubles but so does point
     spacing) and keypoints of octave o live on the o-times-downsampled
     cloud, exactly like PCL.
Keypoints from all octaves are pooled and the top `max_keypoints` by |DoG|
kept (fixed capacity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import FAR, PointCloud
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.neighbors import (
    BIG,
    _center,
    _resolve_engine,
    radius_neighbors,
    sq_dists,
    tiled_query,
)

_KNN = 25  # PCL's spatial neighborhood for extremum tests
#: radius (in units of the octave scale) bounding the 25-NN search under
#: the grid engine: points are spaced >= the previous octave's voxel leaf,
#: so 8 scales comfortably covers 25 surface neighbors
_GRID_KNN_RADIUS_SCALES = 8.0


def _intensity(rgb: jax.Array) -> jax.Array:
    """PCL IntensityFieldAccessor<PointXYZRGB>: (299R+587G+114B)/1000, 8-bit
    channels (our rgb is [0,1], so scale by 255 to match PCL magnitudes —
    min_contrast thresholds then carry over)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (299.0 * r + 587.0 * g + 114.0 * b) * (255.0 / 1000.0)


def _scale_space(
    cloud: PointCloud,
    intensity: jax.Array,
    sigmas: list[float],
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
) -> jax.Array:
    """Gaussian-smoothed intensities for every sigma: (S, P)."""
    if _resolve_engine(engine, cloud.capacity) == "grid":
        from mapmerge_tpu.ops.grid import grid_gaussian_smooth

        # self-query: the query grid is the point grid, so query overflow
        # equals build overflow, bounded by the feature-stage probe
        out, _ = grid_gaussian_smooth(
            cloud.xyz, cloud.xyz, intensity, sigmas, p_mask=cloud.mask,
            scan_cap=scan_cap,
        )  # (P, S)
        return out.T
    max_sigma = max(sigmas)
    r2_bound = jnp.float32((3.0 * max_sigma) ** 2)
    qc, pc = _center(cloud.xyz, cloud.xyz, cloud.mask)
    vals = jnp.where(cloud.mask, intensity, 0.0)
    maskf = cloud.mask.astype(jnp.float32)

    def tile_fn(q_slab):
        d2 = sq_dists(q_slab, pc)
        bounded = (d2 <= r2_bound).astype(jnp.float32) * maskf[None, :]
        outs = []
        for s in sigmas:
            w = jnp.exp(-d2 / jnp.float32(2.0 * s * s)) * bounded
            num = jnp.dot(
                w, vals[:, None], precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )[:, 0]
            den = jnp.sum(w, axis=-1)
            outs.append(num / jnp.maximum(den, 1e-12))
        return jnp.stack(outs, axis=-1)  # (tile, S)

    out = tiled_query(qc, pc, tile_fn, tile)  # (P, S)
    return out.T  # (S, P)


def detect_keypoints_sift(
    cloud: PointCloud,
    min_scale: float,
    octaves: int,
    scales_per_octave: int,
    min_contrast: float,
    max_keypoints: int,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Keypoints:
    """Reference features.cpp:45-62: setScales(min_scale, octaves, scales),
    setMinimumContrast(min_contrast)."""
    from mapmerge_tpu.ops.downsample import voxel_downsample

    p = cloud.capacity
    cand_resp = []
    cand_xyz = []
    base = float(min_scale)
    oct_cloud = cloud
    for octave in range(octaves):
        p_oct = oct_cloud.capacity
        # spatial neighborhood for extremum tests on THIS octave's cloud
        # (pure k-NN; radius unbounded). Slot 0 is the point itself.
        knn = min(_KNN + 1, p_oct)
        # dense engine: true unbounded k-NN (PCL semantics). grid engine:
        # radius-bounded k-NN — _GRID_KNN_RADIUS_SCALES octave scales cover
        # the 25 nearest on any surface denser than the octave voxel leaf
        # (sparse edges degrade to fewer neighbors, like PCL at borders)
        knn_radius = (
            _GRID_KNN_RADIUS_SCALES * base
            if _resolve_engine(engine, p_oct) == "grid"
            else 1.0e6
        )
        idx, _, nmask, _ = radius_neighbors(
            oct_cloud.xyz, oct_cloud.xyz, radius=knn_radius, k=knn,
            p_mask=oct_cloud.mask, tile=tile, engine=engine,
            scan_cap=scan_cap,
        )
        nbr_idx = idx[:, 1:]
        nbr_ok = nmask[:, 1:]
        intensity = _intensity(oct_cloud.rgb)

        n_s = scales_per_octave + 3
        sigmas = [base * (2.0 ** (s / scales_per_octave)) for s in range(n_s)]
        smoothed = _scale_space(
            oct_cloud, intensity, sigmas, tile, engine, scan_cap
        )  # (S, P)
        dog = smoothed[1:] - smoothed[:-1]  # (S-1, P)

        for s in range(1, dog.shape[0] - 1):
            val = dog[s]  # (P,)
            # neighbor DoG values across the three adjacent levels
            levels = dog[s - 1 : s + 2]  # (3, P)
            nbr_vals = levels[:, nbr_idx]  # (3, P, K)
            nbr_vals = jnp.where(nbr_ok[None], nbr_vals, jnp.nan)
            own_adjacent = jnp.stack([dog[s - 1], dog[s + 1]])  # (2, P)
            hi = jnp.fmax(
                jnp.nanmax(nbr_vals, axis=(0, 2)), jnp.max(own_adjacent, axis=0)
            )
            lo = jnp.fmin(
                jnp.nanmin(nbr_vals, axis=(0, 2)), jnp.min(own_adjacent, axis=0)
            )
            is_ext = (val > hi) | (val < lo)
            keep = oct_cloud.mask & is_ext & (jnp.abs(val) > min_contrast)
            cand_resp.append(jnp.where(keep, jnp.abs(val), -BIG))
            cand_xyz.append(oct_cloud.xyz)
        # PCL downsamples the cloud between octaves (VoxelGrid, leaf =
        # 2 * octave scale) — next octave runs on the coarser cloud. The
        # octave capacity SHRINKS to a third: a surface occupies <= 1/4 of
        # the previous voxel count after doubling the leaf (area / leaf^2),
        # and the dense per-octave passes are O(P^2) — running every octave
        # at full capacity tripled the SIFT stage for nothing (profiled).
        if octave < octaves - 1:
            oct_cloud = voxel_downsample(
                oct_cloud, 2.0 * base,
                out_capacity=max(p_oct // 3, min(2048, p_oct)),
            )
        base *= 2.0

    resp_all = jnp.concatenate(cand_resp)  # (L*P,)
    xyz_all = jnp.concatenate(cand_xyz)  # (L*P, 3)
    k = min(max_keypoints, resp_all.shape[0])
    top_resp, top_i = jax.lax.top_k(resp_all, k)
    kp_mask = top_resp > -BIG / 2
    kp_xyz = jnp.where(kp_mask[:, None], xyz_all[top_i], FAR)
    if k < max_keypoints:
        pad = max_keypoints - k
        kp_xyz = jnp.concatenate(
            [kp_xyz, jnp.full((pad, 3), FAR, jnp.float32)]
        )
        top_resp = jnp.concatenate([top_resp, jnp.zeros((pad,))])
        kp_mask = jnp.concatenate([kp_mask, jnp.zeros((pad,), bool)])
    return Keypoints(
        xyz=kp_xyz,
        response=jnp.where(kp_mask, top_resp, 0.0),
        mask=kp_mask,
        truncated=jnp.maximum(
            jnp.sum(resp_all > -BIG / 2).astype(jnp.int32)
            - jnp.int32(max_keypoints),
            0,
        ),
    )
