"""RSD — radius-based surface descriptor (principal radii).

JAX equivalent of pcl::RSDEstimation -> pcl::PrincipalRadiiRSD
(reference dispatch_descriptors.h:43): for each keypoint, estimate the
minimum and maximum local surface curvature radii from the relation
d(alpha) ~= 2 r sin(alpha/2) between neighbor distance d and normal
angle alpha. Following the RSD scheme, neighbors are binned by normal angle,
the minimum distance per angle bin gives a radius estimate, and the extreme
estimates across bins give (r_min, r_max), clamped at `plane_radius`
(near-parallel normals = locally planar = huge radius).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.neighbors import radius_neighbors
from mapmerge_tpu.ops.normals import SurfaceNormals

_ANGLE_BINS = 5  # PCL nr_subdiv default
_PLANE_RADIUS = 0.2  # PCL plane_radius default
_BIG = 1.0e12


def compute_rsd(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    plane_radius: float = _PLANE_RADIUS,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    p_ok = cloud.mask & normals.valid
    # keypoint queries: overflow bounded by the feature-stage probe
    idx, d2, nmask, _ = radius_neighbors(
        keypoints.xyz, cloud.xyz, radius, max_neighbors,
        p_mask=p_ok, tile=tile, engine=engine, scan_cap=scan_cap,
    )
    nmask = nmask & keypoints.mask[:, None]
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))  # (K, M)

    nbr_nrm = normals.normals[idx]  # (K, M, 3)
    # keypoint normal: nearest valid surface point's normal (keypoints may
    # sit off-cloud after refinement)
    kp_nrm = nbr_nrm[:, 0, :]
    cos_a = jnp.clip(
        jnp.abs(jnp.sum(kp_nrm[:, None, :] * nbr_nrm, axis=-1)), 0.0, 1.0
    )
    alpha = jnp.arccos(cos_a)  # (K, M) in [0, pi/2]

    half_pi = jnp.pi / 2.0
    abin = jnp.clip(
        jnp.floor(alpha / half_pi * _ANGLE_BINS), 0, _ANGLE_BINS - 1
    ).astype(jnp.int32)

    # min distance per angle bin (masked)
    oh = jax.nn.one_hot(abin, _ANGLE_BINS, dtype=jnp.float32)  # (K, M, A)
    masked_d = jnp.where(nmask[..., None] * (oh > 0), dist[..., None], _BIG)
    dmin = jnp.min(masked_d, axis=1)  # (K, A)
    bin_has = dmin < _BIG / 2

    centers = (jnp.arange(_ANGLE_BINS) + 0.5) / _ANGLE_BINS * half_pi
    r_est = dmin / jnp.maximum(2.0 * jnp.sin(centers / 2.0)[None, :], 1e-6)
    r_est = jnp.clip(r_est, 0.0, plane_radius)
    r_est = jnp.where(bin_has, r_est, jnp.nan)

    r_min = jnp.nan_to_num(jnp.nanmin(r_est, axis=-1), nan=plane_radius)
    r_max = jnp.nan_to_num(jnp.nanmax(r_est, axis=-1), nan=plane_radius)

    valid = keypoints.mask & (jnp.sum(nmask, axis=-1) >= 3)
    data = jnp.stack([r_min, r_max], axis=-1)
    return Descriptors(data=jnp.where(valid[:, None], data, 0.0), valid=valid)
