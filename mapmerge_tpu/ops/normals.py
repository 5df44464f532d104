"""Surface-normal + curvature estimation.

JAX equivalent of pcl::NormalEstimation as used by the reference
(map_merge_3d/src/features.cpp:168-179): per-point PCA over the radius
neighborhood, normal = smallest-eigenvalue eigenvector, curvature =
l0 / (l0 + l1 + l2), normals flipped towards the viewpoint (PCL default
viewpoint = origin). Neighborhood moments are matmuls
(ops/neighbors.neighbor_moments); the eigen solve is closed-form
(ops/eigh3), so the whole op is one fused XLA program — no kd-tree.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.eigh3 import smallest_eigenpair3
from mapmerge_tpu.ops.neighbors import neighbor_moments


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SurfaceNormals:
    """Padded per-point normals, aligned index-for-index with their cloud.

    Mirrors the reference's parallel `SurfaceNormals` cloud
    (typedefs.h:21-24); `valid` marks points whose neighborhood admitted a
    stable plane fit (PCL emits NaN normals there).
    """

    normals: jax.Array  # (N, 3) float32, unit length (or +z placeholder)
    curvature: jax.Array  # (N,) float32
    valid: jax.Array  # (N,) bool


def compute_surface_normals(
    cloud: PointCloud,
    radius: float,
    viewpoint: tuple[float, float, float] = (0.0, 0.0, 0.0),
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> SurfaceNormals:
    """Estimate normals for every valid point of `cloud`.

    Reference contract: features.cpp:168-179 (radius search, PCA normal,
    flipNormalTowardsViewpoint with the default (0,0,0) viewpoint).
    """
    # query overflow bounded by the feature-stage probe (self-query: the
    # query grid is the point grid, at a narrower radius than the probe's)
    count, _, cov, _ = neighbor_moments(
        cloud.xyz, cloud.xyz, radius, p_mask=cloud.mask, tile=tile,
        engine=engine, scan_cap=scan_cap,
    )
    lam, normal, ok = smallest_eigenpair3(cov)

    # plane fit needs >= 3 in-radius points (the query itself counts, as in
    # PCL where the query point is part of the search surface)
    enough = count >= 3.0
    valid = cloud.mask & ok & enough

    # flip towards viewpoint (pcl::flipNormalTowardsViewpoint)
    vp = jnp.asarray(viewpoint, jnp.float32)
    to_vp = vp[None, :] - cloud.xyz
    flip = jnp.sum(normal * to_vp, axis=-1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)

    lam_sum = lam[..., 0] + lam[..., 1] + lam[..., 2]
    curvature = jnp.where(
        lam_sum > 1e-12, lam[..., 0] / jnp.maximum(lam_sum, 1e-12), 0.0
    )
    curvature = jnp.where(valid, curvature, 0.0)
    normal = jnp.where(valid[:, None], normal, jnp.asarray([0.0, 0.0, 1.0]))
    return SurfaceNormals(normals=normal, curvature=curvature, valid=valid)
