"""Harris 3D keypoint detection.

JAX equivalent of pcl::HarrisKeypoint3D as configured by the
reference (map_merge_3d/src/features.cpp:64-83): HARRIS response from the
covariance of surface normals in the search radius, non-max suppression ON,
refinement ON, user threshold + radius.

Response: C = sum over neighbors of n n^T (valid normals only);
r = det(C) - 0.04 tr(C)^2, computed for every point from one matmul
pass (radius_reduce of the 9 outer-product channels). Non-max suppression
is a second radius pass comparing each response to its neighborhood max.
Refinement iterates the corner solve sum(n n^T) x = sum(n n^T p) a fixed
number of times (PCL iterates to convergence, <= 10; we use a static count
for XLA). Output is a fixed-capacity keypoint set: the top-`max_keypoints`
survivors by response.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import FAR, PointCloud
from mapmerge_tpu.ops.neighbors import radius_reduce, radius_count, tiled_query, sq_dists, BIG
from mapmerge_tpu.ops.normals import SurfaceNormals

_HARRIS_K = 0.04


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Keypoints:
    """Fixed-capacity keypoint set with detector responses."""

    xyz: jax.Array  # (K, 3) float32
    response: jax.Array  # (K,) float32
    mask: jax.Array  # (K,) bool
    #: above-threshold detections beyond `max_keypoints` that the top-k cut
    #: dropped (the reference keeps ALL above-threshold keypoints,
    #: features.cpp:85-97) — surfaced as a warning by
    #: estimate_maps_transforms like every other cap (no silent caps)
    truncated: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.mask)


def harris_response(
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> jax.Array:
    """HARRIS corner response per cloud point (invalid slots -> -inf-ish)."""
    n = jnp.where(normals.valid[:, None], normals.normals, 0.0)
    outer = (n[:, :, None] * n[:, None, :]).reshape(-1, 9)
    # self-query: overflow bounded by the feature-stage probe
    _, sums, _ = radius_reduce(
        cloud.xyz, cloud.xyz, radius, outer, p_mask=cloud.mask & normals.valid,
        tile=tile, engine=engine, scan_cap=scan_cap,
    )
    c = sums.reshape(-1, 3, 3)
    trace = c[:, 0, 0] + c[:, 1, 1] + c[:, 2, 2]
    det = (
        c[:, 0, 0] * (c[:, 1, 1] * c[:, 2, 2] - c[:, 1, 2] * c[:, 2, 1])
        - c[:, 0, 1] * (c[:, 1, 0] * c[:, 2, 2] - c[:, 1, 2] * c[:, 2, 0])
        + c[:, 0, 2] * (c[:, 1, 0] * c[:, 2, 1] - c[:, 1, 1] * c[:, 2, 0])
    )
    resp = det - _HARRIS_K * trace * trace
    return jnp.where(cloud.mask & normals.valid, resp, -BIG)


def _refine_step(
    kp_xyz: jax.Array,
    cloud: PointCloud,
    normals: SurfaceNormals,
    radius: float,
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
) -> jax.Array:
    """One corner-refinement solve: sum(n n^T) x = sum(n n^T p)."""
    nrm = jnp.where(normals.valid[:, None], normals.normals, 0.0)
    outer = nrm[:, :, None] * nrm[:, None, :]  # (P, 3, 3)
    nntp = jnp.einsum("pij,pj->pi", outer, cloud.xyz)  # (P, 3)
    values = jnp.concatenate([outer.reshape(-1, 9), nntp], axis=-1)  # (P, 12)
    # keypoints are a subset of the cloud: overflow bounded by the probe
    _, sums, _ = radius_reduce(
        kp_xyz, cloud.xyz, radius, values,
        p_mask=cloud.mask & normals.valid, tile=tile,
        engine=engine, scan_cap=scan_cap,
    )
    a = sums[:, :9].reshape(-1, 3, 3)
    b = sums[:, 9:]
    # adjugate solve with conditioning guard: ill-conditioned -> keep point
    det = (
        a[:, 0, 0] * (a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1])
        - a[:, 0, 1] * (a[:, 1, 0] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 0])
        + a[:, 0, 2] * (a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0])
    )
    adj = jnp.stack(
        [
            a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1],
            a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2],
            a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1],
            a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2],
            a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0],
            a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2],
            a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0],
            a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1],
            a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0],
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    trace = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    well = jnp.abs(det) > 1e-9 * jnp.maximum(trace, 1e-9) ** 3
    x = jnp.einsum("pij,pj->pi", adj, b) / jnp.where(
        well, det, 1.0
    )[:, None]
    # reject refinements that jump out of the neighborhood
    moved2 = jnp.sum((x - kp_xyz) ** 2, axis=-1)
    keep_new = well & (moved2 <= radius * radius)
    return jnp.where(keep_new[:, None], x, kp_xyz)


def detect_keypoints_harris(
    cloud: PointCloud,
    normals: SurfaceNormals,
    threshold: float,
    radius: float,
    max_keypoints: int,
    refine: bool = True,
    refine_iters: int = 3,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Keypoints:
    """Detect Harris3D keypoints (reference features.cpp:64-83 contract:
    non-max suppression on, refine on)."""
    resp = harris_response(
        cloud, normals, radius, tile=tile, engine=engine, scan_cap=scan_cap
    )

    # non-max suppression: own response must equal the neighborhood max
    # (self-query: overflow bounded by the feature-stage probe)
    _, nmax, _ = radius_reduce(
        cloud.xyz, cloud.xyz, radius, resp[:, None],
        p_mask=cloud.mask & normals.valid, tile=tile, reduce="max",
        engine=engine, scan_cap=scan_cap,
    )
    is_max = resp >= nmax[:, 0]
    keep = cloud.mask & normals.valid & is_max & (resp > threshold)

    # fixed-capacity selection: top-K survivors by response
    score = jnp.where(keep, resp, -BIG)
    k = min(max_keypoints, score.shape[0])
    top_scores, top_idx = jax.lax.top_k(score, k)
    kp_mask = top_scores > -BIG / 2
    kp_xyz = cloud.xyz[top_idx]

    if refine:
        for _ in range(refine_iters):
            kp_xyz = _refine_step(
                kp_xyz, cloud, normals, radius, tile, engine, scan_cap
            )

    kp_xyz = jnp.where(kp_mask[:, None], kp_xyz, FAR)
    return Keypoints(
        xyz=kp_xyz,
        response=jnp.where(kp_mask, top_scores, 0.0),
        mask=kp_mask,
        truncated=jnp.maximum(
            jnp.sum(keep).astype(jnp.int32) - jnp.int32(k), 0
        ),
    )
