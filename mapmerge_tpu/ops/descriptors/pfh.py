"""PFH-125 and PFHRGB-250 descriptors.

JAX equivalents of pcl::PFHEstimation (the reference's DEFAULT
descriptor, map_merging.h:35, PFHSignature125) and pcl::PFHRGBEstimation
(PFHRGBSignature250), per dispatch_descriptors.h:38-39.

PFH: for each keypoint, ALL pairs of points in its radius neighborhood
contribute a joint (theta, alpha, phi) histogram with 5 bins per feature ->
5^3 = 125 bins, normalized to sum 100. Neighborhoods are the capped gather
(nearest max_neighbors within radius); the (M, M) pair block is evaluated
densely — each unordered pair appears twice, which cancels under
normalization because the Darboux features are symmetric under the role-swap
rule (ops/descriptors/darboux.py).

PFHRGB appends a second 125-bin joint histogram of the per-channel color
ratios c1/c2, binned over [0, 2) (PCL computeRGBPairFeatures semantics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.descriptors.darboux import pair_features
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.neighbors import radius_neighbors
from mapmerge_tpu.ops.normals import SurfaceNormals

_SPLIT = 5  # PCL nr_split_
_PI = float(jnp.pi)


def _joint_histogram(
    theta: jax.Array,  # (K, M, M)
    alpha: jax.Array,
    phi: jax.Array,
    w: jax.Array,  # (K, M, M) pair weights
) -> jax.Array:
    """Joint 5x5x5 histogram, PCL index order h = f1 + 5*f2 + 25*f3."""
    b_theta = jnp.clip(
        jnp.floor((theta + _PI) / (2.0 * _PI) * _SPLIT), 0, _SPLIT - 1
    )
    b_alpha = jnp.clip(jnp.floor((alpha + 1.0) / 2.0 * _SPLIT), 0, _SPLIT - 1)
    b_phi = jnp.clip(jnp.floor((phi + 1.0) / 2.0 * _SPLIT), 0, _SPLIT - 1)
    joint = (b_theta + _SPLIT * b_alpha + _SPLIT * _SPLIT * b_phi).astype(
        jnp.int32
    )
    k = theta.shape[0]
    oh = jax.nn.one_hot(joint.reshape(k, -1), _SPLIT**3, dtype=jnp.float32)
    hist = jnp.einsum(
        "km,kmb->kb", w.reshape(k, -1), oh,
        precision=jax.lax.Precision.HIGHEST,
    )
    total = jnp.sum(hist, axis=-1, keepdims=True)
    return jnp.where(total > 0, hist * (100.0 / jnp.maximum(total, 1e-9)), 0.0)


def _neighborhood(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int,
    tile: int,
    engine: str = "auto",
    scan_cap: int = 128,
):
    p_ok = cloud.mask & normals.valid
    # keypoint queries: overflow bounded by the feature-stage probe
    idx, _, nmask, _ = radius_neighbors(
        keypoints.xyz, cloud.xyz, radius, max_neighbors,
        p_mask=p_ok, tile=tile, engine=engine, scan_cap=scan_cap,
    )
    nmask = nmask & keypoints.mask[:, None]
    return idx, nmask


def _pair_block(cloud, normals, idx, nmask):
    """All-pairs Darboux features within each gathered neighborhood."""
    pts = cloud.xyz[idx]  # (K, M, 3)
    nrm = normals.normals[idx]
    theta, alpha, phi, _, ok = pair_features(
        pts[:, :, None, :], nrm[:, :, None, :], pts[:, None, :, :], nrm[:, None, :, :]
    )
    w = (nmask[:, :, None] & nmask[:, None, :] & ok).astype(jnp.float32)
    return theta, alpha, phi, w, pts


def compute_pfh(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    idx, nmask = _neighborhood(
        cloud, normals, keypoints, radius, max_neighbors, tile,
        engine=engine, scan_cap=scan_cap,
    )
    theta, alpha, phi, w, _ = _pair_block(cloud, normals, idx, nmask)
    hist = _joint_histogram(theta, alpha, phi, w)
    valid = keypoints.mask & (jnp.sum(nmask, axis=-1) >= 2)
    return Descriptors(data=jnp.where(valid[:, None], hist, 0.0), valid=valid)


def compute_pfhrgb(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    idx, nmask = _neighborhood(
        cloud, normals, keypoints, radius, max_neighbors, tile,
        engine=engine, scan_cap=scan_cap,
    )
    theta, alpha, phi, w, _ = _pair_block(cloud, normals, idx, nmask)
    geo = _joint_histogram(theta, alpha, phi, w)

    # color ratio joint histogram (PCL computeRGBPairFeatures): per channel
    # ratio c1 / c2 binned over [0, 2)
    cols = cloud.rgb[idx]  # (K, M, 3)
    c1 = cols[:, :, None, :]
    c2 = cols[:, None, :, :]
    ratio = c1 / jnp.maximum(c2, 1e-4)
    b = jnp.clip(jnp.floor(ratio / 2.0 * _SPLIT), 0, _SPLIT - 1).astype(jnp.int32)
    joint = b[..., 0] + _SPLIT * b[..., 1] + _SPLIT * _SPLIT * b[..., 2]
    k = joint.shape[0]
    oh = jax.nn.one_hot(joint.reshape(k, -1), _SPLIT**3, dtype=jnp.float32)
    hist_c = jnp.einsum(
        "km,kmb->kb", w.reshape(k, -1), oh,
        precision=jax.lax.Precision.HIGHEST,
    )
    total = jnp.sum(hist_c, axis=-1, keepdims=True)
    hist_c = jnp.where(
        total > 0, hist_c * (100.0 / jnp.maximum(total, 1e-9)), 0.0
    )

    data = jnp.concatenate([geo, hist_c], axis=-1)
    valid = keypoints.mask & (jnp.sum(nmask, axis=-1) >= 2)
    return Descriptors(data=jnp.where(valid[:, None], data, 0.0), valid=valid)
