"""3D shape context descriptor (ShapeContext1980).

JAX equivalent of pcl::ShapeContext3DEstimation (reference
dispatch_descriptors.h:47-48): a spherical log-polar grid around each
keypoint — 12 azimuth x 11 elevation x 15 log-spaced radial bins = 1980 —
accumulating neighbors weighted by 1 / (local_density * cbrt(bin_volume)),
with min_radius = 0.1 * radius and density radius = radius / 5 (PCL
defaults).

Deviation from PCL (documented): PCL orients the grid's azimuth axis
RANDOMLY around the surface normal, making its descriptors run-dependent
and azimuth-variant (a known 3DSC weakness). Here the grid sits in the
repeatable SHOT local reference frame instead — the Unique Shape Context
(USC) construction Tombari et al. introduced precisely to fix this — so
descriptors are deterministic AND rotation-invariant. Dimensionality and
binning match ShapeContext1980 exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.descriptors.shot import _local_reference_frames
from mapmerge_tpu.ops.neighbors import radius_count, radius_neighbors
from mapmerge_tpu.ops.normals import SurfaceNormals

_AZIMUTH = 12
_ELEVATION = 11
_RADIAL = 15
SC3D_DIM = _AZIMUTH * _ELEVATION * _RADIAL  # 1980


def compute_sc3d(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    p_ok = cloud.mask & normals.valid
    # 1980 bins need a denser sample than the default gather cap (PCL uses
    # every in-radius neighbor); take at least 128
    max_neighbors = max(max_neighbors * 2, 128)
    min_radius = 0.1 * radius  # PCL default
    density_radius = radius / 5.0  # PCL point_density_radius default

    # local point density for every surface point (PCL computePointDensity)
    density, _ = radius_count(
        cloud.xyz, cloud.xyz, density_radius, p_mask=cloud.mask, tile=tile
    )
    density = density.astype(jnp.float32)

    idx, d2, nmask, _ = radius_neighbors(
        keypoints.xyz, cloud.xyz, radius, max_neighbors,
        p_mask=p_ok, tile=tile, engine=engine, scan_cap=scan_cap,
    )
    nmask = nmask & keypoints.mask[:, None]
    nbr_xyz = cloud.xyz[idx]
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))

    # repeatable local reference frame (USC construction: SHOT LRF)
    x_ax, y_ax, z_ax, lrf_ok = _local_reference_frames(
        keypoints.xyz, nbr_xyz, nmask, radius
    )

    off = nbr_xyz - keypoints.xyz[:, None, :]
    lx = jnp.einsum("kmi,ki->km", off, x_ax)
    ly = jnp.einsum("kmi,ki->km", off, y_ax)
    lz = jnp.einsum("kmi,ki->km", off, z_ax)

    azimuth = jnp.arctan2(ly, lx)
    a_bin = jnp.clip(
        jnp.floor((azimuth + jnp.pi) / (2 * jnp.pi) * _AZIMUTH),
        0, _AZIMUTH - 1,
    ).astype(jnp.int32)

    r_xy = jnp.sqrt(jnp.maximum(lx * lx + ly * ly, 1e-12))
    elevation = jnp.arctan2(r_xy, lz)  # [0, pi] from +z
    e_bin = jnp.clip(
        jnp.floor(elevation / jnp.pi * _ELEVATION), 0, _ELEVATION - 1
    ).astype(jnp.int32)

    # log-spaced radial bins between min_radius and radius
    log_ratio = jnp.log(radius / min_radius)
    safe_d = jnp.maximum(dist, 1e-9)
    r_cont = jnp.log(safe_d / min_radius) / log_ratio * _RADIAL
    r_bin = jnp.clip(jnp.floor(r_cont), 0, _RADIAL - 1).astype(jnp.int32)
    # neighbors inside min_radius land in shell 0 (PCL does the same)

    # weight = 1 / (density_j * cbrt(bin volume))
    edges = min_radius * jnp.exp(
        jnp.arange(_RADIAL + 1) / _RADIAL * log_ratio
    )
    shell_vol = (4.0 / 3.0) * jnp.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    bin_vol = shell_vol / (_AZIMUTH * _ELEVATION)
    w_vol = 1.0 / jnp.cbrt(jnp.maximum(bin_vol[r_bin], 1e-12))
    w_den = 1.0 / jnp.maximum(density[idx], 1.0)
    w = w_vol * w_den * nmask.astype(jnp.float32)

    joint = (a_bin * _ELEVATION + e_bin) * _RADIAL + r_bin  # (K, M)
    k = joint.shape[0]
    # scatter-add: a (K, M, 1980) one-hot would dwarf the data
    hist = jnp.zeros((k, SC3D_DIM), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(k)[:, None], joint.shape)
    hist = hist.at[rows, joint].add(w)

    norm = jnp.sqrt(jnp.maximum(jnp.sum(hist * hist, axis=-1), 1e-12))
    data = hist / norm[:, None]

    valid = keypoints.mask & lrf_ok & (jnp.sum(nmask, axis=-1) >= 5)
    return Descriptors(data=jnp.where(valid[:, None], data, 0.0), valid=valid)
