"""SHOT color descriptor (SHOT1344).

JAX equivalent of pcl::SHOTColorEstimation (reference
dispatch_descriptors.h:44-46 — the color variant, SHOT1344, is chosen
deliberately over shape-only SHOT352):

  - Local reference frame per keypoint: (R - d)-weighted covariance of
    neighbor offsets, analytic EVD, sign disambiguation by majority vote
    (pcl SHOTLocalReferenceFrameEstimation).
  - Shape part: 32 spatial volumes (8 azimuth x 2 elevation x 2 radial
    shells) x 11 bins over cos(angle(n_j, z_lrf)) = 352 values.
  - Color part: 32 volumes x 31 bins over the mean L1 CIELab distance
    between neighbor and keypoint color = 992 values.
  - PCL-faithful QUADRILINEAR soft-binning (pcl::SHOTEstimation's
    additive interpolation scheme): each neighbor votes (1 - |residual|)
    into its own (volume, bin) cell along each of the four axes —
    histogram bin, azimuth sector, elevation half, radial shell — and
    |residual| into the adjacent cell along that axis (azimuth and the
    histogram bin wrap modulo their cell count as in PCL; elevation and
    radial votes outside the sphere are dropped). Total vote mass is 4
    per neighbor before the final L2 normalization, exactly like PCL.
  - L2-normalized (PCL normalizes the full descriptor).

Remaining documented difference: the reference color is the nearest
surface point's color (our keypoints are refined positions, not input
points, so they carry no color of their own), where PCL uses the query
point's stored RGB.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.eigh3 import eigvalsh3
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.neighbors import radius_neighbors
from mapmerge_tpu.ops.normals import SurfaceNormals
from mapmerge_tpu.ops.rigid import _eigvecs_from_vals

_AZIMUTH = 8
_ELEVATION = 2
_RADIAL = 2
_SHAPE_BINS = 11
_COLOR_BINS = 31
_VOLUMES = _AZIMUTH * _ELEVATION * _RADIAL  # 32
SHOT_DIM = _VOLUMES * _SHAPE_BINS + _VOLUMES * _COLOR_BINS  # 1344


def _local_reference_frames(
    kp_xyz: jax.Array,  # (K, 3)
    nbr_xyz: jax.Array,  # (K, M, 3)
    nbr_ok: jax.Array,  # (K, M)
    radius: float,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Returns (x_axis, y_axis, z_axis (K,3) each, ok (K,))."""
    off = nbr_xyz - kp_xyz[:, None, :]  # (K, M, 3)
    d = jnp.sqrt(jnp.maximum(jnp.sum(off * off, axis=-1), 1e-12))
    w = jnp.where(nbr_ok, jnp.maximum(radius - d, 0.0), 0.0)  # (K, M)
    wsum = jnp.sum(w, axis=-1)
    cov = jnp.einsum(
        "kmi,kmj->kij", off * w[..., None], off,
        precision=jax.lax.Precision.HIGHEST,
    ) / jnp.maximum(wsum, 1e-9)[:, None, None]

    lam = eigvalsh3(cov)
    v = _eigvecs_from_vals(cov, lam)  # columns ascending
    x_axis = v[..., 2]  # largest
    z_axis = v[..., 0]  # smallest

    # sign disambiguation: majority of weighted neighbors on positive side
    def fix_sign(axis):
        s = jnp.sum(jnp.sign(jnp.einsum("kmi,ki->km", off, axis)) * w, axis=-1)
        return axis * jnp.where(s >= 0, 1.0, -1.0)[:, None]

    x_axis = fix_sign(x_axis)
    z_axis = fix_sign(z_axis)
    # re-orthogonalize x against z then y = z cross x
    x_axis = x_axis - jnp.sum(x_axis * z_axis, axis=-1, keepdims=True) * z_axis
    xn = jnp.sqrt(jnp.maximum(jnp.sum(x_axis * x_axis, axis=-1), 1e-12))
    x_axis = x_axis / xn[:, None]
    y_axis = jnp.cross(z_axis, x_axis)
    ok = (wsum > 0) & (lam[..., 2] > 1e-12)
    return x_axis, y_axis, z_axis, ok


def _rgb_to_lab(rgb: jax.Array) -> jax.Array:
    """sRGB [0,1] -> CIELab (D65), vectorized."""
    c = jnp.where(
        rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92
    )
    m = jnp.asarray(
        [
            [0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227],
        ],
        jnp.float32,
    )
    xyz = jnp.einsum("...i,ji->...j", c, m)
    white = jnp.asarray([0.950456, 1.0, 1.088754], jnp.float32)
    t = xyz / white

    f = jnp.where(t > 0.008856, jnp.cbrt(t), 7.787 * t + 16.0 / 116.0)
    l = jnp.where(
        t[..., 1] > 0.008856,
        116.0 * jnp.cbrt(t[..., 1]) - 16.0,
        903.3 * t[..., 1],
    )
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return jnp.stack([l, a, b], axis=-1)


def compute_shot(
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
    # keypoint queries: overflow bounded by the feature-stage probe
    idx, d2, nmask, _ = radius_neighbors(
        keypoints.xyz, cloud.xyz, radius, max_neighbors,
        p_mask=p_ok, tile=tile, engine=engine, scan_cap=scan_cap,
    )
    nmask = nmask & keypoints.mask[:, None]
    nbr_xyz = cloud.xyz[idx]
    nbr_nrm = normals.normals[idx]
    nbr_rgb = cloud.rgb[idx]
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))

    x_ax, y_ax, z_ax, lrf_ok = _local_reference_frames(
        keypoints.xyz, nbr_xyz, nmask, radius
    )

    off = nbr_xyz - keypoints.xyz[:, None, :]
    lx = jnp.einsum("kmi,ki->km", off, x_ax)
    ly = jnp.einsum("kmi,ki->km", off, y_ax)
    lz = jnp.einsum("kmi,ki->km", off, z_ax)

    # ---- spatial cells + residuals (quadrilinear axes 2-4) ----
    # azimuth: 8 sectors over [-pi, pi), wrap-adjacent
    pa = (jnp.arctan2(ly, lx) + jnp.pi) / (2 * jnp.pi) * _AZIMUTH  # [0, 8]
    a_bin = jnp.clip(jnp.floor(pa), 0, _AZIMUTH - 1)
    ra = pa - (a_bin + 0.5)  # [-0.5, 0.5]
    a_adj = jnp.mod(a_bin + jnp.sign(ra), _AZIMUTH)
    # elevation: inclination theta in [0, pi]; cells upper (theta<90deg,
    # e=1) / lower (e=0), centers 45/135 deg, no wrap
    safe_d = jnp.maximum(dist, 1e-12)
    theta = jnp.arccos(jnp.clip(lz / safe_d, -1.0, 1.0))
    pe = theta / (jnp.pi / 2.0)  # [0, 2]
    e_cell = jnp.clip(jnp.floor(pe), 0, 1)  # 0 = upper half
    re = pe - (e_cell + 0.5)
    e_adj_cell = e_cell + jnp.sign(re)
    e_adj_ok = (e_adj_cell >= 0) & (e_adj_cell <= 1)
    e_bin = 1.0 - e_cell  # volume index: 1 = upper (lz >= 0)
    e_adj = 1.0 - jnp.clip(e_adj_cell, 0, 1)
    # radial: shells split at radius/2, centers r/4 and 3r/4, no wrap
    pr = dist / (radius / 2.0)  # [0, 2]
    r_bin = jnp.clip(jnp.floor(pr), 0, 1)  # 1 = outer shell
    rr = pr - (r_bin + 0.5)
    r_adj = r_bin + jnp.sign(rr)
    r_adj_ok = (r_adj >= 0) & (r_adj <= 1)
    r_adj = jnp.clip(r_adj, 0, 1)

    def vol_of(a, e, r):
        return (a * _ELEVATION * _RADIAL + e * _RADIAL + r).astype(jnp.int32)

    vol = vol_of(a_bin, e_bin, r_bin)  # (K, M) in [0, 32)

    # ---- histogram-bin axis (axis 1) per channel ----
    # shape: binDistance = (1+cos)/2 * (nbins-1) in [0, 10]; PCL wraps the
    # +-1 adjacent bin modulo (nbins-1) — reproduced as-is
    cos_t = jnp.clip(jnp.einsum("kmi,ki->km", nbr_nrm, z_ax), -1.0, 1.0)
    bd_s = (cos_t + 1.0) / 2.0 * (_SHAPE_BINS - 1)
    s_bin = jnp.clip(jnp.floor(bd_s + 0.5), 0, _SHAPE_BINS - 1)
    rs = bd_s - s_bin
    s_adj = jnp.mod(s_bin + jnp.sign(rs), _SHAPE_BINS - 1)

    # color: mean per-channel CIELab L1 distance to the keypoint color,
    # channels normalized L/100, a/120, b/120 (PCL's normalization)
    kp_rgb = nbr_rgb[:, 0, :]  # nearest surface point's color
    lab_n = _rgb_to_lab(nbr_rgb)
    lab_k = _rgb_to_lab(kp_rgb)[:, None, :]
    span = jnp.asarray([100.0, 120.0, 120.0], jnp.float32)
    dcol = jnp.sum(jnp.abs(lab_n - lab_k) / span, axis=-1) / 3.0
    bd_c = jnp.clip(dcol, 0.0, 1.0) * (_COLOR_BINS - 1)
    c_bin = jnp.clip(jnp.floor(bd_c + 0.5), 0, _COLOR_BINS - 1)
    rc = bd_c - c_bin
    c_adj = jnp.mod(c_bin + jnp.sign(rc), _COLOR_BINS - 1)

    w = (nmask & lrf_ok[:, None]).astype(jnp.float32)

    def soft_hist(bin_own, bin_adj, rb, nbins):
        """Additive quadrilinear accumulation, PCL scheme: the own
        (volume, bin) cell gets sum_axes (1 - |residual|); each axis's
        adjacent cell gets |residual| at the own coordinate of the other
        axes. Returns (K, 32 * nbins)."""
        central = (
            (1.0 - jnp.abs(rb))
            + (1.0 - jnp.abs(ra))
            + (1.0 - jnp.abs(re))
            + (1.0 - jnp.abs(rr))
        )
        contributions = [
            (vol, bin_own, w * central),
            (vol, bin_adj, w * jnp.abs(rb)),
            (vol_of(a_adj, e_bin, r_bin), bin_own, w * jnp.abs(ra)),
            (
                vol_of(a_bin, e_adj, r_bin),
                bin_own,
                w * jnp.abs(re) * e_adj_ok,
            ),
            (
                vol_of(a_bin, e_bin, r_adj),
                bin_own,
                w * jnp.abs(rr) * r_adj_ok,
            ),
        ]
        hist = jnp.zeros((vol.shape[0], _VOLUMES * nbins), jnp.float32)
        for v, b, ww in contributions:
            joint = v * nbins + b.astype(jnp.int32)
            oh = jax.nn.one_hot(joint, _VOLUMES * nbins, dtype=jnp.float32)
            hist = hist + jnp.einsum("km,kmb->kb", ww, oh)
        return hist

    hist_s = soft_hist(s_bin, s_adj, rs, _SHAPE_BINS)
    hist_c = soft_hist(c_bin, c_adj, rc, _COLOR_BINS)

    data = jnp.concatenate([hist_s, hist_c], axis=-1)  # (K, 1344)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(data * data, axis=-1), 1e-12))
    data = data / norm[:, None]

    valid = keypoints.mask & lrf_ok & (jnp.sum(nmask, axis=-1) >= 5)
    return Descriptors(data=jnp.where(valid[:, None], data, 0.0), valid=valid)
