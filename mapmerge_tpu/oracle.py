"""CPU oracle: a faithful kd-tree implementation of the reference pipeline.

This module reimplements estimateMapsTransforms exactly as the reference
runs it (/root/reference/map_merge_3d/src/map_merging.cpp:188-275) on the
CPU with scipy cKDTree standing in for pcl::search::KdTree — the same stage
order, the same algorithms (VoxelGrid, RadiusOutlierRemoval,
NormalEstimation, SIFT3D/Harris3D, PFH/FPFH, reciprocal k-NN matching,
RANSAC + SVD, fixed-bound ICP, TransformationValidationEuclidean), with no
neighbor caps and no fixed-shape compromises.

It exists for two reasons (VERDICT r1 item 1):
  1. an honest wall-clock baseline: the reference publishes no numbers
     (BASELINE.md), so the measured wall-clock of this kd-tree pipeline is
     the PCL stand-in that bench.py's `vs_baseline` is anchored to;
  2. golden poses: its estimated SE(3) transforms are frozen as golden data
     (golden/*.json) that the JAX pipeline must match within tolerance.

Everything here is plain numpy/scipy — no JAX — so it measures what a
classic CPU implementation costs, not what our own ops cost on host.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.spatial import cKDTree

from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.core.enums import Descriptor, EstimationMethod, Keypoint
from mapmerge_tpu.graph.merge_graph import (
    TransformEstimate,
    compute_global_transforms,
)

_HARRIS_K = 0.04


# ---------------------------------------------------------------- helpers
def _kabsch_np(src: np.ndarray, dst: np.ndarray, w: np.ndarray | None = None):
    """Weighted least-squares rigid transform (Umeyama, no scale) —
    pcl::registration::TransformationEstimationSVD semantics."""
    if w is None:
        w = np.ones(len(src), np.float64)
    wsum = w.sum()
    if wsum < 3 or len(src) < 3:
        return np.eye(4, dtype=np.float32), False
    mu_s = (src * w[:, None]).sum(0) / wsum
    mu_d = (dst * w[:, None]).sum(0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    h = (sc * w[:, None]).T @ dc
    u, s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    if s[1] < 1e-12 * max(s[0], 1e-12):  # collinear support
        return np.eye(4, dtype=np.float32), False
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = r
    t[:3, 3] = mu_d - r @ mu_s
    return t.astype(np.float32), True


def _apply(t: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    return xyz @ t[:3, :3].T + t[:3, 3]


# ------------------------------------------------------------- L2 stages
def voxel_downsample_np(xyz, rgb, resolution):
    """pcl::VoxelGrid (features.cpp:17-27): centroid per cube, incl. RGB."""
    keys = np.floor(xyz / resolution).astype(np.int64)
    # dense-packed voxel key
    kmin = keys.min(0)
    keys -= kmin
    dims = keys.max(0) + 1
    flat = (keys[:, 2] * dims[1] + keys[:, 1]) * dims[0] + keys[:, 0]
    uniq, inv = np.unique(flat, return_inverse=True)
    n = len(uniq)
    cnt = np.bincount(inv, minlength=n).astype(np.float64)
    out_xyz = np.stack(
        [np.bincount(inv, weights=xyz[:, c], minlength=n) for c in range(3)], 1
    ) / cnt[:, None]
    out_rgb = np.stack(
        [np.bincount(inv, weights=rgb[:, c], minlength=n) for c in range(3)], 1
    ) / cnt[:, None]
    return out_xyz.astype(np.float32), out_rgb.astype(np.float32)


def remove_outliers_np(xyz, rgb, radius, min_neighbors):
    """pcl::RadiusOutlierRemoval (features.cpp:31-43); the query point
    counts (it is part of the search surface)."""
    tree = cKDTree(xyz)
    counts = tree.query_ball_point(xyz, radius, return_length=True)
    keep = counts >= min_neighbors
    return xyz[keep], rgb[keep]


def _pair_lists(tree: cKDTree, radius: float, n: int):
    """Symmetric neighbor pair arrays (i, j) within radius, both directions,
    self excluded — the accumulation backbone for radius statistics."""
    pairs = tree.query_pairs(radius, output_type="ndarray")  # (P, 2) i<j
    i = np.concatenate([pairs[:, 0], pairs[:, 1]])
    j = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return i, j


def normals_np(xyz, radius):
    """pcl::NormalEstimation (features.cpp:168-179): per-point PCA over the
    full radius neighborhood, flip to viewpoint (origin), curvature
    l0/(l0+l1+l2)."""
    n = len(xyz)
    tree = cKDTree(xyz)
    i, j = _pair_lists(tree, radius, n)
    cnt = np.bincount(i, minlength=n).astype(np.float64) + 1.0  # + self
    s1 = np.stack(
        [np.bincount(i, weights=xyz[j, c], minlength=n) for c in range(3)], 1
    ) + xyz
    mean = s1 / cnt[:, None]
    # second moments (6 unique entries)
    s2 = np.zeros((n, 6))
    combos = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for k, (a, b) in enumerate(combos):
        s2[:, k] = np.bincount(
            i, weights=xyz[j, a] * xyz[j, b], minlength=n
        ) + xyz[:, a] * xyz[:, b]
    e = s2 / cnt[:, None]
    cov = np.empty((n, 3, 3))
    for k, (a, b) in enumerate(combos):
        cov[:, a, b] = e[:, k] - mean[:, a] * mean[:, b]
        cov[:, b, a] = cov[:, a, b]
    lam, vec = np.linalg.eigh(cov)  # ascending
    normal = vec[:, :, 0]
    # flip towards viewpoint (origin)
    flip = np.einsum("nc,nc->n", normal, -xyz) < 0
    normal[flip] = -normal[flip]
    lam = np.maximum(lam, 0.0)
    lsum = lam.sum(1)
    curvature = np.where(lsum > 1e-12, lam[:, 0] / np.maximum(lsum, 1e-12), 0.0)
    valid = (cnt >= 3) & (lam[:, 1] > 1e-12)
    return (
        normal.astype(np.float32),
        curvature.astype(np.float32),
        valid,
        tree,
    )


def harris_np(xyz, normals, nvalid, threshold, radius, tree, refine_iters=3):
    """pcl::HarrisKeypoint3D (features.cpp:64-83): response from the normal
    covariance, NMS on, refine on."""
    n = len(xyz)
    i, j = _pair_lists(tree, radius, n)
    nrm = np.where(nvalid[:, None], normals, 0.0)
    c = np.zeros((n, 6))
    combos = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for k, (a, b) in enumerate(combos):
        c[:, k] = np.bincount(
            i, weights=nrm[j, a] * nrm[j, b], minlength=n
        ) + nrm[:, a] * nrm[:, b]
    trace = c[:, 0] + c[:, 3] + c[:, 5]
    det = (
        c[:, 0] * (c[:, 3] * c[:, 5] - c[:, 4] ** 2)
        - c[:, 1] * (c[:, 1] * c[:, 5] - c[:, 4] * c[:, 2])
        + c[:, 2] * (c[:, 1] * c[:, 4] - c[:, 3] * c[:, 2])
    )
    resp = det - _HARRIS_K * trace**2
    resp = np.where(nvalid, resp, -np.inf)
    # non-max suppression over the radius neighborhood
    nmax = resp.copy()
    np.maximum.at(nmax, i, resp[j])
    keep = nvalid & (resp >= nmax) & (resp > threshold)
    kp = xyz[keep].astype(np.float64)
    if refine_iters and len(kp):
        outer = nrm[:, :, None] * nrm[:, None, :]
        nntp = np.einsum("pij,pj->pi", outer, xyz.astype(np.float64))
        for _ in range(refine_iters):
            nbrs = tree.query_ball_point(kp, radius)
            new = kp.copy()
            for q, nb in enumerate(nbrs):
                if len(nb) < 3:
                    continue
                a = outer[nb].sum(0)
                b = nntp[nb].sum(0)
                det_a = np.linalg.det(a)
                tr = np.trace(a)
                if abs(det_a) <= 1e-9 * max(tr, 1e-9) ** 3:
                    continue
                x = np.linalg.solve(a, b)
                if ((x - kp[q]) ** 2).sum() <= radius * radius:
                    new[q] = x
            kp = new
    return kp.astype(np.float32), resp[keep].astype(np.float32)


def sift_np(xyz, rgb, min_scale, octaves, scales_per_octave, min_contrast):
    """pcl::SIFTKeypoint on color intensity (features.cpp:45-62):
    scale-space DoG per octave, extrema over 25 spatial NN across adjacent
    levels, |DoG| > min_contrast; between octaves the cloud is
    voxel-downsampled with leaf = 2 * octave scale (PCL detectKeypoints)."""
    intensity = (
        299.0 * rgb[:, 0] + 587.0 * rgb[:, 1] + 114.0 * rgb[:, 2]
    ) * (255.0 / 1000.0)
    oct_xyz, oct_int = xyz, intensity

    out_xyz, out_resp = [], []
    base = float(min_scale)
    for octave in range(octaves):
        n = len(oct_xyz)
        if n < 2:
            break
        tree = cKDTree(oct_xyz)
        knn = min(26, n)
        _, nbr = tree.query(oct_xyz, k=knn)  # includes self at slot 0
        nbr = nbr.reshape(n, -1)[:, 1:]
        n_s = scales_per_octave + 3
        sigmas = [base * (2.0 ** (s / scales_per_octave)) for s in range(n_s)]
        r_bound = 3.0 * max(sigmas)
        smoothed = np.empty((n_s, n))
        # chunked Gaussian smoothing over the 3*sigma_max neighborhood
        chunk = max(1, int(2.0e7 // max(1, int((r_bound**2) * 400))))
        chunk = min(max(chunk, 64), n)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            lists = tree.query_ball_point(oct_xyz[lo:hi], r_bound)
            lens = np.fromiter((len(l) for l in lists), np.int64, hi - lo)
            flat = np.concatenate([np.asarray(l, np.int64) for l in lists])
            qidx = np.repeat(np.arange(hi - lo), lens)
            d2 = ((oct_xyz[lo:hi][qidx] - oct_xyz[flat]) ** 2).sum(1)
            vals = oct_int[flat]
            for s, sig in enumerate(sigmas):
                w = np.exp(-d2 / (2.0 * sig * sig))
                num = np.bincount(qidx, weights=w * vals, minlength=hi - lo)
                den = np.bincount(qidx, weights=w, minlength=hi - lo)
                smoothed[s, lo:hi] = num / np.maximum(den, 1e-12)
        dog = smoothed[1:] - smoothed[:-1]
        for s in range(1, dog.shape[0] - 1):
            val = dog[s]
            levels = dog[s - 1 : s + 2]
            nbr_vals = levels[:, nbr]  # (3, N, K)
            hi_v = np.maximum(nbr_vals.max(0).max(-1), np.maximum(dog[s - 1], dog[s + 1]))
            lo_v = np.minimum(nbr_vals.min(0).min(-1), np.minimum(dog[s - 1], dog[s + 1]))
            is_ext = (val > hi_v) | (val < lo_v)
            keep = is_ext & (np.abs(val) > min_contrast)
            out_xyz.append(oct_xyz[keep])
            out_resp.append(np.abs(val[keep]))
        # downsample for the next octave (leaf = 2 * octave scale),
        # carrying centroid intensity
        if octave < octaves - 1:
            fake_rgb = np.stack([oct_int, oct_int, oct_int], 1)
            oct_xyz, fake_rgb = voxel_downsample_np(
                oct_xyz, fake_rgb, 2.0 * base
            )
            oct_int = fake_rgb[:, 0]
        base *= 2.0
    if not out_xyz:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    return (
        np.concatenate(out_xyz).astype(np.float32),
        np.concatenate(out_resp).astype(np.float32),
    )


def _pair_features_np(p1, n1, p2, n2):
    """pcl::computePairFeatures with the role-swap rule
    (ops/descriptors/darboux.py mirrors the same semantics)."""
    d = p2 - p1
    dist2 = (d * d).sum(-1)
    dist = np.sqrt(np.maximum(dist2, 1e-12))
    ok = dist2 > 1e-12
    dhat = d / dist[..., None]
    cos1 = (n1 * dhat).sum(-1)
    cos2 = (n2 * -dhat).sum(-1)
    swap = np.abs(cos1) < np.abs(cos2)
    ns = np.where(swap[..., None], n2, n1)
    nt = np.where(swap[..., None], n1, n2)
    dst = np.where(swap[..., None], -dhat, dhat)
    phi = np.where(swap, cos2, cos1)
    v = np.cross(dst, ns)
    vn2 = (v * v).sum(-1)
    frame_ok = vn2 > 1e-12
    v = v / np.sqrt(np.maximum(vn2, 1e-12))[..., None]
    w = np.cross(ns, v)
    alpha = (v * nt).sum(-1)
    theta = np.arctan2((w * nt).sum(-1), (ns * nt).sum(-1))
    return theta, alpha, phi, dist, ok & frame_ok


def fpfh_np(xyz, normals, nvalid, kp_xyz, radius, tree):
    """pcl::FPFHEstimation (33-d): SPFH per surface point, 1/d-weighted sum
    over each keypoint's neighborhood, per-block renorm to 100."""
    n = len(xyz)
    bins = 11
    i, j = _pair_lists(tree, radius, n)
    keep = nvalid[i] & nvalid[j]
    i, j = i[keep], j[keep]
    theta, alpha, phi, _, ok = _pair_features_np(
        xyz[i], normals[i], xyz[j], normals[j]
    )
    w = ok.astype(np.float64)

    def hist(vals, lo, hi_):
        b = np.clip(
            np.floor((vals - lo) / (hi_ - lo) * bins).astype(np.int64), 0, bins - 1
        )
        out = np.zeros((n, bins))
        np.add.at(out, (i, b), w)
        return out

    h = np.concatenate(
        [hist(theta, -np.pi, np.pi), hist(alpha, -1, 1), hist(phi, -1, 1)], 1
    )
    tot = np.bincount(i, weights=w, minlength=n)
    spfh_ok = nvalid & (tot > 0)
    h = np.where(
        spfh_ok[:, None], h * (100.0 / np.maximum(tot, 1e-9))[:, None], 0.0
    )

    # keypoint aggregation
    k = len(kp_xyz)
    desc = np.zeros((k, 33))
    valid = np.zeros(k, bool)
    lists = tree.query_ball_point(kp_xyz, radius)
    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        if len(nb) == 0:
            continue
        d = np.linalg.norm(xyz[nb] - kp_xyz[q], axis=1)
        m = spfh_ok[nb] & (d > 1e-9)
        if not m.any():
            continue
        wq = 1.0 / d[m]
        f = (h[nb[m]] * wq[:, None]).sum(0)
        blocks = f.reshape(3, bins)
        sums = blocks.sum(1, keepdims=True)
        blocks = np.where(sums > 0, blocks * (100.0 / np.maximum(sums, 1e-9)), 0)
        desc[q] = blocks.reshape(-1)
        valid[q] = True
    return desc.astype(np.float32), valid


def pfh_np(xyz, normals, nvalid, kp_xyz, radius, tree):
    """pcl::PFHEstimation (125-d): joint 5^3 histogram over ALL neighbor
    pairs in each keypoint's radius neighborhood."""
    split = 5
    k = len(kp_xyz)
    desc = np.zeros((k, 125))
    valid = np.zeros(k, bool)
    lists = tree.query_ball_point(kp_xyz, radius)
    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        nb = nb[nvalid[nb]]
        m = len(nb)
        if m < 2:
            continue
        p = xyz[nb]
        nn = normals[nb]
        theta, alpha, phi, _, ok = _pair_features_np(
            p[:, None, :], nn[:, None, :], p[None, :, :], nn[None, :, :]
        )
        w = ok.astype(np.float64).reshape(-1)
        bt = np.clip(
            np.floor((theta + np.pi) / (2 * np.pi) * split), 0, split - 1
        ).astype(np.int64)
        ba = np.clip(np.floor((alpha + 1) / 2 * split), 0, split - 1).astype(
            np.int64
        )
        bp = np.clip(np.floor((phi + 1) / 2 * split), 0, split - 1).astype(
            np.int64
        )
        joint = (bt + split * ba + split * split * bp).reshape(-1)
        hist = np.bincount(joint, weights=w, minlength=125)[:125]
        tot = hist.sum()
        if tot > 0:
            desc[q] = hist * (100.0 / tot)
            valid[q] = True
    return desc.astype(np.float32), valid


def pfhrgb_np(xyz, rgb, normals, nvalid, kp_xyz, radius, tree):
    """pcl::PFHRGBEstimation (250-d, dispatch_descriptors.h:39): the PFH
    joint geometry histogram plus a second 5^3 joint histogram of the
    per-channel color ratios c1/c2 binned over [0, 2)
    (computeRGBPairFeatures semantics)."""
    split = 5
    k = len(kp_xyz)
    desc = np.zeros((k, 250))
    valid = np.zeros(k, bool)
    lists = tree.query_ball_point(kp_xyz, radius)
    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        nb = nb[nvalid[nb]]
        m = len(nb)
        if m < 2:
            continue
        p = xyz[nb]
        nn = normals[nb]
        theta, alpha, phi, _, ok = _pair_features_np(
            p[:, None, :], nn[:, None, :], p[None, :, :], nn[None, :, :]
        )
        w = ok.astype(np.float64).reshape(-1)

        def joint_hist(b0, b1, b2):
            joint = (b0 + split * b1 + split * split * b2).reshape(-1)
            hist = np.bincount(joint, weights=w, minlength=125)[:125]
            tot = hist.sum()
            return hist * (100.0 / tot) if tot > 0 else hist

        bt = np.clip(
            np.floor((theta + np.pi) / (2 * np.pi) * split), 0, split - 1
        ).astype(np.int64)
        ba = np.clip(np.floor((alpha + 1) / 2 * split), 0, split - 1).astype(
            np.int64
        )
        bp = np.clip(np.floor((phi + 1) / 2 * split), 0, split - 1).astype(
            np.int64
        )
        geo = joint_hist(bt, ba, bp)

        c = rgb[nb]
        ratio = c[:, None, :] / np.maximum(c[None, :, :], 1e-4)
        bc = np.clip(np.floor(ratio / 2.0 * split), 0, split - 1).astype(
            np.int64
        )
        col = joint_hist(bc[..., 0], bc[..., 1], bc[..., 2])

        desc[q] = np.concatenate([geo, col])
        valid[q] = geo.sum() > 0
    return desc.astype(np.float32), valid


def rsd_np(xyz, normals, nvalid, kp_xyz, radius, tree,
           angle_bins=5, plane_radius=0.2):
    """pcl::RSDEstimation (dispatch_descriptors.h:43): principal curvature
    radii (r_min, r_max) from d(alpha) ~= 2 r sin(alpha/2), neighbors binned
    by normal angle, min distance per bin, clamped at plane_radius."""
    k = len(kp_xyz)
    desc = np.zeros((k, 2))
    valid = np.zeros(k, bool)
    lists = tree.query_ball_point(kp_xyz, radius)
    half_pi = np.pi / 2.0
    centers = (np.arange(angle_bins) + 0.5) / angle_bins * half_pi
    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        nb = nb[nvalid[nb]]
        if len(nb) < 3:
            continue
        d = np.linalg.norm(xyz[nb] - kp_xyz[q], axis=1)
        order = np.argsort(d)
        nb, d = nb[order], d[order]
        kp_nrm = normals[nb[0]]  # nearest surface point's normal
        cos_a = np.clip(np.abs(normals[nb] @ kp_nrm), 0.0, 1.0)
        alpha = np.arccos(cos_a)
        abin = np.clip(
            np.floor(alpha / half_pi * angle_bins), 0, angle_bins - 1
        ).astype(np.int64)
        r_est = []
        for b in range(angle_bins):
            sel = abin == b
            if not sel.any():
                continue
            dmin = d[sel].min()
            r_est.append(
                min(dmin / max(2.0 * np.sin(centers[b] / 2.0), 1e-6),
                    plane_radius)
            )
        if not r_est:
            desc[q] = (plane_radius, plane_radius)
        else:
            desc[q] = (min(r_est), max(r_est))
        valid[q] = True
    return desc.astype(np.float32), valid


def _shot_lrf_np(kp, nbr, radius):
    """SHOT local reference frame: (radius - d)-weighted covariance EVD
    with majority-vote sign disambiguation
    (pcl SHOTLocalReferenceFrameEstimation). Returns (x, y, z, ok)."""
    off = nbr - kp
    d = np.linalg.norm(off, axis=1)
    w = np.maximum(radius - d, 0.0)
    wsum = w.sum()
    if wsum <= 0:
        return None
    cov = (off * w[:, None]).T @ off / wsum
    lam, v = np.linalg.eigh(cov)  # ascending
    if lam[2] <= 1e-12:
        return None
    x = v[:, 2]
    z = v[:, 0]
    if np.sum(np.sign(off @ x) * w) < 0:
        x = -x
    if np.sum(np.sign(off @ z) * w) < 0:
        z = -z
    x = x - (x @ z) * z
    xn = np.linalg.norm(x)
    if xn < 1e-6:
        return None
    x = x / xn
    y = np.cross(z, x)
    return x, y, z


def _rgb_to_lab_np(rgb):
    """sRGB [0,1] -> CIELab (D65)."""
    c = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = np.array(
        [
            [0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227],
        ]
    )
    xyz = c @ m.T
    t = xyz / np.array([0.950456, 1.0, 1.088754])
    f = np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)
    l = np.where(
        t[..., 1] > 0.008856, 116.0 * np.cbrt(t[..., 1]) - 16.0,
        903.3 * t[..., 1],
    )
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([l, a, b], axis=-1)


def shot_np(xyz, rgb, normals, nvalid, kp_xyz, radius, tree):
    """pcl::SHOTColorEstimation -> SHOT1344 (dispatch_descriptors.h:44-46):
    32 spatial volumes (8 azimuth x 2 elevation x 2 radial) x 11 shape bins
    over cos(n_j, z_lrf) + 32 x 31 color bins over normalized CIELab L1
    distance, with PCL's additive QUADRILINEAR soft-binning (each neighbor
    votes 1-|residual| into its own cell along each of the four axes and
    |residual| into the adjacent cell; azimuth and histogram bins wrap,
    elevation/radial votes outside the sphere are dropped), L2-normalized.
    Twin of ops/descriptors/shot.py."""
    nk = len(kp_xyz)
    desc = np.zeros((nk, 1344))
    valid = np.zeros(nk, bool)
    lists = tree.query_ball_point(kp_xyz, radius)
    lab_all = _rgb_to_lab_np(rgb)
    span = np.array([100.0, 120.0, 120.0])

    def soft_hist(vol, a_bin, e_bin, r_bin, ra, re, rr, e_ok, r_ok,
                  b_own, b_adj, rb, nbins):
        def vol_of(a, e, r):
            return (a * 4 + e * 2 + r).astype(np.int64)

        central = (
            (1 - np.abs(rb)) + (1 - np.abs(ra))
            + (1 - np.abs(re)) + (1 - np.abs(rr))
        )
        a_adj = np.mod(a_bin + np.sign(ra), 8)
        e_adj = 1 - np.clip((1 - e_bin) + np.sign(re), 0, 1)
        r_adj = np.clip(r_bin + np.sign(rr), 0, 1)
        h = np.zeros(32 * nbins)
        for v, b, w in (
            (vol, b_own, central),
            (vol, b_adj, np.abs(rb)),
            (vol_of(a_adj, e_bin, r_bin), b_own, np.abs(ra)),
            (vol_of(a_bin, e_adj, r_bin), b_own, np.abs(re) * e_ok),
            (vol_of(a_bin, e_bin, r_adj), b_own, np.abs(rr) * r_ok),
        ):
            np.add.at(h, (v * nbins + b).astype(np.int64), w)
        return h

    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        nb = nb[nvalid[nb]]
        if len(nb) < 5:
            continue
        d = np.linalg.norm(xyz[nb] - kp_xyz[q], axis=1)
        order = np.argsort(d)
        nb, d = nb[order], d[order]
        lrf = _shot_lrf_np(kp_xyz[q], xyz[nb], radius)
        if lrf is None:
            continue
        x, y, z = lrf
        off = xyz[nb] - kp_xyz[q]
        pa = (np.arctan2(off @ y, off @ x) + np.pi) / (2 * np.pi) * 8
        a_bin = np.clip(np.floor(pa), 0, 7).astype(np.int64)
        ra = pa - (a_bin + 0.5)
        safe_d = np.maximum(d, 1e-12)
        theta = np.arccos(np.clip((off @ z) / safe_d, -1.0, 1.0))
        pe = theta / (np.pi / 2.0)
        e_cell = np.clip(np.floor(pe), 0, 1).astype(np.int64)
        re = pe - (e_cell + 0.5)
        e_ok = (e_cell + np.sign(re) >= 0) & (e_cell + np.sign(re) <= 1)
        e_bin = 1 - e_cell  # volume index: 1 = upper (z >= 0)
        pr = d / (radius / 2.0)
        r_bin = np.clip(np.floor(pr), 0, 1).astype(np.int64)
        rr = pr - (r_bin + 0.5)
        r_ok = (r_bin + np.sign(rr) >= 0) & (r_bin + np.sign(rr) <= 1)
        vol = a_bin * 4 + e_bin * 2 + r_bin

        cos_t = np.clip(normals[nb] @ z, -1.0, 1.0)
        bd_s = (cos_t + 1.0) / 2.0 * 10
        s_bin = np.clip(np.floor(bd_s + 0.5), 0, 10).astype(np.int64)
        rs = bd_s - s_bin
        s_adj = np.mod(s_bin + np.sign(rs), 10).astype(np.int64)
        hist_s = soft_hist(
            vol, a_bin, e_bin, r_bin, ra, re, rr, e_ok, r_ok,
            s_bin, s_adj, rs, 11,
        )

        lab_k = lab_all[nb[0]]
        dcol = (np.abs(lab_all[nb] - lab_k) / span).sum(-1) / 3.0
        bd_c = np.clip(dcol, 0.0, 1.0) * 30
        c_bin = np.clip(np.floor(bd_c + 0.5), 0, 30).astype(np.int64)
        rc = bd_c - c_bin
        c_adj = np.mod(c_bin + np.sign(rc), 30).astype(np.int64)
        hist_c = soft_hist(
            vol, a_bin, e_bin, r_bin, ra, re, rr, e_ok, r_ok,
            c_bin, c_adj, rc, 31,
        )

        h = np.concatenate([hist_s, hist_c]).astype(np.float64)
        norm = np.linalg.norm(h)
        if norm > 0:
            desc[q] = h / norm
            valid[q] = True
    return desc.astype(np.float32), valid


def sc3d_np(xyz, normals, nvalid, kp_xyz, radius, tree):
    """pcl::ShapeContext3DEstimation -> ShapeContext1980
    (dispatch_descriptors.h:47-48): 12 azimuth x 11 elevation x 15
    log-radial bins, neighbor weight 1/(density * cbrt(bin_volume)),
    min_radius = 0.1 r, density radius = r/5 (PCL defaults). Grid sits in
    the repeatable SHOT LRF (the USC fix for PCL's random azimuth — same
    documented deviation as ops/descriptors/sc3d.py)."""
    nk = len(kp_xyz)
    naz, nel, nrad = 12, 11, 15
    desc = np.zeros((nk, naz * nel * nrad))
    valid = np.zeros(nk, bool)
    min_radius = 0.1 * radius
    log_ratio = np.log(radius / min_radius)
    edges = min_radius * np.exp(np.arange(nrad + 1) / nrad * log_ratio)
    shell_vol = (4.0 / 3.0) * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    bin_vol = shell_vol / (naz * nel)
    density = np.asarray(
        [len(v) for v in tree.query_ball_point(xyz, radius / 5.0)], np.float64
    )
    lists = tree.query_ball_point(kp_xyz, radius)
    for q, nb in enumerate(lists):
        nb = np.asarray(nb, np.int64)
        nb = nb[nvalid[nb]]
        if len(nb) < 5:
            continue
        lrf = _shot_lrf_np(kp_xyz[q], xyz[nb], radius)
        if lrf is None:
            continue
        x, y, z = lrf
        off = xyz[nb] - kp_xyz[q]
        d = np.linalg.norm(off, axis=1)
        lx, ly, lz = off @ x, off @ y, off @ z
        azimuth = np.arctan2(ly, lx)
        a_bin = np.clip(
            np.floor((azimuth + np.pi) / (2 * np.pi) * naz), 0, naz - 1
        ).astype(np.int64)
        r_xy = np.sqrt(np.maximum(lx * lx + ly * ly, 1e-12))
        elevation = np.arctan2(r_xy, lz)
        e_bin = np.clip(
            np.floor(elevation / np.pi * nel), 0, nel - 1
        ).astype(np.int64)
        r_cont = np.log(np.maximum(d, 1e-9) / min_radius) / log_ratio * nrad
        r_bin = np.clip(np.floor(r_cont), 0, nrad - 1).astype(np.int64)
        w = 1.0 / (
            np.cbrt(np.maximum(bin_vol[r_bin], 1e-12))
            * np.maximum(density[nb], 1.0)
        )
        joint = (a_bin * nel + e_bin) * nrad + r_bin
        h = np.bincount(joint, weights=w, minlength=desc.shape[1])
        norm = np.linalg.norm(h)
        if norm > 0:
            desc[q] = h / norm
            valid[q] = True
    return desc.astype(np.float32), valid


# ------------------------------------------------------------ L2 matching
def find_correspondences_np(src_desc, tgt_desc, k):
    """Reciprocal k-NN cross-match, first-match-wins
    (matching.cpp:31-93)."""
    if len(src_desc) == 0 or len(tgt_desc) == 0:
        return np.zeros((0, 2), np.int64), np.zeros((0,))
    k_eff = min(k, len(tgt_desc), len(src_desc))
    t_tree = cKDTree(tgt_desc)
    s_tree = cKDTree(src_desc)
    fwd_d, fwd_i = t_tree.query(src_desc, k=k_eff)
    _, back_i = s_tree.query(tgt_desc, k=k_eff)
    fwd_i = fwd_i.reshape(len(src_desc), -1)
    fwd_d = fwd_d.reshape(len(src_desc), -1)
    back_i = back_i.reshape(len(tgt_desc), -1)
    out, dists = [], []
    for s in range(len(src_desc)):
        for slot in range(k_eff):
            t = fwd_i[s, slot]
            if s in back_i[t]:
                out.append((s, t))
                dists.append(fwd_d[s, slot] ** 2)
                break
    return np.asarray(out, np.int64).reshape(-1, 2), np.asarray(dists)


def ransac_np(src_kp, tgt_kp, corr, inlier_threshold, max_iterations, rng):
    """CorrespondenceRejectorSampleConsensus + SVD re-estimation
    (matching.cpp:110-140): zero matrix on failure."""
    if len(corr) < 3:
        return np.zeros((4, 4), np.float32), 0
    src = src_kp[corr[:, 0]]
    dst = tgt_kp[corr[:, 1]]
    thr2 = inlier_threshold**2
    best_count, best_in = 0, None
    for _ in range(max_iterations):
        pick = rng.choice(len(corr), 3, replace=False)
        t, ok = _kabsch_np(src[pick], dst[pick])
        if not ok:
            continue
        resid2 = ((_apply(t, src) - dst) ** 2).sum(1)
        inl = resid2 <= thr2
        c = int(inl.sum())
        if c > best_count:
            best_count, best_in = c, inl
    if best_count < 3:
        return np.zeros((4, 4), np.float32), 0
    t, ok = _kabsch_np(src[best_in], dst[best_in])
    if not ok:
        return np.zeros((4, 4), np.float32), 0
    return t, best_count


def sacia_np(
    src_kp, src_desc, tgt_kp, tgt_desc,
    min_sample_distance, max_correspondence_distance, max_iterations, rng,
    k_features=10,
):
    """pcl::SampleConsensusInitialAlignment as the reference configures it
    (matching.cpp:142-194, 242-247): per iteration, 3 source keypoints with
    pairwise distance >= min_sample_distance, each matched to a random one
    of its k_features nearest target descriptors, rigid solve, scored by
    the truncated error sum(min(nn_dist, max_correspondence_distance)) over
    all source keypoints; best (lowest error) wins."""
    if len(src_kp) < 3 or len(tgt_kp) < 3:
        return np.zeros((4, 4), np.float32)
    kf = min(k_features, len(tgt_desc))
    d_tree = cKDTree(tgt_desc)
    _, feat_nn = d_tree.query(src_desc, k=kf)
    feat_nn = feat_nn.reshape(len(src_desc), -1)
    xyz_tree = cKDTree(tgt_kp)
    best_err, best_t = np.inf, np.zeros((4, 4), np.float32)
    min_d2 = min_sample_distance**2
    for _ in range(max_iterations):
        # selectSamples: rejection-sample a triple obeying the min distance
        for _attempt in range(100):
            pick = rng.choice(len(src_kp), 3, replace=False)
            p = src_kp[pick]
            d2 = ((p[:, None] - p[None, :]) ** 2).sum(-1)
            if d2[np.triu_indices(3, 1)].min() >= min_d2:
                break
        else:
            continue
        tgt_pick = feat_nn[pick, rng.integers(0, kf, 3)]
        t, ok = _kabsch_np(src_kp[pick], tgt_kp[tgt_pick])
        if not ok:
            continue
        d, _ = xyz_tree.query(_apply(t, src_kp))
        err = np.minimum(d, max_correspondence_distance).sum()
        if err < best_err:
            best_err, best_t = err, t
    return best_t


def icp_np(
    src_xyz,
    tgt_xyz,
    initial,
    max_correspondence_distance,
    outlier_rejection_threshold,
    max_iterations,
    transform_epsilon,
):
    """pcl::IterativeClosestPoint as configured at matching.cpp:196-221:
    fixed-bound correspondences, outlier-trimmed refit, epsilon convergence;
    result composes with the initial guess."""
    tree = cKDTree(tgt_xyz)
    t = initial.astype(np.float64).copy()
    if not t.any():
        return initial.astype(np.float32)
    rej2 = outlier_rejection_threshold**2
    for _ in range(max_iterations):
        moved = _apply(t, src_xyz)
        d, idx = tree.query(
            moved, k=1, distance_upper_bound=max_correspondence_distance
        )
        m = np.isfinite(d)
        if m.sum() < 3:
            break
        delta, ok = _kabsch_np(moved[m], tgt_xyz[idx[m]])
        if not ok:
            break
        if rej2 > 0:
            resid2 = ((_apply(delta, moved[m]) - tgt_xyz[idx[m]]) ** 2).sum(1)
            inl = resid2 <= rej2
            if inl.sum() >= 3:
                delta2, ok2 = _kabsch_np(moved[m][inl], tgt_xyz[idx[m]][inl])
                if ok2:
                    delta = delta2
        t_new = delta.astype(np.float64) @ t
        change = np.sqrt(((t_new - t) ** 2).sum())
        t = t_new
        if change < transform_epsilon:
            break
    return t.astype(np.float32)


def transform_score_np(src_xyz, tgt_xyz, transform, max_range):
    """TransformationValidationEuclidean (matching.cpp:259-268)."""
    if not transform.any():
        return 1.0e30
    tree = cKDTree(tgt_xyz)
    d, _ = tree.query(_apply(transform, src_xyz), k=1,
                      distance_upper_bound=max_range)
    m = np.isfinite(d)
    if not m.any():
        return 1.0e30
    return float((d[m] ** 2).mean())


# ------------------------------------------------------------ L3 pipeline
def extract_features_np(xyz, rgb, params: MergeParams, timings=None):
    """The four per-cloud stages of map_merging.cpp:211-242."""
    t0 = time.perf_counter()
    xyz, rgb = voxel_downsample_np(xyz, rgb, params.resolution)
    t1 = time.perf_counter()
    xyz, rgb = remove_outliers_np(
        xyz, rgb, params.descriptor_radius, params.outliers_min_neighbours
    )
    t2 = time.perf_counter()
    normals, curv, nvalid, tree = normals_np(xyz, params.normal_radius)
    t3 = time.perf_counter()
    if params.keypoint_type == Keypoint.HARRIS:
        kp_xyz, _ = harris_np(
            xyz, normals, nvalid, params.keypoint_threshold,
            params.normal_radius, tree,
        )
    else:
        kp_xyz, _ = sift_np(
            xyz, rgb, params.resolution, params.sift_octaves,
            params.sift_scales_per_octave, params.keypoint_threshold,
        )
    t4 = time.perf_counter()
    if params.descriptor_type == Descriptor.FPFH:
        desc, dvalid = fpfh_np(
            xyz, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    elif params.descriptor_type == Descriptor.PFH:
        desc, dvalid = pfh_np(
            xyz, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    elif params.descriptor_type == Descriptor.PFHRGB:
        desc, dvalid = pfhrgb_np(
            xyz, rgb, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    elif params.descriptor_type == Descriptor.RSD:
        desc, dvalid = rsd_np(
            xyz, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    elif params.descriptor_type == Descriptor.SHOT:
        desc, dvalid = shot_np(
            xyz, rgb, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    elif params.descriptor_type == Descriptor.SC3D:
        desc, dvalid = sc3d_np(
            xyz, normals, nvalid, kp_xyz, params.descriptor_radius, tree
        )
    else:
        raise NotImplementedError(
            f"oracle has no {params.descriptor_type} implementation"
        )
    # drop keypoints with invalid descriptors (features.cpp:118-141)
    kp_xyz = kp_xyz[dvalid]
    desc = desc[dvalid]
    t5 = time.perf_counter()
    if timings is not None:
        timings["downsample"] = timings.get("downsample", 0.0) + t1 - t0
        timings["outliers"] = timings.get("outliers", 0.0) + t2 - t1
        timings["normals"] = timings.get("normals", 0.0) + t3 - t2
        timings["keypoints"] = timings.get("keypoints", 0.0) + t4 - t3
        timings["descriptors"] = timings.get("descriptors", 0.0) + t5 - t4
    return xyz, rgb, kp_xyz, desc


def estimate_transform_np(
    feats_s, feats_t, params: MergeParams, rng, timings=None
):
    """estimateTransform (matching.cpp:223-257) for one pair."""
    xyz_s, _, kp_s, desc_s = feats_s
    xyz_t, _, kp_t, desc_t = feats_t
    t0 = time.perf_counter()
    if params.estimation_method == EstimationMethod.MATCHING:
        corr, _ = find_correspondences_np(desc_s, desc_t, params.matching_k)
        t1 = time.perf_counter()
        transform, inliers = ransac_np(
            kp_s, kp_t, corr, params.inlier_threshold,
            params.max_iterations, rng,
        )
    elif params.estimation_method == EstimationMethod.SAC_IA:
        # matching.cpp:242-247: min_sample_distance = inlier_threshold
        t1 = time.perf_counter()
        transform = sacia_np(
            kp_s, desc_s, kp_t, desc_t, params.inlier_threshold,
            params.max_correspondence_distance, params.max_iterations, rng,
        )
    else:
        raise NotImplementedError(
            f"oracle has no {params.estimation_method} implementation"
        )
    t2 = time.perf_counter()
    if params.refine_transform and transform.any():
        transform = icp_np(
            xyz_s, xyz_t, transform, params.max_correspondence_distance,
            params.inlier_threshold, params.max_iterations,
            params.transform_epsilon,
        )
    t3 = time.perf_counter()
    score = transform_score_np(
        xyz_s, xyz_t, transform, params.max_correspondence_distance
    )
    t4 = time.perf_counter()
    if timings is not None:
        timings["matching"] = timings.get("matching", 0.0) + t1 - t0
        timings["ransac"] = timings.get("ransac", 0.0) + t2 - t1
        timings["icp"] = timings.get("icp", 0.0) + t3 - t2
        timings["score"] = timings.get("score", 0.0) + t4 - t3
    return transform, 1.0 / max(score, 1e-30)


def estimate_maps_transforms_np(
    clouds: list[tuple[np.ndarray, np.ndarray]],
    params: MergeParams | None = None,
    seed: int = 0,
    timings: dict | None = None,
) -> list[np.ndarray]:
    """estimateMapsTransforms (map_merging.cpp:188-275) on CPU.

    `clouds` are (xyz, rgb) float32 array pairs. Returns the per-map 4x4
    transforms (zero = failed), exactly the reference contract.
    """
    params = params or MergeParams()
    if not clouds:
        return []
    if len(clouds) == 1:
        return [np.eye(4, dtype=np.float32)]
    rng = np.random.default_rng(seed)
    feats = [
        extract_features_np(x, r, params, timings=timings) for x, r in clouds
    ]
    estimates = []
    for i in range(len(clouds) - 1):
        for j in range(i + 1, len(clouds)):
            if len(feats[i][2]) == 0 or len(feats[j][2]) == 0:
                continue
            transform, conf = estimate_transform_np(
                feats[i], feats[j], params, rng, timings=timings
            )
            estimates.append(
                TransformEstimate(
                    source_idx=i, target_idx=j,
                    transform=transform, confidence=conf,
                )
            )
    if not estimates:
        return []
    return compute_global_transforms(estimates, params.confidence_threshold)
