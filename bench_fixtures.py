"""Fixtures and accuracy gates shared by bench_configs.py and chip_smoke.py.

Scenes come from tests/synthetic.py and are made from a seed, so every run
builds the same maps with known SE(3) truths.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "golden")
sys.path.insert(0, os.path.join(REPO, "tests"))


def device_record() -> dict:
    """The devices a measurement ran on, as JAX reports them."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }


def require_gpu() -> dict:
    """Measurements run on the GPU only: exit with a message when JAX finds
    none (no fallback to the CPU). Returns device_record()."""
    try:
        record = device_record()
    except RuntimeError as e:  # a GPU backend was asked for and not found
        raise SystemExit(f"no GPU found: {e}") from e
    if record["platform"] != "gpu":
        raise SystemExit(
            "no GPU found: JAX's first device is "
            f"{record['platform']!r} ({record['device_kind']}); "
            "this measurement runs on a GPU only"
        )
    return record


def pose_err(rel, truth):
    """(rotation deg, translation m) between two 4x4 poses."""
    from mapmerge_tpu.core import transforms as tf

    rot = float(
        tf.rotation_geodesic_deg(
            np.asarray(rel, np.float32), np.asarray(truth, np.float32)
        )
    )
    trans = float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))
    return rot, trans


def town_views(n_maps: int, view_resized_target: int, keep: float = 0.6,
               seed: int = 42):
    """N overlapping views of one make_town scene with known SE(3) truths.

    `view_resized_target` ~ registration-resolution points per view."""
    from synthetic import make_town, n_overlapping_views, rotation_z, se3

    rng = np.random.default_rng(seed)
    xyz, rgb = make_town(rng, int(view_resized_target / keep))
    truths = [
        np.eye(4, dtype=np.float32)
        if i == 0
        else se3(
            rotation_z(0.15 * ((i % 7) - 3)),
            [0.6 * (i % 5), -0.3 * (i % 4), 0.04 * (i % 3)],
        )
        for i in range(n_maps)
    ]
    views = n_overlapping_views(rng, xyz, rgb, truths, keep=keep)
    return views, truths


def big_params(max_points, engine="auto"):
    """Parameters of the big-cloud configs (grid engine, staged features)."""
    from mapmerge_tpu.core.params import MergeParams

    return MergeParams(
        keypoint_type="HARRIS",
        keypoint_threshold=5.0,
        descriptor_type="FPFH",
        refine_transform=True,
        max_iterations=40,
        max_points=max_points,
        max_keypoints=1024,
        max_neighbors=48,
        ransac_hypotheses=1024,
        neighbor_engine=engine,
    )


def stream_params():
    """Parameters of the 50-map online stream (config5). ICP refinement ON
    (the reference default): RANSAC-only pairwise poses carry degrees of
    error on these tiny 2048-pt views, and a ~25-hop chain compounds that
    past any graph solve's reach."""
    from mapmerge_tpu.core.params import MergeParams

    return MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0,
        descriptor_type="FPFH", refine_transform=True, max_iterations=20,
        max_points=4096, max_keypoints=128, max_neighbors=32,
        ransac_hypotheses=256, neighbor_tile=256,
    )


def config4_fixture():
    """20 maps (190 pairs) of 4096-pt views: the mesh merge fixture."""
    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.core.params import MergeParams

    n_maps = 20
    views, truths = town_views(n_maps, view_resized_target=4096, seed=3)
    sizes = [len(v[0]) for v in views]
    raw_cap = 1 << int(np.ceil(np.log2(max(sizes))))
    clouds = [
        PointCloud.from_arrays(x, r, capacity=raw_cap) for x, r in views
    ]
    params = MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0,
        descriptor_type="FPFH", refine_transform=True,
        max_iterations=30,
        max_points=8192, max_keypoints=384, max_neighbors=48,
        ransac_hypotheses=768, neighbor_tile=256,
    )
    return clouds, truths, params, raw_cap


def check_chain(transforms, truths, rot_tol, trans_tol, min_ok=None):
    """Accuracy gate: relative poses (vs the first successfully-registered
    map as anchor) must match the ground-truth relative poses."""
    ok_idx = [
        i for i in range(min(len(transforms), len(truths)))
        if np.asarray(transforms[i]).any()
    ]
    need = min_ok if min_ok is not None else len(truths)
    assert ok_idx, "accuracy gate: no map registered at all"
    a = ok_idx[0]
    inv_ta = np.linalg.inv(transforms[a])
    inv_truth_a = np.linalg.inv(truths[a])
    n_ok, errs = 0, []
    for i in ok_idx:
        rel = inv_ta @ transforms[i]
        truth_rel = inv_truth_a @ truths[i]
        rot, trans = pose_err(rel, truth_rel)
        errs.append((rot, trans))
        if rot < rot_tol and trans < trans_tol:
            n_ok += 1
    assert n_ok >= need, f"accuracy gate: only {n_ok}/{len(truths)} maps ok ({errs})"
    return errs


def check_golden(transforms, name: str, rot_tol: float, trans_tol: float):
    """Pose gate against the frozen CPU-oracle poses golden/<name>.json
    (scripts/run_oracle.py): every map registered by both, relative to
    map 0, within the tolerances. Returns (golden dict, per-map errors)."""
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        golden = json.load(f)
    g0 = np.asarray(golden["transforms"][0], np.float32)
    errs = []
    for i, gt in enumerate(golden["transforms"]):
        gt = np.asarray(gt, np.float32)
        if not (gt.any() and np.asarray(transforms[i]).any()):
            continue
        rel = np.linalg.inv(np.asarray(transforms[0])) @ transforms[i]
        rot, trans = pose_err(rel, np.linalg.inv(g0) @ gt)
        errs.append((rot, trans))
        assert rot < rot_tol and trans < trans_tol, (
            f"golden pose gate ({name}): map {i}: {rot} deg {trans} m vs oracle"
        )
    return golden, errs
