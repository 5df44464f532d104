"""Measure the CPU-oracle baseline and freeze golden data.

Runs mapmerge_tpu.oracle (the faithful kd-tree CPU implementation of the
reference pipeline, see oracle.py) on the driver eval configs and writes
golden/config{N}.json with wall-clock, per-stage timings, the estimated
SE(3) poses, and their error against synthetic ground truth.

These files are committed: bench.py anchors `vs_baseline` to the frozen
wall-clock, and tests/test_oracle_parity.py asserts the pipeline's
poses match the oracle's golden poses within tolerance (VERDICT r1 item 1).

Usage: python scripts/run_oracle.py [config1] [config2]
"""

from __future__ import annotations

import json
import os
import sys
import time

# the oracle is a CPU measurement: keep JAX (used for a few helpers) off
# the accelerator, so the run neither reserves nor waits for it
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from synthetic import make_scene, overlapping_views, rotation_z, se3  # noqa: E402

from mapmerge_tpu.core.params import MergeParams  # noqa: E402
from mapmerge_tpu.oracle import estimate_maps_transforms_np  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "golden")


def pose_errors(transforms, truths):
    """Per-map rot (deg) / trans (m) errors of rel poses vs ground truth."""
    errs = []
    t0 = transforms[0]
    for i, truth in enumerate(truths):
        rel = np.linalg.inv(t0) @ transforms[i]
        r = rel[:3, :3] @ truth[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
        errs.append((float(ang), float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))))
    return errs


def build_config1():
    """Eval config #1: 2-map ~50k-pt pairwise merge — EXACTLY bench.py's
    scene and params (so vs_baseline compares identical work)."""
    from bench import build_views, bench_params

    va, vb, truth = build_views()
    clouds = [va.to_arrays(), vb.to_arrays()]
    params = bench_params()
    return clouds, [np.eye(4, dtype=np.float32), truth], params


def build_config2():
    """Eval config #2: 5-map ~500k-pt all-pairs merge — the same town fixture
    and params bench_configs.config2 runs on the chip."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench_fixtures import big_params, town_views

    views, truths = town_views(5, view_resized_target=500_000)
    return views, truths, big_params(1 << 20)


def run(name: str, builder):
    clouds, truths, params = builder()
    sizes = [len(x) for x, _ in clouds]
    print(f"[{name}] clouds: {sizes}", flush=True)
    timings: dict = {}
    t0 = time.perf_counter()
    transforms = estimate_maps_transforms_np(
        clouds, params, seed=0, timings=timings
    )
    wall = time.perf_counter() - t0
    errs = pose_errors(transforms, truths)
    record = {
        "config": name,
        "machine": os.uname().nodename,
        "date": time.strftime("%Y-%m-%d"),
        "cloud_sizes": sizes,
        "params": {
            "keypoint_type": str(params.keypoint_type),
            "descriptor_type": str(params.descriptor_type),
            "resolution": params.resolution,
            "matching_k": params.matching_k,
            "max_iterations": params.max_iterations,
            "refine_transform": params.refine_transform,
        },
        "wall_seconds": round(wall, 3),
        "stage_seconds": {k: round(v, 3) for k, v in timings.items()},
        "transforms": [np.asarray(t).tolist() for t in transforms],
        "pose_errors_deg_m": errs,
    }
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[{name}] wall={wall:.2f}s stage={timings}")
    print(f"[{name}] pose errors (deg, m): {errs}")
    print(f"[{name}] -> {path}", flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["config1"]
    builders = {"config1": build_config1, "config2": build_config2}
    for name in which:
        run(name, builders[name])
