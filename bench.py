"""Driver benchmark: pairwise registrations/sec/chip.

Eval config #1 from BASELINE.json: a 2-map ~50k-pt merge — full pipeline
(voxel downsample, outlier removal, normals, SIFT keypoints, FPFH
descriptors, reciprocal matching, batched RANSAC, annealed ICP, transform
score) — timed warm, end-to-end (features + registration + graph solve).

Prints ONE JSON line:
  {"metric": ..., "value": pairs/sec, "unit": ..., "vs_baseline": ...}

vs_baseline: speedup over the CPU oracle (mapmerge_tpu/oracle.py) — a
faithful kd-tree (scipy cKDTree) implementation of the reference pipeline
with the reference's stage order and no fixed-shape compromises, measured
on THIS exact scene+config by scripts/run_oracle.py and frozen in
golden/config1.json. The reference publishes no numbers (BASELINE.md), so
the measured kd-tree CPU wall-clock is the PCL stand-in; the oracle's
estimated poses are additionally the golden data the pipeline must match
(tests/test_oracle_parity.py).

Runs on the GPU only, in one process: with no GPU it exits non-zero and
prints no result. The timed section runs only after a full warm-up, and
the line names the devices it ran on.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_GOLDEN_CONFIG1 = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden", "config1.json"
)


def oracle_baseline_seconds() -> float | None:
    """Frozen CPU-oracle wall-clock for this exact config
    (scripts/run_oracle.py -> golden/config1.json)."""
    try:
        with open(_GOLDEN_CONFIG1) as f:
            return float(json.load(f)["wall_seconds"])
    except (OSError, KeyError, ValueError):
        return None


def build_views():
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    )
    from synthetic import make_scene, overlapping_views, rotation_z, se3

    rng = np.random.default_rng(7)
    # ~100k-pt scene; each view keeps ~60% -> ~50k-pt maps
    xyz, rgb = make_scene(rng, n_boxes=20, extent=16.0, density=220.0)
    truth = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
    va, vb = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    return va, vb, truth


def bench_params():
    from mapmerge_tpu.core.params import MergeParams

    return MergeParams(
        keypoint_type="SIFT",
        keypoint_threshold=3.0,
        descriptor_type="FPFH",
        refine_transform=True,
        max_iterations=60,
        max_points=32768,
        max_keypoints=512,
        max_neighbors=48,
        ransac_hypotheses=1024,
        neighbor_tile=1024,
    )


def main():
    from bench_fixtures import pose_err, require_gpu

    devices = require_gpu()
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms
    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    va, vb, truth = build_views()
    params = bench_params()

    # warm-up (compile)
    transforms = estimate_maps_transforms([va, vb], params, seed=0)

    # accuracy gate: a fast wrong answer is worthless
    rot_err, trans_err = pose_err(
        np.linalg.inv(transforms[0]) @ transforms[1], truth
    )
    assert rot_err < 1.0 and trans_err < 0.1, (
        f"accuracy gate failed: rot {rot_err} deg, trans {trans_err} m"
    )

    # median of >= 5 reps with spread: a mean-of-few is not a
    # reproducible headline
    reps = 5
    walls = []
    for r in range(reps):
        t0 = time.perf_counter()
        estimate_maps_transforms([va, vb], params, seed=0)
        walls.append(time.perf_counter() - t0)
    elapsed = float(np.median(walls))

    pairs_per_sec = 1.0 / elapsed

    baseline = oracle_baseline_seconds()
    vs_baseline = (baseline / elapsed) if baseline else 0.0

    print(
        json.dumps(
            {
                "metric": (
                    "pairwise registrations/sec/chip "
                    "(50k-pt pair, SIFT+FPFH+RANSAC+ICP end-to-end)"
                ),
                "value": round(pairs_per_sec, 4),
                "unit": "pairs/s",
                "vs_baseline": round(vs_baseline, 2),
                "reps": reps,
                "median_s": round(elapsed, 4),
                "min_s": round(min(walls), 4),
                "max_s": round(max(walls), 4),
                **devices,
            }
        )
    )


if __name__ == "__main__":
    main()
