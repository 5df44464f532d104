"""Scale probe: grid-engine feature stage + registration at large N.

Not a test — a measurement harness for the 500k-point scale path
(VERDICT r1 item 2 'Done' criterion: feature stage + ICP on a 500k-pt
cloud completes on-chip). Prints per-stage wall-clock.

Usage: python scripts/scale_probe.py [n_points] [engine]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from synthetic import make_town, overlapping_views, rotation_z, se3  # noqa: E402

from mapmerge_tpu.core import transforms as tf  # noqa: E402
from mapmerge_tpu.core.cloud import PointCloud  # noqa: E402
from mapmerge_tpu.core.params import MergeParams  # noqa: E402


def main():
    n_target = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    engine = sys.argv[2] if len(sys.argv) > 2 else "grid"
    print(f"devices: {jax.devices()}  target={n_target}  engine={engine}")

    # make_town sizes the surface area so voxel-downsampling at 0.1 m
    # yields ~n_target points per view (tests/synthetic.py)
    rng = np.random.default_rng(42)
    xyz, rgb = make_town(rng, int(n_target / 0.8))
    truth = se3(rotation_z(0.3), [1.0, -0.5, 0.1])
    va, vb = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
    )
    print(f"raw views: {int(va.count)}, {int(vb.count)} pts")

    cap = 1 << (int(np.ceil(np.log2(max(int(va.count), int(vb.count))))))
    params = MergeParams(
        keypoint_type="HARRIS",
        keypoint_threshold=5.0,
        descriptor_type="FPFH",
        refine_transform=True,
        max_iterations=40,
        max_points=cap,
        max_keypoints=1024,
        max_neighbors=48,
        ransac_hypotheses=1024,
        neighbor_tile=1024,
        neighbor_engine=engine,
    )

    from mapmerge_tpu.pipeline.features import extract_features
    from mapmerge_tpu.pipeline.registration import estimate_transform

    def run_once(tag):
        t0 = time.perf_counter()
        fa = extract_features(va, params)
        jax.block_until_ready(fa)
        t1 = time.perf_counter()
        fb = extract_features(vb, params)
        jax.block_until_ready(fb)
        t2 = time.perf_counter()
        est = estimate_transform(fa, fb, params, jax.random.key(0))
        jax.block_until_ready(est.transform)
        t3 = time.perf_counter()
        print(
            f"[{tag}] features_a={t1-t0:.2f}s features_b={t2-t1:.2f}s "
            f"register={t3-t2:.2f}s  kp_a={int(fa.keypoints.count)} "
            f"resized_a={int(fa.cloud.count)} overflow={int(fa.scan_overflow)}"
        )
        return est

    est = run_once("cold")
    est = run_once("warm")
    t = np.asarray(est.transform)
    rel = t  # single pair: source->target should equal truth
    rot = float(tf.rotation_geodesic_deg(rel.astype(np.float32), truth))
    trans = float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))
    print(f"pose error: rot={rot:.3f} deg trans={trans:.4f} m "
          f"conf={float(est.confidence):.3f}")


if __name__ == "__main__":
    main()
