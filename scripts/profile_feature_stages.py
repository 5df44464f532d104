"""Per-stage feature profile at scale under the grid engine (dev tool).

Usage: python scripts/profile_feature_stages.py [n_points]
"""
from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from synthetic import make_town, overlapping_views, rotation_z, se3  # noqa: E402

from mapmerge_tpu.core.params import MergeParams  # noqa: E402


def timeit(fn, *args, reps=3, warm=1, tag=""):
    for _ in range(warm):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    print(f"  {tag}: {dt:.3f} s")
    return out


def main():
    n_target = int(sys.argv[1]) if len(sys.argv) > 1 else 420_000
    rng = np.random.default_rng(42)
    xyz, rgb = make_town(rng, int(n_target / 0.8))
    truth = se3(rotation_z(0.3), [1.0, -0.5, 0.1])
    va, _ = overlapping_views(np.random.default_rng(3), xyz, rgb, truth, overlap=0.6)
    cap = 1 << int(np.ceil(np.log2(int(va.count))))
    print(f"view: {int(va.count)} pts, capacity {cap}, devices {jax.devices()}")
    params = MergeParams(
        keypoint_type="HARRIS", keypoint_threshold=5.0,
        descriptor_type="FPFH", max_points=cap, max_keypoints=1024,
        max_neighbors=48, neighbor_tile=1024, neighbor_engine="grid",
    )

    from mapmerge_tpu.ops.downsample import voxel_downsample
    from mapmerge_tpu.ops.outliers import remove_outliers
    from mapmerge_tpu.ops.normals import compute_surface_normals
    from mapmerge_tpu.ops.keypoints import detect_keypoints
    from mapmerge_tpu.ops.descriptors import compute_descriptors

    jit_ds = jax.jit(lambda c: voxel_downsample(c, params.resolution, out_capacity=params.max_points))
    da = timeit(jit_ds, va, tag="voxel_downsample")
    jit_out = jax.jit(lambda c: remove_outliers(c, params.descriptor_radius, params.outliers_min_neighbours, tile=params.neighbor_tile, engine="grid", scan_cap=params.grid_scan_cap))
    oa = timeit(jit_out, da, tag="remove_outliers")
    jit_n = jax.jit(lambda c: compute_surface_normals(c, params.normal_radius, tile=params.neighbor_tile, engine="grid", scan_cap=params.grid_scan_cap))
    na = timeit(jit_n, oa, tag="normals")
    jit_kp = jax.jit(lambda c, n: detect_keypoints(c, n, params.keypoint_type, threshold=params.keypoint_threshold, radius=params.normal_radius, resolution=params.resolution, max_keypoints=params.max_keypoints, tile=params.neighbor_tile, engine="grid", scan_cap=params.grid_scan_cap))
    kps = timeit(jit_kp, oa, na, tag="harris keypoints")
    print(f"  (keypoints found: {int(kps.count)})")
    jit_d = jax.jit(lambda c, n, k: compute_descriptors(c, n, k, params.descriptor_type, params.descriptor_radius, max_neighbors=params.max_neighbors, tile=params.neighbor_tile, engine="grid", scan_cap=params.grid_scan_cap))
    timeit(jit_d, oa, na, kps, tag="FPFH descriptors")


if __name__ == "__main__":
    main()
