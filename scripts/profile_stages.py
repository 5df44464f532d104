"""Per-stage wall-clock breakdown of the bench config (dev tool).

Times each pipeline stage warm: downsample/outliers/normals/keypoints/
descriptors (feature stage) and matching/RANSAC/ICP/score (registration).
"""

from __future__ import annotations

import time

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def timeit(fn, *args, reps=5, warm=1):
    for _ in range(warm):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


def main():
    import bench

    va, vb, truth = bench.build_views()
    params = bench.bench_params()

    from functools import partial

    from mapmerge_tpu.pipeline.features import extract_features
    from mapmerge_tpu.pipeline.registration import estimate_transform
    from mapmerge_tpu.ops.downsample import voxel_downsample
    from mapmerge_tpu.ops.outliers import remove_outliers
    from mapmerge_tpu.ops.normals import compute_surface_normals
    from mapmerge_tpu.ops.keypoints import detect_keypoints

    jit_feat = jax.jit(partial(extract_features, params=params))
    t_feat, fa = timeit(jit_feat, va)
    _, fb = timeit(jit_feat, vb)
    print(f"extract_features (per cloud): {t_feat*1e3:.1f} ms")

    # inner stages
    jit_ds = jax.jit(
        lambda c: voxel_downsample(c, params.resolution, out_capacity=params.max_points)
    )
    t_ds, da = timeit(jit_ds, va)
    print(f"  voxel_downsample: {t_ds*1e3:.1f} ms")

    jit_out = jax.jit(
        lambda c: remove_outliers(
            c,
            params.descriptor_radius,
            params.outliers_min_neighbours,
            tile=params.neighbor_tile,
        )
    )
    t_o, oa = timeit(jit_out, da)
    print(f"  remove_outliers: {t_o*1e3:.1f} ms")

    jit_n = jax.jit(
        lambda c: compute_surface_normals(
            c, params.normal_radius, tile=params.neighbor_tile
        )
    )
    t_n, na = timeit(jit_n, oa)
    print(f"  normals: {t_n*1e3:.1f} ms")

    jit_kp = jax.jit(
        lambda c, n: detect_keypoints(
            c,
            n,
            params.keypoint_type,
            threshold=params.keypoint_threshold,
            radius=params.normal_radius,
            resolution=params.resolution,
            max_keypoints=params.max_keypoints,
            tile=params.neighbor_tile,
            sift_octaves=params.sift_octaves,
            sift_scales_per_octave=params.sift_scales_per_octave,
        )
    )
    t_kp, kps = timeit(jit_kp, oa, na)
    print(f"  keypoints ({params.keypoint_type}): {t_kp*1e3:.1f} ms")

    from mapmerge_tpu.ops.descriptors import compute_descriptors

    jit_d = jax.jit(
        lambda c, n, k: compute_descriptors(
            c,
            n,
            k,
            params.descriptor_type,
            params.descriptor_radius,
            max_neighbors=params.max_neighbors,
            tile=params.neighbor_tile,
        )
    )
    t_d, _ = timeit(jit_d, oa, na, kps)
    print(f"  descriptors ({params.descriptor_type}): {t_d*1e3:.1f} ms")

    # registration substages
    key = jax.random.key(0)
    jit_est = jax.jit(partial(estimate_transform, params=params))
    jit_est2 = jax.jit(lambda a, b: jit_est(a, b, key=key))
    t_reg, est = timeit(jit_est2, fa, fb)
    print(f"estimate_transform (pair): {t_reg*1e3:.1f} ms")

    from mapmerge_tpu.ops.matching import find_correspondences

    jit_m = jax.jit(
        lambda a, b, av, bv: find_correspondences(
            a, b, k=params.matching_k, source_valid=av, target_valid=bv
        )
    )
    t_m, corr = timeit(
        jit_m,
        fa.descriptors.data,
        fb.descriptors.data,
        fa.descriptors.valid & fa.keypoints.mask,
        fb.descriptors.valid & fb.keypoints.mask,
    )
    print(f"  matching: {t_m*1e3:.1f} ms")

    from mapmerge_tpu.ops.ransac import ransac_transform

    jit_r = jax.jit(
        lambda s, t, c, k: ransac_transform(
            s,
            t,
            c,
            inlier_threshold=params.inlier_threshold,
            num_hypotheses=params.ransac_hypotheses,
            key=k,
        )
    )
    t_r, res = timeit(jit_r, fa.keypoints.xyz, fb.keypoints.xyz, corr, key)
    print(f"  ransac: {t_r*1e3:.1f} ms")

    from mapmerge_tpu.ops.icp import icp_refine

    jit_i = jax.jit(
        lambda s, t, init: icp_refine(
            s,
            t,
            init,
            max_correspondence_distance=params.max_correspondence_distance,
            outlier_rejection_threshold=params.inlier_threshold,
            max_iterations=params.max_iterations,
            transform_epsilon=params.transform_epsilon,
            tile=params.neighbor_tile,
            min_correspondence_distance=params.resolution,
        )
    )
    t_i, _ = timeit(jit_i, fa.cloud, fb.cloud, res.transform)
    print(f"  icp_refine ({params.max_iterations} iters max): {t_i*1e3:.1f} ms")

    from mapmerge_tpu.ops.score import transform_score

    jit_s = jax.jit(
        lambda s, t, tr: transform_score(
            s, t, tr, params.max_correspondence_distance, tile=params.neighbor_tile
        )
    )
    t_s, _ = timeit(jit_s, fa.cloud, fb.cloud, res.transform)
    print(f"  transform_score: {t_s*1e3:.1f} ms")

    total = 2 * t_feat + t_reg
    print(f"\nend-to-end estimate (2x features + pair): {total*1e3:.1f} ms")


if __name__ == "__main__":
    main()
