"""Stage-by-stage registration debugger.

Equivalent of the reference's registration_visualisation tool
(src/registration_visualisation.cpp:22-174): run the 2-cloud pipeline one
stage at a time with per-stage wall-clock timings (the pcl::ScopeTime
analog), point/keypoint/correspondence counts and scores printed after each
stage, BOTH estimation methods compared, and an ICP-refined final result.

Instead of interactive PCL viewer windows (unavailable headless), each
stage can dump its intermediate cloud as a .pcd into --dump-dir for offline
inspection, and --render DIR writes PNG renders of the five reference
views (cloud, normals, keypoints, correspondence lines, aligned overlay —
visualise.cpp:20-95) via tools/render.py.

Usage:
  python -m mapmerge_tpu.tools.registration_visualisation a.pcd b.pcd \
      [--param value ...] [--dump-dir DIR] [--render DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pcd_files = [a for a in argv if a.endswith(".pcd")]
    if len(pcd_files) != 2:
        print(
            "usage: registration_visualisation map1.pcd map2.pcd "
            "[--param value ...] [--dump-dir DIR]",
            file=sys.stderr,
        )
        return 1
    dump_dir = None
    if "--dump-dir" in argv:
        dump_dir = argv[argv.index("--dump-dir") + 1]
        os.makedirs(dump_dir, exist_ok=True)
    render_dir = None
    if "--render" in argv:
        render_dir = argv[argv.index("--render") + 1]
        os.makedirs(render_dir, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from mapmerge_tpu.core import transforms as tf
    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.io.pcd import read_pcd_arrays, write_pcd
    from mapmerge_tpu.ops.downsample import voxel_downsample
    from mapmerge_tpu.ops.descriptors import compute_descriptors
    from mapmerge_tpu.ops.icp import icp_refine
    from mapmerge_tpu.ops.keypoints import detect_keypoints
    from mapmerge_tpu.ops.matching import find_correspondences
    from mapmerge_tpu.ops.normals import compute_surface_normals
    from mapmerge_tpu.ops.outliers import remove_outliers
    from mapmerge_tpu.ops.ransac import ransac_transform
    from mapmerge_tpu.ops.sacia import sacia_transform
    from mapmerge_tpu.ops.score import transform_score
    from mapmerge_tpu.utils.profiling import StageTimes

    params = MergeParams.from_command_line(argv)
    print(params)
    timer = StageTimes()

    def dump(name: str, cloud: PointCloud):
        if dump_dir:
            write_pcd(os.path.join(dump_dir, name + ".pcd"), cloud)

    clouds = []
    for path in pcd_files:
        xyz, rgb = read_pcd_arrays(path)
        clouds.append(PointCloud.from_arrays(xyz, rgb))
        print(f"loaded {path}: {len(xyz)} points")

    stages = {}
    for i, cloud in enumerate(clouds):
        tag = f"map{i}"
        with timer.stage(f"{tag}/downsample"):
            resized = timer.block(voxel_downsample(cloud, params.resolution))
        print(f"  {tag} downsampled: {int(resized.count)} points")
        dump(f"{tag}_downsampled", resized)

        with timer.stage(f"{tag}/remove_outliers"):
            inliers = timer.block(
                remove_outliers(
                    resized,
                    params.descriptor_radius,
                    params.outliers_min_neighbours,
                    tile=params.neighbor_tile,
                )
            )
        print(f"  {tag} after outlier removal: {int(inliers.count)} points")
        dump(f"{tag}_inliers", inliers)

        with timer.stage(f"{tag}/normals"):
            normals = timer.block(
                compute_surface_normals(
                    inliers, params.normal_radius, tile=params.neighbor_tile
                )
            )
        print(f"  {tag} normals valid: {int(jnp.sum(normals.valid))}")

        with timer.stage(f"{tag}/keypoints"):
            keypoints = timer.block(
                detect_keypoints(
                    inliers,
                    normals,
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
        print(f"  {tag} keypoints: {int(keypoints.count)}")
        if dump_dir:
            kx = np.asarray(keypoints.xyz)[np.asarray(keypoints.mask)]
            write_pcd(
                os.path.join(dump_dir, f"{tag}_keypoints.pcd"),
                (kx, np.tile([1.0, 0.0, 0.0], (len(kx), 1))),
            )

        with timer.stage(f"{tag}/descriptors"):
            descriptors = timer.block(
                compute_descriptors(
                    inliers,
                    normals,
                    keypoints,
                    params.descriptor_type,
                    params.descriptor_radius,
                    max_neighbors=params.max_neighbors,
                    tile=params.neighbor_tile,
                )
            )
        print(
            f"  {tag} descriptors: {int(descriptors.count)} valid, "
            f"dim {descriptors.dim} ({params.descriptor_type})"
        )
        stages[i] = (inliers, normals, keypoints, descriptors)

        if render_dir:
            from mapmerge_tpu.tools import render as rnd

            xyz_np = np.asarray(inliers.xyz)[np.asarray(inliers.mask)]
            rgb_np = np.asarray(inliers.rgb)[np.asarray(inliers.mask)]
            paths = [
                rnd.render_cloud(
                    os.path.join(render_dir, f"{tag}_cloud.png"),
                    xyz_np, rgb_np, title=f"{tag} cloud",
                ),
                rnd.render_normals(
                    os.path.join(render_dir, f"{tag}_normals.png"),
                    np.asarray(inliers.xyz),
                    np.asarray(normals.normals),
                    valid=np.asarray(normals.valid & inliers.mask),
                    title=f"{tag} normals",
                ),
                rnd.render_keypoints(
                    os.path.join(render_dir, f"{tag}_keypoints.png"),
                    xyz_np, np.asarray(keypoints.xyz),
                    kp_mask=np.asarray(keypoints.mask),
                    title=f"{tag} keypoints",
                ),
            ]
            for p in paths:
                print(f"  rendered {p}")

    (c0, n0, k0, d0), (c1, n1, k1, d1) = stages[0], stages[1]

    # --- MATCHING path (matching.cpp:117-137 analog) ---
    with timer.stage("matching/correspondences"):
        corr = timer.block(
            find_correspondences(
                d0.data, d1.data, params.matching_k,
                source_valid=d0.valid & k0.mask,
                target_valid=d1.valid & k1.mask,
            )
        )
    print(f"  correspondences: {int(corr.count)}")

    with timer.stage("matching/ransac"):
        res = timer.block(
            ransac_transform(
                k0.xyz, k1.xyz, corr,
                inlier_threshold=params.inlier_threshold,
                num_hypotheses=params.ransac_hypotheses,
                key=jax.random.key(0),
            )
        )
    score_m, cov_m, _ = transform_score(
        c0, c1, res.transform, params.max_correspondence_distance,
        tile=params.neighbor_tile,
    )
    print(
        f"  RANSAC: ok={bool(res.ok)} inliers={int(res.inlier_count)} "
        f"score={float(score_m):.6f} coverage={float(cov_m):.2f}"
    )
    print(np.array2string(np.asarray(res.transform), precision=4))

    if render_dir:
        from mapmerge_tpu.tools import render as rnd

        valid_np = np.asarray(corr.valid)
        src_idx = np.nonzero(valid_np)[0]
        pairs = np.stack(
            [src_idx, np.asarray(corr.target)[src_idx]], axis=1
        )
        p = rnd.render_correspondences(
            os.path.join(render_dir, "correspondences.png"),
            np.asarray(k0.xyz), np.asarray(k1.xyz), pairs,
            inlier_mask=np.asarray(res.inliers)[src_idx],
        )
        print(f"  rendered {p}")

    # --- SAC-IA path for comparison (matching.cpp:139-154 analog) ---
    with timer.stage("sacia"):
        t_sac, ok_sac, inl_sac = timer.block(
            sacia_transform(
                k0, d0, k1, d1,
                min_sample_distance=params.inlier_threshold,
                max_correspondence_distance=params.max_correspondence_distance,
                num_iterations=params.sacia_hypotheses,
                key=jax.random.key(1),
            )
        )
    score_s, cov_s, _ = transform_score(
        c0, c1, t_sac, params.max_correspondence_distance,
        tile=params.neighbor_tile,
    )
    print(
        f"  SAC-IA: ok={bool(ok_sac)} inliers~{int(inl_sac)} "
        f"score={float(score_s):.6f} coverage={float(cov_s):.2f}"
    )

    # --- ICP refinement of the MATCHING result (matching.cpp:156-171) ---
    with timer.stage("icp"):
        refined, icp_ok, _ = timer.block(
            icp_refine(
                c0, c1, res.transform,
                max_correspondence_distance=params.max_correspondence_distance,
                outlier_rejection_threshold=params.inlier_threshold,
                max_iterations=params.max_iterations,
                transform_epsilon=params.transform_epsilon,
                tile=params.neighbor_tile,
                min_correspondence_distance=params.resolution,
            )
        )
    score_i, cov_i, _ = transform_score(
        c0, c1, refined, params.max_correspondence_distance,
        tile=params.neighbor_tile,
    )
    print(
        f"  ICP refined: ok={bool(icp_ok)} score={float(score_i):.6f} "
        f"coverage={float(cov_i):.2f}"
    )
    print(np.array2string(np.asarray(refined), precision=4))

    if render_dir:
        from mapmerge_tpu.tools import render as rnd

        moved_xyz = np.asarray(tf.apply(refined, c0.xyz))[np.asarray(c0.mask)]
        p = rnd.render_alignment(
            os.path.join(render_dir, "aligned_overlay.png"),
            moved_xyz, np.asarray(c1.xyz)[np.asarray(c1.mask)],
        )
        print(f"  rendered {p}")

    if dump_dir:
        moved = PointCloud(
            xyz=tf.apply(refined, c0.xyz), rgb=c0.rgb, mask=c0.mask
        )
        ax, argb = moved.to_arrays()
        bx, brgb = c1.to_arrays()
        write_pcd(
            os.path.join(dump_dir, "aligned_overlay.pcd"),
            (
                np.concatenate([ax, bx]),
                np.concatenate(
                    [
                        np.tile([1.0, 0.3, 0.3], (len(ax), 1)),
                        np.tile([0.3, 0.3, 1.0], (len(bx), 1)),
                    ]
                ),
            ),
        )
        print(f"stage dumps written to {dump_dir}")

    total = sum(timer.times.values())
    print(f"total: {total * 1000.0:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
