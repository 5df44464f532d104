"""JAX pipeline vs the CPU oracle (mapmerge_tpu/oracle.py).

The oracle is the faithful kd-tree implementation of the reference pipeline
(same stage order as map_merging.cpp:188-275, scipy cKDTree for every
neighbor query, no caps). These tests pin the JAX pipeline to it at the
POSE level — the parity target SURVEY.md §7 names (descriptor bit-equality
is not required; SE(3) agreement within tolerance is).
"""

import json
import os

import numpy as np
import pytest

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.oracle import estimate_maps_transforms_np
from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

from synthetic import make_scene, overlapping_views, rotation_z, se3

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")


def rel_pose_delta(ours, theirs):
    """(deg, m) difference between the two pipelines' relative poses."""
    rel_a = np.linalg.inv(ours[0]) @ ours[1]
    rel_b = np.linalg.inv(theirs[0]) @ theirs[1]
    rot = float(
        tf.rotation_geodesic_deg(rel_a.astype(np.float32), rel_b.astype(np.float32))
    )
    trans = float(np.linalg.norm(rel_a[:3, 3] - rel_b[:3, 3]))
    return rot, trans


class TestSmallSceneParity:
    def test_harris_fpfh_pose_parity(self):
        rng = np.random.default_rng(7)
        xyz, rgb = make_scene(rng, n_boxes=6, extent=8.0, density=60.0)
        truth = se3(rotation_z(0.4), [1.5, -0.7, 0.2])
        va, vb = overlapping_views(
            np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
        )
        params = MergeParams.strict_parity(
            keypoint_type="HARRIS",
            keypoint_threshold=5.0,
            descriptor_type="FPFH",
            refine_transform=True,
            max_iterations=50,
            max_points=16384,
            max_keypoints=256,
            max_neighbors=48,
            ransac_hypotheses=512,
            neighbor_tile=512,
        )
        ours = estimate_maps_transforms([va, vb], params, seed=0)
        theirs = estimate_maps_transforms_np(
            [va.to_arrays(), vb.to_arrays()], params, seed=0
        )
        assert len(ours) == len(theirs) == 2
        rot, trans = rel_pose_delta(ours, theirs)
        assert rot < 1.0, f"pose rotation disagrees with oracle: {rot} deg"
        assert trans < 0.1, f"pose translation disagrees with oracle: {trans} m"


@pytest.mark.slow
class TestDescriptorMethodParity:
    """Pose parity for the rest of the descriptor x method surface
    (VERDICT r2 item 5): PFHRGB/SHOT/SC3D via MATCHING and FPFH/RSD via
    SAC_IA, each against the reference-shaped numpy oracle
    (dispatch_descriptors.h:38-48, matching.cpp:142-194).

    SHOT/SC3D/SAC-IA need a denser, corner-rich scene than the FPFH test:
    their LRF sign votes (and SAC-IA's truncated-error argmin) are only
    stable when keypoint neighborhoods are well populated — on sparse
    scenes BOTH pipelines degrade, which is fidelity, not a bug. RSD is
    matchable only through SAC-IA (2-d radii can't disambiguate reciprocal
    k-NN; the JAX suite excludes it from MATCHABLE for the same reason)."""

    @staticmethod
    def _views():
        rng = np.random.default_rng(7)
        xyz, rgb = make_scene(rng, n_boxes=12, extent=8.0, density=90.0)
        truth = se3(rotation_z(0.4), [1.5, -0.7, 0.2])
        return overlapping_views(
            np.random.default_rng(3), xyz, rgb, truth, overlap=0.6
        )

    def _check(self, params):
        va, vb = self._views()
        ours = estimate_maps_transforms([va, vb], params, seed=0)
        theirs = estimate_maps_transforms_np(
            [va.to_arrays(), vb.to_arrays()], params, seed=0
        )
        assert np.asarray(ours[1]).any(), "JAX registration failed"
        assert np.asarray(theirs[1]).any(), "oracle registration failed"
        rot, trans = rel_pose_delta(ours, theirs)
        assert rot < 1.5, f"pose rotation disagrees with oracle: {rot} deg"
        assert trans < 0.15, f"pose translation disagrees: {trans} m"

    @pytest.mark.parametrize("desc", ["PFHRGB", "SHOT", "SC3D"])
    def test_matching_parity(self, desc):
        self._check(
            MergeParams.strict_parity(
                keypoint_type="HARRIS",
                keypoint_threshold=1.0,
                descriptor_type=desc,
                refine_transform=True,
                max_iterations=80,
                max_points=16384,
                max_keypoints=256,
                max_neighbors=48,
                ransac_hypotheses=512,
                neighbor_tile=512,
            )
        )

    @pytest.mark.parametrize("desc", ["FPFH", "RSD"])
    def test_sacia_parity(self, desc):
        self._check(
            MergeParams.strict_parity(
                keypoint_type="HARRIS",
                keypoint_threshold=1.0,
                descriptor_type=desc,
                estimation_method="SAC_IA",
                refine_transform=True,
                max_iterations=500,
                sacia_hypotheses=4096,
                max_points=16384,
                max_keypoints=256,
                max_neighbors=48,
                neighbor_tile=512,
            )
        )


@pytest.mark.slow
class TestGoldenConfig1:
    def test_bench_scene_matches_frozen_oracle_poses(self):
        """Eval config #1 golden poses (scripts/run_oracle.py)."""
        path = os.path.join(GOLDEN, "config1.json")
        if not os.path.exists(path):
            pytest.skip("golden/config1.json not generated")
        with open(path) as f:
            golden = json.load(f)
        theirs = [np.asarray(t, np.float32) for t in golden["transforms"]]

        import sys

        sys.path.insert(0, os.path.join(GOLDEN, ".."))
        from bench import bench_params, build_views

        va, vb, truth = build_views()
        ours = estimate_maps_transforms([va, vb], bench_params(), seed=0)
        rot, trans = rel_pose_delta(ours, theirs)
        assert rot < 1.0, f"golden pose rotation mismatch: {rot} deg"
        assert trans < 0.1, f"golden pose translation mismatch: {trans} m"
