"""Pose-graph refinement (graph/pose_graph.py): SE(3) math + drift removal.

The scenario the refiner exists for (VERDICT r2: config #4/#5 end-to-end
drift): an N-map chain whose MST hops each carry a small error compounds
with graph diameter; relaxing the full confident edge set must pull the
end-of-chain pose back to truth.
"""

from __future__ import annotations

import numpy as np
import pytest

from mapmerge_tpu.graph.merge_graph import (
    TransformEstimate,
    compute_global_transforms,
)
from mapmerge_tpu.graph.pose_graph import (
    consensus_seed,
    refine_global_transforms,
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
)


def rot_err_deg(a, b):
    r = a[:3, :3] @ b[:3, :3].T
    return np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))


class TestLieMaps:
    def test_so3_roundtrip(self):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(64, 3))
        # log(exp(w)) == w only on the principal ball |w| < pi
        w *= (0.98 * np.pi / np.maximum(
            np.linalg.norm(w, axis=-1, keepdims=True), 1.0
        )) * rng.uniform(0.01, 1.0, (64, 1))
        np.testing.assert_allclose(so3_log(so3_exp(w)), w, atol=1e-7)

    def test_so3_log_principal_equivalence(self):
        # above pi the log returns the principal vector: same rotation
        w = np.array([[0.0, 2.5, 2.5], [3.0, -1.0, 2.0]])
        back = so3_log(so3_exp(w))
        np.testing.assert_allclose(so3_exp(back), so3_exp(w), atol=1e-7)
        assert np.all(np.linalg.norm(back, axis=-1) <= np.pi + 1e-9)

    def test_so3_near_pi(self):
        w = np.array([[0.0, 0.0, np.pi - 1e-5], [np.pi - 1e-5, 0.0, 0.0]])
        back = so3_log(so3_exp(w))
        np.testing.assert_allclose(back, w, atol=1e-4)

    def test_se3_roundtrip(self):
        rng = np.random.default_rng(1)
        xi = rng.normal(size=(64, 6))
        xi[:, 3:] *= 0.6  # keep rotation angle well inside the principal ball
        np.testing.assert_allclose(se3_log(se3_exp(xi)), xi, atol=1e-8)

    def test_se3_identity(self):
        np.testing.assert_allclose(
            se3_exp(np.zeros((6,))), np.eye(4), atol=1e-12
        )


def _ring_truth(n: int, radius: float = 5.0):
    """Ground-truth global poses on a yaw ring (loop closures exist)."""
    truths = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c, s = np.cos(a), np.sin(a)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * c, radius * s, 0.1 * i]
        truths.append(T)
    return truths


def _edge(truths, i, j, noise_xi=None, conf=10.0):
    # convention: global[i] = global[j] @ T  =>  T = inv(G_j) @ G_i
    T = np.linalg.inv(truths[j]) @ truths[i]
    if noise_xi is not None:
        T = T @ se3_exp(noise_xi)
    return TransformEstimate(i, j, T.astype(np.float32), conf)


class TestRefinement:
    def test_chain_drift_removed(self):
        """Noisy adjacent edges + exact loop/skip edges: MST drifts, the
        relaxation recovers truth."""
        n = 12
        truths = _ring_truth(n)
        rng = np.random.default_rng(7)
        ests = []
        for i in range(n - 1):
            # adjacent edges carry ~2 deg / 5 cm of noise
            noise = np.concatenate(
                [rng.normal(0, 0.03, 3), rng.normal(0, 0.02, 3)]
            )
            ests.append(_edge(truths, i + 1, i, noise, conf=10.0))
        # skip-2 + loop edges are clean; same confidence (the MST still
        # chains the adjacent edges — they sort first on equal weight)
        for i in range(n - 2):
            ests.append(_edge(truths, i + 2, i, None, conf=10.0))
        ests.append(_edge(truths, 0, n - 1, None, conf=10.0))  # loop closure

        seed = compute_global_transforms(ests, 0.0)
        refined = refine_global_transforms(ests, seed, 0.0)

        # express against node 0 and compare relative poses to truth
        def max_err(tfs):
            errs_r, errs_t = [], []
            base = np.linalg.inv(tfs[0])
            tbase = np.linalg.inv(truths[0])
            for i in range(n):
                rel = base @ tfs[i]
                rel_true = tbase @ truths[i]
                errs_r.append(rot_err_deg(rel, rel_true))
                errs_t.append(np.linalg.norm(rel[:3, 3] - rel_true[:3, 3]))
            return max(errs_r), max(errs_t)

        seed_r, seed_t = max_err(seed)
        ref_r, ref_t = max_err(refined)
        assert ref_r < seed_r * 0.5 and ref_t < seed_t * 0.5
        assert ref_r < 1.5, f"rot {ref_r} deg after refinement"
        assert ref_t < 0.10, f"trans {ref_t} m after refinement"

    def test_bad_edge_downweighted(self):
        """A grossly wrong low-confidence edge must not wreck the solve
        (Huber kernel)."""
        n = 6
        truths = _ring_truth(n)
        ests = []
        for i in range(n - 1):
            ests.append(_edge(truths, i + 1, i, None, conf=100.0))
        for i in range(n - 2):
            ests.append(_edge(truths, i + 2, i, None, conf=5.0))
        # poison edge: 30 deg off
        bad = _edge(truths, 3, 0, np.array([0, 0, 0, 0, 0, 0.5]), conf=5.0)
        ests.append(bad)

        seed = compute_global_transforms(ests, 0.0)
        refined = refine_global_transforms(ests, seed, 0.0)
        base = np.linalg.inv(refined[0])
        tbase = np.linalg.inv(truths[0])
        for i in range(n):
            rel = base @ refined[i]
            rel_true = tbase @ truths[i]
            assert rot_err_deg(rel, rel_true) < 2.0
            assert np.linalg.norm(rel[:3, 3] - rel_true[:3, 3]) < 0.05

    def test_zero_matrix_passthrough(self):
        """Unregistered maps stay zero; registered ones refine."""
        truths = _ring_truth(5)
        ests = [_edge(truths, i + 1, i, None, 10.0) for i in range(4)]
        ests.append(_edge(truths, 2, 0, None, 10.0))
        seed = compute_global_transforms(ests, 0.0)
        seed.append(np.zeros((4, 4), np.float32))  # a 6th, unregistered map
        refined = refine_global_transforms(ests, seed, 0.0)
        assert not refined[5].any()
        assert all(refined[i][:3, :3].any() for i in range(5))

    def test_tree_only_noop(self):
        """With exactly the tree's edges there is nothing to relax — the
        seed must come back unchanged."""
        truths = _ring_truth(4)
        ests = [_edge(truths, i + 1, i, None, 10.0) for i in range(3)]
        seed = compute_global_transforms(ests, 0.0)
        refined = refine_global_transforms(ests, seed, 0.0)
        for a, b in zip(seed, refined):
            np.testing.assert_allclose(a, b, atol=1e-7)

    def test_reference_gauge_fixed(self):
        """The identity (reference) node stays exactly identity."""
        n = 8
        truths = _ring_truth(n)
        rng = np.random.default_rng(3)
        ests = []
        for i in range(n - 1):
            noise = np.concatenate(
                [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
            )
            ests.append(_edge(truths, i + 1, i, noise, conf=50.0))
        for i in range(n - 2):
            ests.append(_edge(truths, i + 2, i, None, conf=5.0))
        seed = compute_global_transforms(ests, 0.0)
        ref = next(
            i for i, t in enumerate(seed) if np.allclose(t, np.eye(4))
        )
        refined = refine_global_transforms(ests, seed, 0.0)
        np.testing.assert_allclose(refined[ref], np.eye(4), atol=1e-6)


class TestPipelineFlag:
    def test_strict_parity_disables(self):
        from mapmerge_tpu.core.params import MergeParams

        assert MergeParams().global_refinement is True
        assert MergeParams.strict_parity().global_refinement is False


class TestConsensusSeed:
    @staticmethod
    def _max_err(tfs, truths):
        base, tbase = np.linalg.inv(tfs[0]), np.linalg.inv(truths[0])
        return max(
            rot_err_deg(base @ t, tbase @ g) for t, g in zip(tfs, truths)
        )

    def _wrong_bridge_graph(self):
        """All pairs of 8 ring poses; the (3, 4) registration is 20 deg
        wrong and carries the highest confidence, so the max spanning
        tree chains maps 4-7 through it."""
        n = 8
        truths = _ring_truth(n)
        ests = []
        for i in range(n - 1):
            for j in range(i + 1, n):
                if (i, j) == (3, 4):
                    wrong = np.array([0.3, 0, 0, 0, 0, 0.35])
                    ests.append(_edge(truths, j, i, wrong, conf=100.0))
                else:
                    ests.append(_edge(truths, j, i, None,
                                      conf=50.0 if j == i + 1 else 10.0))
        return truths, ests

    def test_wrong_tree_edge_replaced(self):
        truths, ests = self._wrong_bridge_graph()
        seed = compute_global_transforms(ests, 0.0)
        assert self._max_err(seed, truths) > 15.0
        picked = consensus_seed(ests, seed, 0.0)
        assert self._max_err(picked, truths) < 0.1  # float32 arccos floor
        ref = next(i for i, t in enumerate(seed) if np.allclose(t, np.eye(4)))
        np.testing.assert_allclose(picked[ref], np.eye(4), atol=1e-6)

    def test_agreeing_seed_kept(self):
        """Every edge already agrees with the MST seed: nothing to swap."""
        truths = _ring_truth(6)
        ests = [
            _edge(truths, j, i, None, conf=10.0 + i + j)
            for i in range(5) for j in range(i + 1, 6)
        ]
        seed = compute_global_transforms(ests, 0.0)
        picked = consensus_seed(ests, seed, 0.0)
        for a, b in zip(seed, picked):
            np.testing.assert_array_equal(a, b)

    def test_two_maps_and_unregistered_pass_through(self):
        truths = _ring_truth(3)
        ests = [_edge(truths, 1, 0, None, 10.0)]
        seed = compute_global_transforms(ests, 0.0)
        assert consensus_seed(ests, seed, 0.0) is seed
        seed3 = seed + [np.zeros((4, 4), np.float32)]
        assert consensus_seed(ests, seed3, 0.0) is seed3


@pytest.mark.parametrize("graph", ["plain", "kernels"])
def test_recorded_20_map_graph_solves(graph):
    """Pair estimates of the 20-map mesh fixture (bench_fixtures.
    config4_fixture) recorded on an H100, with the Pallas kernels off
    (plain) and on. Only 56 of 190 pairs register correctly; the wrong
    (17, 18) edge outranks the correct edges that join maps 9-17 and
    18-19 to the rest, and the former seed + refinement left maps 9-18
    22 deg off on the plain graph. Every map but 18 (one correct edge
    against a dozen consistent wrong ones) must now land within 1 deg /
    0.1 m of the truth; with the kernels' graph map 18 too."""
    import os

    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.pipeline.merging import _solve_graph

    data = np.load(
        os.path.join(os.path.dirname(__file__), "data",
                     "config4_pair_estimates.npz")
    )
    ests = [
        TransformEstimate(int(s), int(t), m, float(c), bool(a))
        for s, t, m, c, a in zip(
            *(data[graph + k] for k in ("_src", "_tgt", "_T", "_conf", "_amb"))
        )
    ]
    truths = data["truths"]
    out = _solve_graph(ests, MergeParams())
    base, tbase = np.linalg.inv(out[0]), np.linalg.inv(truths[0])
    off = [
        i for i in range(len(truths))
        if rot_err_deg(base @ out[i], tbase @ truths[i]) > 1.0
        or np.linalg.norm((base @ out[i])[:3, 3] - (tbase @ truths[i])[:3, 3])
        > 0.1
    ]
    assert off == ([18] if graph == "plain" else []), off
