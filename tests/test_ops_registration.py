"""Rigid alignment, matching, and RANSAC kernels vs oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.ops.matching import Correspondences, find_correspondences
from mapmerge_tpu.ops.ransac import ransac_transform
from mapmerge_tpu.ops.rigid import kabsch


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


class TestKabsch:
    def test_exact_recovery(self, rng):
        src = rng.normal(size=(50, 3)).astype(np.float32)
        r = random_rotation(rng)
        t = rng.normal(size=3).astype(np.float32)
        dst = src @ r.T + t
        est, ok = kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.ones(50))
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(tf.rotation(est)), r, atol=1e-4)
        np.testing.assert_allclose(np.asarray(tf.translation(est)), t, atol=1e-4)

    def test_three_point_sample(self, rng):
        # the RANSAC case: exactly 3 pairs (rank-2 cross-covariance)
        src = rng.normal(size=(3, 3)).astype(np.float32)
        r = random_rotation(rng)
        t = np.array([1.0, -2.0, 0.5], np.float32)
        dst = src @ r.T + t
        est, ok = kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.ones(3))
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(tf.apply(est, src)), dst, atol=1e-3
        )
        assert float(jnp.linalg.det(tf.rotation(est))) == pytest.approx(1.0, abs=1e-4)

    def test_weighted_ignores_outliers(self, rng):
        src = rng.normal(size=(40, 3)).astype(np.float32)
        r = random_rotation(rng)
        dst = src @ r.T
        dst_corrupt = dst.copy()
        dst_corrupt[30:] += 100.0  # gross outliers
        w = np.ones(40, np.float32)
        w[30:] = 0.0
        est, ok = kabsch(jnp.asarray(src), jnp.asarray(dst_corrupt), jnp.asarray(w))
        assert bool(ok)
        np.testing.assert_allclose(np.asarray(tf.rotation(est)), r, atol=1e-4)

    def test_batched(self, rng):
        src = rng.normal(size=(8, 3, 3)).astype(np.float32)
        rs = np.stack([random_rotation(rng) for _ in range(8)])
        dst = np.einsum("bij,bnj->bni", rs, src)
        est, ok = kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.ones((8, 3)))
        assert np.asarray(ok).all()
        np.testing.assert_allclose(np.asarray(tf.rotation(est)), rs, atol=1e-3)

    def test_collinear_degenerate(self):
        src = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
        est, ok = kabsch(jnp.asarray(src), jnp.asarray(src), jnp.ones(3))
        assert not bool(ok)

    def test_too_few_points(self):
        src = np.array([[0, 0, 0], [1, 0, 0]], np.float32)
        _, ok = kabsch(jnp.asarray(src), jnp.asarray(src), jnp.ones(2))
        assert not bool(ok)


class TestMatching:
    def test_identity_descriptors_match(self, rng):
        desc = rng.normal(size=(30, 16)).astype(np.float32)
        perm = rng.permutation(30)
        corr = find_correspondences(
            jnp.asarray(desc), jnp.asarray(desc[perm]), k=5
        )
        valid = np.asarray(corr.valid)
        target = np.asarray(corr.target)
        assert valid.all()
        # each source must map to the slot holding its own descriptor
        inv = np.argsort(perm)
        np.testing.assert_array_equal(target, inv)

    def test_reciprocal_oracle(self, rng):
        """Match the reference's first-match-wins loop exactly (matching.cpp:65-90)."""
        s_desc = rng.normal(size=(25, 8)).astype(np.float32)
        t_desc = rng.normal(size=(20, 8)).astype(np.float32)
        k = 4
        d2 = ((s_desc[:, None] - t_desc[None]) ** 2).sum(-1)
        fwd = np.argsort(d2, axis=1, kind="stable")[:, :k]
        back = np.argsort(d2.T, axis=1, kind="stable")[:, :k]
        oracle = {}
        for i in range(25):
            for j in fwd[i]:
                if i in back[j]:
                    oracle[i] = j
                    break
        corr = find_correspondences(jnp.asarray(s_desc), jnp.asarray(t_desc), k=k)
        valid = np.asarray(corr.valid)
        target = np.asarray(corr.target)
        for i in range(25):
            if i in oracle:
                assert valid[i] and target[i] == oracle[i], i
            else:
                assert not valid[i], i

    def test_reciprocal_oracle_at_capacity(self, rng):
        """The same oracle at the fleet configs' padded keypoint capacity
        (1024 slots, ~60% valid), jitted: the shape at which XLA's GPU
        top_k over a transposed distance matrix returned wrong indices."""
        n, k = 1024, 5
        s_desc = rng.normal(size=(n, 33)).astype(np.float32)
        t_desc = (s_desc + 0.3 * rng.normal(size=(n, 33))).astype(np.float32)
        sv = rng.random(n) < 0.6
        tv = rng.random(n) < 0.6
        d2 = ((s_desc[:, None].astype(np.float64) - t_desc[None]) ** 2).sum(-1)
        d2 = np.where(sv[:, None] & tv[None], d2, np.inf)
        fwd = np.argsort(d2, axis=1, kind="stable")[:, :k]
        back = np.argsort(d2.T, axis=1, kind="stable")[:, :k]
        corr = jax.jit(find_correspondences, static_argnames=("k",))(
            jnp.asarray(s_desc), jnp.asarray(t_desc), k=k,
            source_valid=jnp.asarray(sv), target_valid=jnp.asarray(tv),
        )
        valid = np.asarray(corr.valid)
        target = np.asarray(corr.target)
        n_match = 0
        for i in np.nonzero(sv)[0]:
            hit = next((j for j in fwd[i] if tv[j] and i in back[j]), None)
            assert valid[i] == (hit is not None), i
            if hit is not None:
                assert target[i] == hit, i
                n_match += 1
        assert not valid[~sv].any()
        assert n_match > 0.5 * sv.sum()

    def test_masked_slots_excluded(self, rng):
        s_desc = rng.normal(size=(10, 4)).astype(np.float32)
        t_desc = rng.normal(size=(10, 4)).astype(np.float32)
        sv = np.ones(10, bool); sv[7:] = False
        tv = np.ones(10, bool); tv[5:] = False
        corr = find_correspondences(
            jnp.asarray(s_desc), jnp.asarray(t_desc), k=3,
            source_valid=jnp.asarray(sv), target_valid=jnp.asarray(tv),
        )
        valid = np.asarray(corr.valid)
        assert not valid[7:].any()
        assert (np.asarray(corr.target)[valid] < 5).all()


class TestRansac:
    def _make_problem(self, rng, n=60, outlier_frac=0.3, noise=0.0):
        src = (rng.random((n, 3)) * 4 - 2).astype(np.float32)
        r = random_rotation(rng)
        t = np.array([0.5, -1.0, 2.0], np.float32)
        dst = src @ r.T + t
        if noise:
            dst += rng.normal(size=dst.shape).astype(np.float32) * noise
        n_out = int(n * outlier_frac)
        idx = rng.choice(n, n_out, replace=False)
        dst[idx] += (rng.random((n_out, 3)) * 10 + 3).astype(np.float32)
        truth = tf.from_rotation_translation(r, t)
        corr = Correspondences(
            target=jnp.arange(n, dtype=jnp.int32),
            distance=jnp.zeros(n),
            valid=jnp.ones(n, bool),
        )
        return jnp.asarray(src), jnp.asarray(dst), corr, truth, idx

    def test_recovers_under_outliers(self, rng):
        src, dst, corr, truth, outliers = self._make_problem(rng)
        res = ransac_transform(
            src, dst, corr, inlier_threshold=0.05, num_hypotheses=256,
            key=jax.random.key(0),
        )
        assert bool(res.ok)
        assert float(tf.rotation_geodesic_deg(res.transform, truth)) < 0.5
        assert float(tf.translation_error(res.transform, truth)) < 0.02
        inl = np.asarray(res.inliers)
        assert not inl[outliers].any()

    def test_failure_on_garbage(self, rng):
        src = jnp.asarray(rng.random((30, 3)).astype(np.float32))
        dst = jnp.asarray((rng.random((30, 3)) * 50).astype(np.float32))
        corr = Correspondences(
            target=jnp.arange(30, dtype=jnp.int32),
            distance=jnp.zeros(30),
            valid=jnp.ones(30, bool),
        )
        res = ransac_transform(
            src, dst, corr, inlier_threshold=1e-4, num_hypotheses=128,
            key=jax.random.key(1),
        )
        # zero matrix signals failure (reference matching.cpp:128-133)
        assert not bool(res.ok)
        assert bool(tf.is_zero(res.transform))
        assert int(res.inlier_count) == 0

    def test_too_few_correspondences(self, rng):
        src = jnp.asarray(rng.random((10, 3)).astype(np.float32))
        dst = src
        valid = np.zeros(10, bool); valid[:2] = True
        corr = Correspondences(
            target=jnp.arange(10, dtype=jnp.int32),
            distance=jnp.zeros(10),
            valid=jnp.asarray(valid),
        )
        res = ransac_transform(
            src, dst, corr, inlier_threshold=0.1, num_hypotheses=64,
            key=jax.random.key(2),
        )
        assert not bool(res.ok)

    def test_jittable(self, rng):
        src, dst, corr, truth, _ = self._make_problem(rng)
        f = jax.jit(
            lambda s, d, c, k: ransac_transform(
                s, d, c, inlier_threshold=0.05, num_hypotheses=256, key=k
            )
        )
        res = f(src, dst, corr, jax.random.key(0))
        assert bool(res.ok)
