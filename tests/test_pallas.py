"""Parity tests for the Pallas kernels (Triton route) in interpret mode.

The compiled kernels run on the GPU only (pallas.use_kernels picks them
there); here the same kernel bodies run through the Pallas interpreter and
are checked against the plain jnp paths and a numpy oracle.
`chip_smoke.py` phase 2 runs the same checks on the card, compiled, at
real widths. Tests marked `gpu` compile the kernels and skip without a
card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mapmerge_tpu.ops.descriptors.fpfh import spfh_tile_plain
from mapmerge_tpu.ops.neighbors import nearest_neighbor
from mapmerge_tpu.pallas import use_kernels
from mapmerge_tpu.pallas.nn import nearest_neighbor_direct, nearest_neighbor_pallas
from mapmerge_tpu.pallas.spfh import spfh_tile_pallas


def _oracle(q, p, mask=None):
    d = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d[:, ~mask] = np.inf
    return d.argmin(1).astype(np.int32), d.min(1)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class TestPallasNN:
    def test_unmasked_parity(self, rng):
        q = (rng.random((300, 3)) * 10).astype(np.float32)
        p = (rng.random((1000, 3)) * 10).astype(np.float32)
        idx, d2 = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), interpret=True
        )
        ref_idx, ref_d2 = _oracle(q, p)
        np.testing.assert_array_equal(np.asarray(idx), ref_idx)
        np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-5, atol=1e-6)

    def test_masked_parity(self, rng):
        q = (rng.random((257, 3)) * 10).astype(np.float32)
        p = (rng.random((3001, 3)) * 10).astype(np.float32)
        mask = rng.random(3001) > 0.4
        idx, d2 = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), interpret=True
        )
        ref_idx, ref_d2 = _oracle(q, p, mask)
        np.testing.assert_array_equal(np.asarray(idx), ref_idx)
        np.testing.assert_allclose(np.asarray(d2), ref_d2, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize(
        "plain", ["matmul_identity", "direct"], ids=["xla_path", "direct"]
    )
    def test_matches_xla_path(self, rng, plain):
        """The kernel agrees with both plain paths: the CPU's centered
        matmul-identity path and the float32 direct-difference reference."""
        q = (rng.random((513, 3)) * 5).astype(np.float32)
        p = (rng.random((2050, 3)) * 5).astype(np.float32)
        mask = rng.random(2050) > 0.2
        idx_p, d2_p = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), interpret=True
        )
        if plain == "direct":
            idx_x, d2_x = nearest_neighbor_direct(
                jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask)
            )
        else:
            idx_x, d2_x, _ = jax.jit(nearest_neighbor)(
                jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask)
            )
        np.testing.assert_array_equal(np.asarray(idx_p), np.asarray(idx_x))
        np.testing.assert_allclose(
            np.asarray(d2_p), np.asarray(d2_x), rtol=1e-4, atol=1e-5
        )

    def test_tie_break_first_occurrence(self):
        # all targets equidistant, across several target tiles
        q = np.zeros((1, 3), np.float32)
        p = np.zeros((300, 3), np.float32)
        idx, d2 = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), tile_p=64, interpret=True
        )
        assert int(idx[0]) == 0
        assert float(d2[0]) == 0.0

    def test_vmap_over_pairs(self, rng):
        q = (rng.random((2, 100, 3)) * 10).astype(np.float32)
        p = (rng.random((2, 400, 3)) * 10).astype(np.float32)
        mask = rng.random((2, 400)) > 0.3
        idx, d2 = jax.vmap(
            lambda a, b, m: nearest_neighbor_pallas(a, b, m, interpret=True)
        )(jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask))
        for b in range(2):
            ref_idx, ref_d2 = _oracle(q[b], p[b], mask[b])
            np.testing.assert_array_equal(np.asarray(idx[b]), ref_idx)
            np.testing.assert_allclose(
                np.asarray(d2[b]), ref_d2, rtol=1e-5, atol=1e-6
            )

    def test_all_masked_targets(self, rng):
        q = (rng.random((10, 3))).astype(np.float32)
        p = (rng.random((100, 3))).astype(np.float32)
        mask = np.zeros(100, bool)
        idx, d2 = nearest_neighbor_pallas(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), interpret=True
        )
        assert np.all(np.asarray(d2) >= 1e11)  # everything at the penalty


class TestPallasSPFH:
    """SPFH sweep kernel (pallas/spfh.py) vs the plain jnp sweep."""

    def _tile(self, rng, b, cq, m):
        q_xyz = rng.uniform(-1, 1, (b, cq, 3)).astype(np.float32)
        cand_xyz = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
        # identical coordinates exercise the zero-distance self-hit
        # exclusion (PCL pairs a point with its neighbors, not itself)
        cand_xyz[:, :cq] = q_xyz
        return (
            q_xyz, _unit(rng, (b, cq, 3)), cand_xyz, _unit(rng, (b, m, 3)),
            rng.uniform(size=(b, m)) > 0.2,
        )

    @pytest.mark.parametrize("block_q, chunk", [(8, 32), (16, 64)])
    def test_parity_vs_xla(self, rng, block_q, chunk):
        r = 0.8
        args = [jnp.asarray(a) for a in self._tile(rng, 2, 16, 160)]
        ref_h, ref_t = spfh_tile_plain(*args, r2=r * r)
        got_h, got_t = spfh_tile_pallas(
            *args, r2=r * r, block_q=block_q, chunk=chunk, interpret=True
        )
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(ref_t))
        # same bin membership: the kernel runs the plain path's arithmetic
        # (a pair exactly on a bin edge could round either way; random
        # data puts none there)
        np.testing.assert_allclose(
            np.asarray(got_h), np.asarray(ref_h), atol=2e-3
        )

    def test_shared_candidates(self, rng):
        """Dense mode: one candidate array (leading dim 1) serves every
        query slab, and query rows beyond a block are padded and dropped."""
        q_xyz, q_nrm, c_xyz, c_nrm, c_ok = self._tile(rng, 3, 24, 200)
        args = [
            jnp.asarray(a)
            for a in (q_xyz, q_nrm, c_xyz[:1], c_nrm[:1], c_ok[:1])
        ]
        ref_h, ref_t = spfh_tile_plain(*args, r2=0.5)
        got_h, got_t = spfh_tile_pallas(
            *args, r2=0.5, block_q=16, chunk=64, interpret=True
        )
        assert got_h.shape == (3, 24, 33) and got_t.shape == (3, 24)
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(ref_t))
        np.testing.assert_allclose(
            np.asarray(got_h), np.asarray(ref_h), atol=2e-3
        )

    def test_chunk_padding_invariance(self, rng):
        B, Cq, M = 1, 8, 100  # M not a chunk multiple -> padding
        q_xyz = rng.uniform(-1, 1, (B, Cq, 3)).astype(np.float32)
        q_nrm = np.tile(
            np.asarray([0.0, 0.0, 1.0], np.float32), (B, Cq, 1)
        )
        cand_xyz = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
        cand_nrm = _unit(rng, (B, M, 3))
        cand_ok = np.ones((B, M), bool)
        args = [
            jnp.asarray(a) for a in (q_xyz, q_nrm, cand_xyz, cand_nrm, cand_ok)
        ]
        a = spfh_tile_pallas(*args, r2=1.0, chunk=32, interpret=True)
        b = spfh_tile_pallas(*args, r2=1.0, chunk=128, interpret=True)
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]))


class TestKernelChoice:
    @pytest.mark.parametrize(
        "platform, expected", [("gpu", True), ("cpu", False)]
    )
    def test_platform_picks_path(self, platform, expected):
        assert use_kernels(platform) is expected

    @pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
    def test_unknown_platform_raises(self, platform):
        with pytest.raises(ValueError, match="no kernel route"):
            use_kernels(platform)

    def test_cpu_run_never_picks_the_kernel(self, rng, monkeypatch):
        """On the CPU backend the dispatch takes the plain path: the
        compiled kernel entry point is never called."""
        import mapmerge_tpu.pallas.nn as nn

        assert jax.default_backend() == "cpu" and not use_kernels()

        def boom(*a, **k):
            raise AssertionError("kernel called on the CPU")

        monkeypatch.setattr(nn, "nearest_neighbor_pallas", boom)
        q = jnp.asarray(rng.random((20, 3)), jnp.float32)
        idx, _, _ = nearest_neighbor(q, q)
        np.testing.assert_array_equal(np.asarray(idx), np.arange(20))


@pytest.mark.gpu
def test_compiled_kernels_match_plain_on_gpu(rng):
    """The compiled kernels (no interpreter) agree with the plain paths."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels run on CUDA only")
    q = jnp.asarray(rng.random((4096, 3)) * 10, jnp.float32)
    p = jnp.asarray(rng.random((5000, 3)) * 10, jnp.float32)
    idx, d2 = nearest_neighbor_pallas(q, p)
    ref_idx, ref_d2 = nearest_neighbor_direct(q, p)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(ref_d2), rtol=1e-5)
    assert np.mean(np.asarray(idx) == np.asarray(ref_idx)) > 0.999
    args = [jnp.asarray(a) for a in TestPallasSPFH()._tile(rng, 4, 128, 3456)]
    got_h, got_t = spfh_tile_pallas(*args, r2=0.64)
    ref_h, ref_t = spfh_tile_plain(*args, r2=0.64)
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(ref_t))
    np.testing.assert_allclose(np.asarray(got_h), np.asarray(ref_h), atol=2e-3)
    # descriptor matching at 1024 slots and a bare transposed top_k, as
    # chip_smoke's phase 2 checks them (XLA's GPU top_k over a masked,
    # transposed matrix has returned wrong indices)
    import chip_smoke

    chip_smoke.run_matching()
