"""SAC-IA: sample-consensus initial alignment.

JAX equivalent of pcl::SampleConsensusInitialAlignment as configured
by the reference (src/matching.cpp:142-194, 242-247):
  - min_sample_distance = inlier_threshold,
  - max_correspondence_distance, max_iterations from params.

PCL draws one sample triple per sequential iteration; here all
`num_iterations` hypotheses are drawn, solved and scored in one batched
program:
  1. per source keypoint, the k nearest target keypoints in DESCRIPTOR
     space are precomputed (one matmul distance matrix + top-k);
  2. each hypothesis samples 3 distinct source keypoints (Gumbel top-k),
     enforcing PCL's minimum pairwise sample distance by invalidating
     violating hypotheses instead of resampling;
  3. each sampled keypoint picks one of its k feature matches uniformly at
     random (PCL's findSimilarFeatures + random pick);
  4. 3-point Kabsch per hypothesis, scored by the truncated-error metric
     (sum of min(nn_dist, max_correspondence_distance) over all source
     keypoints) — PCL's default error functor;
  5. argmin over hypotheses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.matching import descriptor_sq_dists
from mapmerge_tpu.ops.rigid import kabsch

_BIG = 1.0e12
_K_FEATURES = 10  # PCL k_correspondences_ default


def sacia_transform(
    source_kp: Keypoints,
    source_desc: Descriptors,
    target_kp: Keypoints,
    target_desc: Descriptors,
    min_sample_distance: float,
    max_correspondence_distance: float,
    num_iterations: int,
    key: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (transform (4,4), ok (), proxy inlier count ())."""
    s_valid = source_kp.mask & source_desc.valid
    t_valid = target_kp.mask & target_desc.valid
    s = source_kp.xyz.shape[0]

    # 1. feature-space k-NN (source -> target)
    d2f = descriptor_sq_dists(source_desc.data, target_desc.data)
    d2f = jnp.where(t_valid[None, :], d2f, _BIG)
    d2f = jnp.where(s_valid[:, None], d2f, _BIG)
    k_eff = min(_K_FEATURES, target_desc.data.shape[0])
    _, feat_nn = jax.lax.top_k(-d2f, k_eff)  # (S, k)

    key_samples, key_pick = jax.random.split(key)

    # 2. sample 3 distinct valid source keypoints per hypothesis
    g = jax.random.gumbel(key_samples, (num_iterations, s))
    g = jnp.where(s_valid[None, :], g, -_BIG)
    _, samples = jax.lax.top_k(g, 3)  # (H, 3)
    sample_valid = jnp.all(s_valid[samples], axis=-1)

    src_pts = source_kp.xyz[samples]  # (H, 3, 3)
    # minimum pairwise sample distance (PCL selectSamples retry loop)
    pd2 = jnp.sum(
        (src_pts[:, :, None, :] - src_pts[:, None, :, :]) ** 2, axis=-1
    )
    eye = jnp.eye(3, dtype=bool)
    min_ok = jnp.all(
        (pd2 >= min_sample_distance * min_sample_distance) | eye[None],
        axis=(-2, -1),
    )

    # 3. pick one of the k feature matches per sampled keypoint
    pick = jax.random.randint(key_pick, samples.shape, 0, k_eff)  # (H, 3)
    match_idx = jnp.take_along_axis(
        feat_nn[samples], pick[..., None], axis=-1
    )[..., 0]  # (H, 3)
    dst_pts = target_kp.xyz[match_idx]

    # 4. solve + score
    hyp_t, hyp_ok = kabsch(src_pts, dst_pts, jnp.ones(samples.shape, jnp.float32))
    hyp_ok = hyp_ok & sample_valid & min_ok

    # score in hypothesis chunks to bound the (chunk, S, T) slab
    tgt = target_kp.xyz
    tt = jnp.sum(tgt * tgt, axis=-1)  # (T,)

    def score_chunk(t_chunk):
        moved = tf.apply(t_chunk, source_kp.xyz)  # (h, S, 3)
        mm = jnp.sum(moved * moved, axis=-1)  # (h, S)
        cross = jnp.einsum(
            "hsi,ti->hst", moved, tgt,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = jnp.maximum(mm[..., None] + tt[None, None, :] - 2.0 * cross, 0.0)
        d2 = jnp.where(t_valid[None, None, :], d2, _BIG)
        nn = jnp.sqrt(jnp.min(d2, axis=-1))  # (h, S)
        trunc = jnp.minimum(nn, max_correspondence_distance)
        err = jnp.sum(jnp.where(s_valid[None, :], trunc, 0.0), axis=-1)
        inl = jnp.sum(
            (nn < max_correspondence_distance) & s_valid[None, :], axis=-1
        ).astype(jnp.int32)
        return err, inl

    chunk = 32
    pad_h = (-num_iterations) % chunk
    hyp_t_p = jnp.concatenate(
        [hyp_t, jnp.tile(jnp.eye(4, dtype=jnp.float32), (pad_h, 1, 1))]
    ) if pad_h else hyp_t
    err, inl = jax.lax.map(
        score_chunk, hyp_t_p.reshape(-1, chunk, 4, 4)
    )
    err = err.reshape(-1)[:num_iterations]
    inl = inl.reshape(-1)[:num_iterations]
    err = jnp.where(hyp_ok, err, _BIG)

    # 5. best hypothesis
    best = jnp.argmin(err)
    ok = hyp_ok[best]
    transform = jnp.where(ok, hyp_t[best], tf.zero())
    return transform, ok, jnp.where(ok, inl[best], 0)
