"""Batched-hypothesis RANSAC over correspondences.

JAX equivalent of pcl::registration::CorrespondenceRejectorSampleConsensus
+ TransformationEstimationSVD re-estimation (reference
src/matching.cpp:110-140). PCL iterates hypotheses sequentially with early
exit; here ALL hypotheses are drawn, solved (closed-form 3-point Kabsch,
ops/rigid.py) and scored in one vmapped program — argmax replaces the
sequential loop (SURVEY.md §2c "hypothesis parallel").

Failure is signalled exactly like the reference: a zero 4x4 and an empty
inlier set (matching.cpp:128-133 detects PCL's identity-transform sentinel;
we use an explicit ok flag plus the zero matrix in-band).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.ops.matching import Correspondences
from mapmerge_tpu.ops.rigid import kabsch

_NEG = -1.0e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RansacResult:
    transform: jax.Array  # (4, 4) float32; zeros when not ok
    inliers: jax.Array  # (S,) bool inlier mask over source slots
    inlier_count: jax.Array  # () int32
    ok: jax.Array  # () bool
    #: consensus purity: the fraction of COMPETITIVE hypotheses (inlier
    #: support >= 85% of the winner's) whose pose AGREES with the winner
    #: (within 2x the inlier threshold translation and 10 deg rotation).
    #: Minimal 3-point samples scatter around the true pose by about the
    #: inlier threshold, so a well-constrained pair has most competitive
    #: hypotheses agreeing (purity near 1); an ambiguous pair (e.g.
    #: floor-dominated overlap, where translation along the plane is
    #: unconstrained) supports materially DIFFERENT poses with equal
    #: inlier mass — purity drops. Used by the ambiguity flag
    #: (pipeline/registration.py); 1 when not ok (no evidence of
    #: ambiguity from a failed estimate — failure is its own signal).
    consensus_purity: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.ones((), jnp.float32)
    )
    #: raw diagnostics behind the purity: worst pose deviation from the
    #: winner among competitive hypotheses (deg / m); 0 when not ok
    spread_deg: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.float32)
    )
    spread_m: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.float32)
    )


def _sample_hypotheses(
    key: jax.Array, valid: jax.Array, num_hypotheses: int, sample_size: int = 3
) -> jax.Array:
    """(H, sample_size) indices of distinct valid correspondences.

    Gumbel top-k: per hypothesis take the top-`sample_size` of iid Gumbel
    noise restricted to valid slots — an exact uniform sample without
    replacement, fully parallel across hypotheses.
    """
    s = valid.shape[0]
    g = jax.random.gumbel(key, (num_hypotheses, s))
    g = jnp.where(valid[None, :], g, _NEG)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx.astype(jnp.int32)


def ransac_transform(
    source_kp: jax.Array,
    target_kp: jax.Array,
    corr: Correspondences,
    inlier_threshold: float,
    num_hypotheses: int,
    key: jax.Array,
) -> RansacResult:
    """Estimate T (source -> target) from putative correspondences.

    Reference contract (matching.cpp:110-140): RANSAC inlier selection at
    `inlier_threshold` euclidean distance, SVD re-estimation on the inlier
    set, zero matrix + empty inliers on failure.
    """
    src = source_kp[jnp.arange(corr.target.shape[0])]  # (S, 3) aligned slots
    dst = target_kp[corr.target]  # (S, 3) matched targets
    valid = corr.valid
    thr2 = jnp.float32(inlier_threshold * inlier_threshold)

    samples = _sample_hypotheses(key, valid, num_hypotheses)  # (H, 3)
    src_s = src[samples]  # (H, 3, 3)
    dst_s = dst[samples]
    # a sample is usable only if all three drawn slots were valid
    sample_ok = jnp.all(valid[samples], axis=-1)  # (H,)

    hyp_t, hyp_ok = kabsch(src_s, dst_s, jnp.ones(samples.shape, jnp.float32))
    hyp_ok = hyp_ok & sample_ok

    # score every hypothesis against every correspondence
    moved = tf.apply(hyp_t, src)  # (H, S, 3)
    resid2 = jnp.sum((moved - dst[None]) ** 2, axis=-1)  # (H, S)
    inlier_mat = (resid2 <= thr2) & valid[None, :]
    counts = jnp.sum(inlier_mat, axis=-1).astype(jnp.int32)  # (H,)
    counts = jnp.where(hyp_ok, counts, -1)

    best = jnp.argmax(counts)
    best_count = counts[best]
    best_inliers = inlier_mat[best]

    # SVD re-estimation on the winning inlier set (matching.cpp:135-137)
    refit_t, refit_ok = kabsch(src, dst, best_inliers.astype(jnp.float32))

    ok = (best_count >= 3) & refit_ok

    # ambiguity signal: consensus purity of the near-best hypothesis set.
    # All hypotheses are already solved and scored (the batched design
    # gives this for free where PCL's sequential early-exit loop could
    # not). Competitive = within max(2, 15% of best) inliers of the
    # winner: the absolute slack matters when consensus is thin (a
    # floor-on-floor pair wins with ~5 accidental inliers and dozens of
    # 3-4-inlier hypotheses at scattered poses are statistically
    # indistinguishable from it). Agreement is judged by DATA
    # DISPLACEMENT, not parameter distance: two transforms are the same
    # answer iff they move the winning consensus points to (nearly) the
    # same places — rms displacement over the winner's inliers <= 2x the
    # inlier threshold, the resolution at which inlier counting can
    # distinguish poses at all. (Parameter-space tolerances mis-scale
    # with scene size: a 10-deg tolerance is generous on a wide scan and
    # hopeless on a compact one.)
    bc = jnp.maximum(best_count, 1).astype(jnp.float32)
    slack = jnp.maximum(2.0, 0.15 * bc)
    competitive = hyp_ok & (counts.astype(jnp.float32) >= bc - slack)
    n_inl = jnp.maximum(jnp.sum(best_inliers), 1).astype(jnp.float32)
    disp2 = jnp.sum(
        jnp.where(
            best_inliers[None, :, None],
            (moved - moved[best][None]) ** 2,
            0.0,
        ),
        axis=(1, 2),
    ) / n_inl  # (H,) mean-square displacement over the consensus set
    agree = competitive & (
        disp2 <= jnp.float32((2.0 * inlier_threshold) ** 2)
    )
    n_comp = jnp.sum(competitive)
    purity = jnp.sum(agree) / jnp.maximum(n_comp, 1)
    # raw diagnostics: worst parameter-space deviation among competitive
    best_t = hyp_t[best]  # (4, 4)
    rel_rot = jnp.einsum("ij,hkj->hik", best_t[:3, :3], hyp_t[:, :3, :3])
    tr = rel_rot[:, 0, 0] + rel_rot[:, 1, 1] + rel_rot[:, 2, 2]
    rot_dev = jnp.degrees(
        jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    )
    trans_dev = jnp.linalg.norm(hyp_t[:, :3, 3] - best_t[:3, 3], axis=-1)
    spread_deg = jnp.max(jnp.where(competitive, rot_dev, 0.0))
    spread_m = jnp.max(jnp.where(competitive, trans_dev, 0.0))

    transform = jnp.where(ok, refit_t, tf.zero())
    inliers = best_inliers & ok
    return RansacResult(
        transform=transform,
        inliers=inliers,
        inlier_count=jnp.where(ok, jnp.sum(inliers), 0).astype(jnp.int32),
        ok=ok,
        consensus_purity=jnp.where(ok, purity, 1.0).astype(jnp.float32),
        spread_deg=jnp.where(ok, spread_deg, 0.0),
        spread_m=jnp.where(ok, spread_m, 0.0),
    )
