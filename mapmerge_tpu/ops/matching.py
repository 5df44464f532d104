"""Descriptor correspondence matching.

JAX equivalent of the reference's reciprocal k-NN cross-match
(map_merge_3d/src/matching.cpp:31-93): instead of two kd-trees over up to
1980-d descriptors, the full (S, T) squared-distance matrix is computed on
one matmul, top-k is taken both ways, and the reference's first-match-wins
reciprocal rule is evaluated as a masked reduction:

  for source i, walk its k nearest targets in ascending-distance order and
  accept the FIRST target j whose own k nearest sources include i
  (matching.cpp:65-90 — one match per source point, because PCL's RANSAC
  model cannot handle multiple matches per point).

Returns a fixed-shape correspondence set aligned with the source axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

BIG = 1.0e12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Correspondences:
    """Padded correspondence set, one slot per source keypoint.

    Mirrors pcl::Correspondences (typedefs.h:32-33) with fixed shape:
    target[i] is the matched target index for source i, distance[i] the
    squared descriptor distance, valid[i] whether a reciprocal match exists.
    """

    target: jax.Array  # (S,) int32
    distance: jax.Array  # (S,) float32 (squared descriptor distance)
    valid: jax.Array  # (S,) bool

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid)


def descriptor_sq_dists(
    a: jax.Array, b: jax.Array, precision=jax.lax.Precision.HIGHEST
) -> jax.Array:
    """(S, D) x (T, D) -> (S, T) squared L2 distances via one matmul."""
    aa = jnp.sum(a * a, axis=-1, keepdims=True)
    bb = jnp.sum(b * b, axis=-1, keepdims=True)
    ab = jnp.dot(a, b.T, precision=precision, preferred_element_type=jnp.float32)
    return jnp.maximum(aa + bb.T - 2.0 * ab, 0.0)


def find_correspondences(
    source_desc: jax.Array,
    target_desc: jax.Array,
    k: int,
    source_valid: jax.Array | None = None,
    target_valid: jax.Array | None = None,
) -> Correspondences:
    """Reciprocal k-NN cross-matching (reference matching.cpp:31-93).

    Args:
      source_desc: (S, D) source descriptors.
      target_desc: (T, D) target descriptors.
      k: neighbors considered each way (params.matching_k, default 5).
      source_valid/target_valid: validity masks for padded slots.
    """
    s = source_desc.shape[0]
    t = target_desc.shape[0]
    k_eff = min(k, t)

    def masked_d2(a, b, a_valid, b_valid):
        d2 = descriptor_sq_dists(a, b)
        if b_valid is not None:
            d2 = jnp.where(b_valid[None, :], d2, BIG)
        if a_valid is not None:
            d2 = jnp.where(a_valid[:, None], d2, BIG)
        return d2

    # forward: k nearest targets per source (ascending)
    d2 = masked_d2(source_desc, target_desc, source_valid, target_valid)
    neg_fwd, fwd_idx = jax.lax.top_k(-d2, k_eff)  # (S, k)
    fwd_d2 = -neg_fwd
    # backward: k nearest sources per target, from the (T, S) distances
    # computed as such: XLA's GPU top_k over the transposed (S, T) matrix
    # (top_k(-d2.T)) returned wrong indices at 1024 x 1024
    d2_back = masked_d2(target_desc, source_desc, target_valid, source_valid)
    _, back_idx = jax.lax.top_k(-d2_back, k_eff)  # (T, k)

    # reciprocal test: is i among back_idx[fwd_idx[i, j]] ?
    back_of_fwd = back_idx[fwd_idx]  # (S, k, k)
    src_ids = jnp.arange(s, dtype=back_idx.dtype)[:, None, None]
    reciprocal = jnp.any(back_of_fwd == src_ids, axis=-1)  # (S, k)
    reciprocal = reciprocal & (fwd_d2 < BIG / 2)

    # first-match-wins: earliest j slot with a reciprocal hit
    first = jnp.argmax(reciprocal, axis=-1)  # (S,)
    any_hit = jnp.any(reciprocal, axis=-1)
    target = jnp.take_along_axis(fwd_idx, first[:, None], axis=-1)[:, 0]
    dist = jnp.take_along_axis(fwd_d2, first[:, None], axis=-1)[:, 0]

    valid = any_hit
    if source_valid is not None:
        valid = valid & source_valid
    return Correspondences(
        target=target.astype(jnp.int32),
        distance=jnp.where(valid, dist, BIG).astype(jnp.float32),
        valid=valid,
    )
