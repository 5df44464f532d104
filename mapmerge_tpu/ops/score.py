"""Transform validation score.

JAX equivalent of pcl::registration::TransformationValidationEuclidean
as used by the reference (src/matching.cpp:259-268): mean squared
nearest-neighbor distance from the transformed source cloud to the target,
counting only pairs closer than `max_range`; returns a huge score when no
pair qualifies (PCL returns max double). Confidence = 1 / score
(map_merging.cpp:265-268).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.neighbors import nearest_neighbor

MAX_SCORE = 1.0e30


def transform_score(
    source: PointCloud,
    target: PointCloud,
    transform: jax.Array,
    max_range: float,
    tile: int = 1024,
    scan_cap: int = 256,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (score, coverage, scan_overflow).

    score: mean-square bounded NN distance, exactly the reference metric
    (lower is better; MAX_SCORE when nothing is in range).
    coverage: fraction of valid source points whose NN lands within
    max_range — the quantity PCL's validator silently drops by *excluding*
    out-of-range points. A grossly wrong transform can ace the score with
    5%% of points grazing a floor plane; coverage exposes it.
    scan_overflow: moved-source query points the grid engine dropped at
    its query-side bucket cap (counted out of the score as unmatched);
    0 on the dense path. Callers surface it (no silent caps).
    """
    moved = tf.apply(transform, source.xyz)
    # bound = max_range: out-of-range matches are excluded below anyway,
    # and the bound lets large targets take the hash-grid path
    _, d2, overflow = nearest_neighbor(
        moved, target.xyz, p_mask=target.mask, tile=tile,
        bound=float(max_range), scan_cap=scan_cap, q_mask=source.mask,
    )
    within = source.mask & (d2 <= jnp.float32(max_range * max_range))
    num = jnp.sum(jnp.where(within, d2, 0.0))
    cnt = jnp.sum(within)
    total = jnp.maximum(jnp.sum(source.mask), 1)
    score = jnp.where(cnt > 0, num / jnp.maximum(cnt, 1), MAX_SCORE)
    coverage = cnt / total
    return score, coverage, overflow


def confidence(
    score: jax.Array, coverage: jax.Array | None = None
) -> jax.Array:
    """Edge confidence for the merge graph.

    Reference semantics: 1 / score (map_merging.cpp:265-268). With
    `coverage` given, the robust variant coverage^2 / score is returned —
    false low-overlap alignments (high 1/score, tiny coverage) then rank
    below genuine edges in the max-spanning-tree instead of poisoning it.
    """
    inv = 1.0 / jnp.maximum(score, 1.0 / MAX_SCORE)
    if coverage is None:
        return inv
    return inv * coverage * coverage
