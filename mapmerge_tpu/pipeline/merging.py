"""High-level N-map merging API.

Equivalent of the reference's L3 interface (map_merge_3d/src/map_merging.cpp,
include/map_merge_3d/map_merging.h): estimate_maps_transforms + compose_maps
with the same contracts —
  empty input -> [];  single cloud -> [identity];
  per-map failure -> zero matrix (map_merging.h:81-84);
  compose skips zero transforms and re-voxelizes at output resolution
  (map_merging.cpp:277-305);
  transforms list sized by the highest node index seen in pairwise estimates
  (map_merging.cpp:167), like the reference.

Architecture difference (batched): the reference runs four sequential
per-cloud loops then a sequential O(N^2) pair loop; here the feature stage is
one vmapped program over the stacked cloud batch and ALL pairs register in a
single batched program (vmap over the pair axis — shard_map over a device
mesh drops in on the same axis, see parallel/pair_shard.py).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mapmerge_tpu.core.cloud import PointCloud, stack_clouds
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.graph.merge_graph import (
    TransformEstimate,
    compute_global_transforms,
)
from mapmerge_tpu.ops.downsample import voxel_downsample
from mapmerge_tpu.core import transforms as tf
from mapmerge_tpu.pipeline.features import CloudFeatures, extract_features
from mapmerge_tpu.pipeline.registration import estimate_transform


@partial(jax.jit, static_argnames=("params",))
def extract_features_batch(batch: PointCloud, params: MergeParams):
    """Per-cloud feature stage over a stacked (B, N, ...) batch.

    lax.map (sequential scan of the unbatched program), NOT vmap: one
    cloud's feature stage already fills the device (tiled 32k-point
    dense neighbor passes), and batched top_k/sort/scatter lowered much
    worse than their unbatched forms on the earlier accelerator (not
    measured on the H100). Cross-cloud parallelism belongs on the mesh
    axis (parallel/pair_shard.py), not in the batcher.
    """
    return jax.lax.map(lambda c: extract_features(c, params), batch)


def _gather_pair(features: CloudFeatures, idx: jax.Array) -> CloudFeatures:
    return jax.tree_util.tree_map(lambda a: a[idx], features)


@partial(jax.jit, static_argnames=("params",))
def estimate_pairs_batch(
    features: CloudFeatures,
    src_idx: jax.Array,
    tgt_idx: jax.Array,
    params: MergeParams,
    keys: jax.Array,
):
    """Register all (src, tgt) pairs in one batched program.

    lax.map over the pair axis for the same reason as
    extract_features_batch: each pair's registration (dense NN over full
    clouds inside ICP) saturates the chip, and the unbatched program is
    several times faster than its vmapped form; per-pair while_loops also
    converge individually instead of in masked lockstep.
    """

    def one(args):
        si, ti, key = args
        return estimate_transform(
            _gather_pair(features, si), _gather_pair(features, ti), params, key
        )

    return jax.lax.map(one, (src_idx, tgt_idx, keys))


@partial(jax.jit, static_argnames=("params", "n"))
def _merge_all_pairs_fused(batch: PointCloud, params: MergeParams, n: int,
                           seed: jax.Array):
    """ONE program: features for all `n` clouds + registration of all
    C(n,2) pairs + every small output packed into a single f32 vector.

    Rationale: the unfused path pays one dispatch + one fetch per stage
    (features, keypoint counts, pairs, transforms, overflow warnings);
    fusing the whole small-config merge means one dispatch and one fetch.
    Whether that still pays on the H100 is not measured yet.

    Pairs are registered UNCONDITIONALLY (the reference skips pairs whose
    keypoint sets are empty, map_merging.cpp:246-254); the caller drops
    those estimates after the fetch using the packed keypoint counts, so
    reference semantics are preserved exactly — an empty-keypoint pair
    costs only wasted compute, and only when such a cloud exists.
    """
    features = jax.lax.map(lambda c: extract_features(c, params), batch)
    pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, n)]
    src_idx = jnp.asarray([p[0] for p in pairs], jnp.int32)
    tgt_idx = jnp.asarray([p[1] for p in pairs], jnp.int32)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(seed), jnp.arange(len(pairs))
    )

    def one(args):
        si, ti, key = args
        return estimate_transform(
            _gather_pair(features, si), _gather_pair(features, ti), params,
            key,
        )

    est = jax.lax.map(one, (src_idx, tgt_idx, keys))
    kp_counts = jnp.sum(features.keypoints.mask, axis=-1)
    p = len(pairs)
    packed = jnp.concatenate(
        [
            est.transform.reshape(p, 16).reshape(-1),
            est.confidence.astype(jnp.float32),
            est.scan_overflow.astype(jnp.float32),
            # raw ambiguity evidence (coverage, consensus purity, inlier
            # support); the FLAG is computed host-side so threshold
            # recalibration never invalidates this compiled program
            est.coverage.astype(jnp.float32),
            est.consensus_purity.astype(jnp.float32),
            est.support.astype(jnp.float32),
            kp_counts.astype(jnp.float32),
            features.dropped_points.astype(jnp.float32),
            features.scan_overflow.astype(jnp.float32),
            features.keypoints.truncated.astype(jnp.float32),
        ]
    )
    return packed


def _fetch(x) -> np.ndarray:
    """Device array -> host numpy, multi-process safe.

    Arrays sharded over a multi-host mesh span non-addressable devices;
    np.asarray raises there — gather them to every host first (the cross-host
    collective the SURVEY §2c graph-reduction row calls for)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _warn_dropped(features: CloudFeatures) -> None:
    """Surface voxel-grid overflow (geometry silently lost to `max_points`)
    as a warning — the no-silent-caps contract."""
    _warn_dropped_np(
        _fetch(features.dropped_points),
        _fetch(features.scan_overflow),
        _fetch(features.keypoints.truncated),
    )


def _warn_dropped_np(
    dropped: np.ndarray,
    scan_overflow: np.ndarray,
    kp_truncated: np.ndarray | None = None,
) -> None:
    """Per-cloud feature-stage cap warnings over fetched numpy counters."""
    import warnings

    if dropped.sum() > 0:
        per_cloud = ", ".join(
            f"cloud {i}: {int(d)}" for i, d in enumerate(dropped) if d > 0
        )
        warnings.warn(
            "voxel grid overflowed max_points and dropped valid points "
            f"({per_cloud}); raise MergeParams.max_points or coarsen "
            "resolution to keep all geometry",
            stacklevel=3,
        )
    if scan_overflow.max(initial=0) > 0:
        warnings.warn(
            "grid neighbor engine: fullest hash bucket exceeds "
            f"grid_scan_cap by {int(scan_overflow.max())} points — neighbor "
            "queries may be truncated; raise MergeParams.grid_scan_cap",
            stacklevel=3,
        )
    if kp_truncated is not None and kp_truncated.sum() > 0:
        per_cloud = ", ".join(
            f"cloud {i}: {int(d)}"
            for i, d in enumerate(np.atleast_1d(kp_truncated))
            if d > 0
        )
        warnings.warn(
            "keypoint cap: above-threshold detections beyond "
            f"max_keypoints were dropped, keeping the top responses "
            f"({per_cloud}); the reference keeps every above-threshold "
            "keypoint — raise MergeParams.max_keypoints to match",
            stacklevel=3,
        )


def _note_info(info_out: dict | None, estimates: list) -> None:
    """Per-merge diagnostics for callers that want them (the node's
    metrics): pair counts, failures, and ambiguity flags."""
    if info_out is None:
        return
    info_out["n_pairs"] = len(estimates)
    info_out["n_failed"] = sum(
        1 for e in estimates if not np.asarray(e.transform).any()
    )
    info_out["n_ambiguous"] = sum(1 for e in estimates if e.ambiguous)
    info_out["ambiguous_pairs"] = [
        (e.source_idx, e.target_idx) for e in estimates if e.ambiguous
    ]


def _warn_pair_overflow_np(overflow: np.ndarray) -> None:
    """_warn_pair_overflow over an already-fetched numpy counter."""
    import warnings

    if overflow.max(initial=0) > 0:
        warnings.warn(
            "grid neighbor engine: up to "
            f"{int(overflow.max())} source query points per pair overflowed "
            "the target grid's query-side bucket cap during ICP/scoring — "
            "correspondences were dropped; raise MergeParams.grid_scan_cap "
            "or coarsen resolution",
            stacklevel=3,
        )


def _warn_pair_overflow(est) -> None:
    """Surface query-side grid overflow from the pair stage (ICP /
    transform-score queries of the moved SOURCE against the target grid —
    a source denser than the target's buckets loses correspondences there,
    invisible to the per-cloud feature probe)."""
    import warnings

    overflow = _fetch(est.scan_overflow)
    if overflow.max(initial=0) > 0:
        warnings.warn(
            "grid neighbor engine: up to "
            f"{int(overflow.max())} source query points per pair overflowed "
            "the target grid's query-side bucket cap during ICP/scoring — "
            "correspondences were dropped; raise MergeParams.grid_scan_cap "
            "or coarsen resolution",
            stacklevel=3,
        )


def _canonical_keys(seed, pairs: list[tuple[int, int]], n: int) -> jax.Array:
    """Per-pair RNG keys folded over each pair's CANONICAL all-pairs index
    (its position in the full i<j enumeration of n clouds), so the same
    (seed, pair) always gets the same key regardless of which other pairs
    were filtered out (empty keypoint sets) or which code path runs
    (fused / staged / sharded) — path-independent seed reproducibility
    (ADVICE r4)."""
    canonical = {
        p: k
        for k, p in enumerate(
            (i, j) for i in range(n - 1) for j in range(i + 1, n)
        )
    }
    idx = jnp.asarray([canonical[p] for p in pairs], jnp.uint32)
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(seed), idx
    )


def estimate_maps_transforms(
    clouds: Sequence[PointCloud],
    params: MergeParams | None = None,
    seed: int = 0,
    mesh=None,
    info_out: dict | None = None,
) -> list[np.ndarray]:
    """Estimate per-map SE(3) transforms into a common reference frame.

    Reference: estimateMapsTransforms (map_merging.cpp:188-275).
    Returns numpy (4, 4) float32 matrices; zero matrix = "could not
    register" (map_merging.h:81-84).

    With `mesh` (jax.sharding.Mesh), the cloud batch axis of the feature
    stage and the pair axis of the registration stage are sharded over the
    mesh devices (parallel/pair_shard.py); otherwise both stages run as one
    vmapped program on the default device.

    `info_out`, when given, receives per-merge diagnostics: number of
    pairs registered, failures, and pairs flagged ambiguous at
    registration time (PairEstimate.ambiguous).
    """
    params = params or MergeParams()
    clouds = list(clouds)
    if not clouds:
        return []
    if len(clouds) == 1:
        return [np.eye(4, dtype=np.float32)]

    if mesh is not None:
        return _estimate_maps_transforms_sharded(
            clouds, params, seed, mesh, info_out
        )

    from mapmerge_tpu.pipeline.features import (
        STAGED_THRESHOLD,
        extract_features_staged,
    )

    big = max(c.capacity for c in clouds) >= STAGED_THRESHOLD
    if big:
        # big-cloud path: per-stage jits per cloud + per-pair registration
        # (features.STAGED_THRESHOLD)
        from mapmerge_tpu.core.cloud import pad_cloud

        cap = max(c.capacity for c in clouds)
        feature_list = [
            extract_features_staged(pad_cloud(c, cap), params)
            for c in clouds
        ]
        features = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *feature_list
        )
    elif jax.process_count() == 1:
        # small-cloud single-process fast path: the whole merge is one
        # program and ONE packed fetch (_merge_all_pairs_fused docstring)
        n = len(clouds)
        batch = stack_clouds(clouds)
        packed = np.asarray(
            _merge_all_pairs_fused(batch, params, n, jnp.uint32(seed))
        )
        all_pairs = [
            (i, j) for i in range(n - 1) for j in range(i + 1, n)
        ]
        p = len(all_pairs)
        transforms = packed[: p * 16].reshape(p, 4, 4)
        confidences = packed[p * 16 : p * 17]
        pair_overflow = packed[p * 17 : p * 18]
        coverage = packed[p * 18 : p * 19]
        purity = packed[p * 19 : p * 20]
        support = packed[p * 20 : p * 21]
        kp_counts = packed[p * 21 : p * 21 + n]
        dropped = packed[p * 21 + n : p * 21 + 2 * n]
        feat_overflow = packed[p * 21 + 2 * n : p * 21 + 3 * n]
        kp_truncated = packed[p * 21 + 3 * n :]
        from mapmerge_tpu.pipeline.registration import (
            AMBIGUITY_MIN_COVERAGE,
            AMBIGUITY_MIN_PURITY,
            AMBIGUITY_MIN_SUPPORT,
        )

        registered = transforms.reshape(p, 16).any(axis=1)
        ambiguous = registered & (
            (coverage < AMBIGUITY_MIN_COVERAGE)
            | (purity < AMBIGUITY_MIN_PURITY)
            | (support < AMBIGUITY_MIN_SUPPORT)
        )
        _warn_dropped_np(dropped, feat_overflow, kp_truncated)
        _warn_pair_overflow_np(pair_overflow)
        estimates = [
            TransformEstimate(
                source_idx=i,
                target_idx=j,
                transform=transforms[k],
                confidence=float(confidences[k]),
                ambiguous=bool(ambiguous[k]),
            )
            for k, (i, j) in enumerate(all_pairs)
            # reference pair generation: both keypoint sets non-empty
            # (map_merging.cpp:246-254)
            if kp_counts[i] > 0 and kp_counts[j] > 0
        ]
        _note_info(info_out, estimates)
        if not estimates:
            return []
        return _solve_graph(estimates, params)
    else:
        # multi-process small path (no mesh): keep the separate-stage
        # programs — arrays may span processes, fetched via _fetch
        batch = stack_clouds(clouds)
        features = extract_features_batch(batch, params)
    _warn_dropped(features)

    # pair generation: i < j with both keypoint sets non-empty
    # (map_merging.cpp:246-254); one D2H of the keypoint counts
    kp_counts = _fetch(jnp.sum(features.keypoints.mask, axis=-1))
    pairs = [
        (i, j)
        for i in range(len(clouds) - 1)
        for j in range(i + 1, len(clouds))
        if kp_counts[i] > 0 and kp_counts[j] > 0
    ]
    if not pairs:
        # no registerable pairs: zero nodes in the estimate graph
        # (reference would index an empty centers vector here; we return
        # the empty list its nodes_count=0 path implies)
        return []

    keys = _canonical_keys(seed, pairs, len(clouds))
    if big:
        jit_pair = jax.jit(estimate_transform, static_argnames=("params",))
        ests = [
            jit_pair(feature_list[i], feature_list[j], params, keys[k])
            for k, (i, j) in enumerate(pairs)
        ]
        est = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ests)
    else:
        src_idx = jnp.asarray([p[0] for p in pairs], jnp.int32)
        tgt_idx = jnp.asarray([p[1] for p in pairs], jnp.int32)
        est = estimate_pairs_batch(features, src_idx, tgt_idx, params, keys)
    _warn_pair_overflow(est)

    transforms = np.asarray(est.transform)
    confidences = np.asarray(est.confidence)
    amb = np.asarray(est.ambiguous())
    estimates = [
        TransformEstimate(
            source_idx=i,
            target_idx=j,
            transform=transforms[k],
            confidence=float(confidences[k]),
            ambiguous=bool(amb[k]),
        )
        for k, (i, j) in enumerate(pairs)
    ]
    _note_info(info_out, estimates)
    return _solve_graph(estimates, params)


def _solve_graph(estimates, params: MergeParams) -> list[np.ndarray]:
    """MST chaining (reference semantics) + optional all-edge relaxation
    from the tree most edges agree with (pose_graph.consensus_seed)."""
    global_t = compute_global_transforms(
        estimates, params.confidence_threshold
    )
    if params.global_refinement:
        from mapmerge_tpu.graph.pose_graph import (
            CONSENSUS_TOL_DEG,
            CONSENSUS_TOL_M,
            consensus_seed,
            refine_global_transforms,
        )

        global_t = consensus_seed(
            estimates, global_t, params.confidence_threshold
        )
        # the seed now agrees with most of the graph, so the gate can sit
        # at twice the agreement tolerance: the wider default lets enough
        # wrong all-pairs edges in to drag whole blocks of maps off
        global_t = refine_global_transforms(
            estimates, global_t, params.confidence_threshold,
            seed_gate_deg=2 * CONSENSUS_TOL_DEG,
            seed_gate_m=2 * CONSENSUS_TOL_M,
        )
    return global_t


def _estimate_maps_transforms_sharded(
    clouds: list[PointCloud], params: MergeParams, seed: int, mesh,
    info_out: dict | None = None,
) -> list[np.ndarray]:
    """Mesh-sharded variant: clouds padded to a device multiple for the
    feature stage, pairs padded for the registration stage."""
    from mapmerge_tpu.parallel.mesh import pad_to_multiple
    from mapmerge_tpu.parallel.pair_shard import (
        estimate_pairs_sharded,
        extract_features_sharded,
        pad_pairs,
    )

    n_dev = mesh.devices.size
    n_real = len(clouds)
    n_padded = pad_to_multiple(n_real, n_dev)

    from mapmerge_tpu.pipeline.features import STAGED_THRESHOLD

    if max(c.capacity for c in clouds) >= STAGED_THRESHOLD:
        # big-cloud staged features: at >= 2^19 capacity the single-device
        # path stages the feature program (features.STAGED_THRESHOLD), so
        # it cannot ride the shard_map cloud axis — instead the
        # INDEPENDENT per-cloud staged programs are round-robined over the
        # mesh's local devices (parallel/pair_shard.py; VERDICT r4
        # missing 2). Features end up on one device and replicate into
        # the pair stage (its in_spec is P()).
        from mapmerge_tpu.parallel.pair_shard import (
            extract_features_staged_parallel,
        )

        features = extract_features_staged_parallel(clouds, params, mesh)
    else:
        empty = PointCloud.from_arrays(
            np.zeros((0, 3), np.float32), capacity=1
        )
        batch = stack_clouds(clouds + [empty] * (n_padded - n_real))
        features = extract_features_sharded(batch, params, mesh)
    _warn_dropped(features)

    kp_counts = _fetch(jnp.sum(features.keypoints.mask, axis=-1))
    pairs = [
        (i, j)
        for i in range(n_real - 1)
        for j in range(i + 1, n_real)
        if kp_counts[i] > 0 and kp_counts[j] > 0
    ]
    if not pairs:
        return []

    src_idx, tgt_idx, n_pairs = pad_pairs(pairs, n_dev)
    keys = _canonical_keys(seed, pairs, n_real)
    if src_idx.shape[0] > len(pairs):  # pad keys; padded results discarded
        keys = jnp.concatenate(
            [keys, jnp.repeat(keys[:1], src_idx.shape[0] - len(pairs), 0)]
        )
    est = estimate_pairs_sharded(features, src_idx, tgt_idx, params, keys, mesh)
    _warn_pair_overflow(est)

    transforms = _fetch(est.transform)[:n_pairs]
    confidences = _fetch(est.confidence)[:n_pairs]
    amb = _fetch(est.ambiguous())[:n_pairs]
    estimates = [
        TransformEstimate(
            source_idx=i,
            target_idx=j,
            transform=transforms[k],
            confidence=float(confidences[k]),
            ambiguous=bool(amb[k]),
        )
        for k, (i, j) in enumerate(pairs)
    ]
    _note_info(info_out, estimates)
    return _solve_graph(estimates, params)


def compose_maps(
    clouds: Sequence[PointCloud],
    transforms: Sequence[np.ndarray],
    resolution: float,
    out_capacity: int | None = None,
) -> PointCloud | None:
    """Transform-and-concatenate the full-resolution clouds, then voxelize
    at `resolution` (reference composeMaps, map_merging.cpp:277-305)."""
    clouds = list(clouds)
    if not clouds:
        return None
    if len(clouds) != len(transforms):
        raise ValueError(
            "composeMaps: clouds and transforms size must be the same."
        )

    parts_xyz, parts_rgb, parts_mask = [], [], []
    for cloud, transform in zip(clouds, transforms):
        t = np.asarray(transform, np.float32)
        if not t.any():  # zero transform -> skip (map_merging.cpp:293-295)
            continue
        moved = tf.apply(jnp.asarray(t), cloud.xyz)
        parts_xyz.append(moved)
        parts_rgb.append(cloud.rgb)
        parts_mask.append(cloud.mask)
    if not parts_xyz:
        # all transforms zero: reference returns an empty (non-null) cloud
        return PointCloud.from_arrays(np.zeros((0, 3), np.float32), capacity=1)

    merged = PointCloud(
        xyz=jnp.concatenate(parts_xyz, axis=0),
        rgb=jnp.concatenate(parts_rgb, axis=0),
        mask=jnp.concatenate(parts_mask, axis=0),
    ).park_invalid()
    return voxel_downsample(merged, resolution, out_capacity=out_capacity)
