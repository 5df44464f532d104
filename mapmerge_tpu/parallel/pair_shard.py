"""Sharded all-pairs registration.

The reference's hot loop — sequential pairwise estimation over all map
pairs (map_merge_3d/src/map_merging.cpp:256-269) — becomes a shard_map over
the pair axis of a device mesh: each device registers its slice of pairs
(vmapped locally), features are replicated, and the resulting transforms /
confidences are gathered back. The same entry also shards the per-cloud
feature stage over the cloud batch axis.

Padding: the pair list is padded to a multiple of the mesh size with
self-pairs (0, 0) whose results are discarded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.parallel.mesh import PAIR_AXIS, pad_to_multiple
from mapmerge_tpu.pipeline.features import CloudFeatures, extract_features
from mapmerge_tpu.pipeline.registration import estimate_transform


def _gather(features: CloudFeatures, idx: jax.Array) -> CloudFeatures:
    return jax.tree_util.tree_map(lambda a: a[idx], features)


@partial(jax.jit, static_argnames=("params", "mesh"))
def extract_features_sharded(
    batch: PointCloud, params: MergeParams, mesh: Mesh
) -> CloudFeatures:
    """Per-cloud feature stage sharded over the cloud batch axis.

    Requires batch size to be a multiple of the mesh size (callers pad with
    empty clouds).
    """

    def local(cloud_batch: PointCloud) -> CloudFeatures:
        # lax.map, not vmap: see pipeline/merging.extract_features_batch —
        # each cloud saturates its device; batching pessimizes the program
        return jax.lax.map(lambda c: extract_features(c, params), cloud_batch)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(PAIR_AXIS),),
        out_specs=P(PAIR_AXIS),
        check_vma=False,
    )(batch)


@partial(jax.jit, static_argnames=("params", "mesh"))
def estimate_pairs_sharded(
    features: CloudFeatures,
    src_idx: jax.Array,
    tgt_idx: jax.Array,
    params: MergeParams,
    keys: jax.Array,
    mesh: Mesh,
):
    """All-pairs registration with the pair axis sharded over `mesh`.

    src_idx/tgt_idx/keys must be padded to a multiple of the mesh size.
    """

    def local(feats: CloudFeatures, si, ti, ks):
        def one(args):
            s, t, k = args
            return estimate_transform(
                _gather(feats, s), _gather(feats, t), params, k
            )

        return jax.lax.map(one, (si, ti, ks))

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(PAIR_AXIS), P(PAIR_AXIS), P(PAIR_AXIS)),
        out_specs=P(PAIR_AXIS),
        check_vma=False,
    )(features, src_idx, tgt_idx, keys)


def extract_features_staged_parallel(
    clouds: list[PointCloud], params: MergeParams, mesh: Mesh
) -> CloudFeatures:
    """Big-cloud staged feature extraction, round-robined over the mesh's
    local devices (VERDICT r4 missing 2).

    At >= features.STAGED_THRESHOLD capacity the per-cloud feature stage
    runs as separate per-stage programs (features.STAGED_THRESHOLD), so
    it cannot ride the shard_map cloud axis — but the per-cloud
    staged programs are INDEPENDENT. Committing each cloud's input to mesh
    device i % n_local makes every stage of that cloud execute on that
    device; async dispatch queues all clouds' stages up front, so devices
    work concurrently. This replaces the serial, replicated per-cloud loop
    the single-chip path uses (pipeline/merging.py big path; reference
    analog: the sequential per-cloud loops, map_merging.cpp:205-243).

    Output: one (B, ...) CloudFeatures batch replicated over the mesh
    (the pair stage consumes features replicated, in_spec P()).
    """
    from jax.sharding import NamedSharding

    from mapmerge_tpu.core.cloud import pad_cloud
    from mapmerge_tpu.pipeline.features import extract_features_staged

    devices = list(mesh.devices.flat)
    local = [
        d for d in devices if d.process_index == jax.process_index()
    ] or devices
    cap = max(c.capacity for c in clouds)
    feats = []
    for i, cloud in enumerate(clouds):
        dev = local[i % len(local)]
        padded = jax.device_put(pad_cloud(cloud, cap), dev)
        feats.append(extract_features_staged(padded, params))
    dev0 = local[0]
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jax.device_put(x, dev0) for x in xs]), *feats
    )
    # replicate onto the whole mesh for the pair stage (in_spec P())
    return jax.device_put(stacked, NamedSharding(mesh, P()))


def pad_pairs(pairs: list[tuple[int, int]], n_devices: int):
    """Pad the pair list to a device multiple with discardable (0, 0) pairs."""
    n = len(pairs)
    padded = pad_to_multiple(max(n, 1), n_devices)
    full = pairs + [(0, 0)] * (padded - n)
    src = jnp.asarray([p[0] for p in full], jnp.int32)
    tgt = jnp.asarray([p[1] for p in full], jnp.int32)
    return src, tgt, n
