"""Multi-host setup.

Replacement for the reference's multi-master ROS story (the
reference delegates cross-host networking entirely to external packages,
doc/wiki.txt:14): here processes join one jax.distributed job, every
process contributes its GPU to the global mesh, and the pair axis of the
registration graph spans all of them (collectives ride NVLink between the
GPUs of one host and the network across hosts — XLA inserts them from the
shardings).

Each host ingests its own robots' maps (runtime/transport.py); the feature
stage runs where the data lands, and the globally-sharded pair stage
exchanges only keypoint/descriptor blocks, not raw clouds.
"""

from __future__ import annotations

import os

import jax

from mapmerge_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """jax.distributed.initialize wrapper (no-op if already initialized or
    single-process). Safe to call unconditionally at program start.

    Run one process per GPU: a JAX process reserves most of the memory of
    every card it opens. Under SLURM or Open MPI, jax.distributed detects
    the cluster and gives each process its own card. Other launchers set
    LOCAL_RANK (the process's rank on its host); the process then opens
    only that card (jax.distributed's local_device_ids). With neither, a
    process drives every card of its host — one process per host."""
    kwargs = {}
    local_rank = os.environ.get("LOCAL_RANK")
    if local_rank is not None:
        kwargs["local_device_ids"] = [int(local_rank)]
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def global_mesh():
    """Mesh over every chip of every host in the job."""
    return make_mesh(jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0


def allgather_robot_maps(local: dict) -> dict:
    """Union of every host's latest robot maps.

    This is the cross-host map-ingest exchange SURVEY §2c promises: each host
    ingests only its own robots' maps (runtime/transport.py), and before a
    global estimation tick the hosts exchange them so every process runs
    the same SPMD program over the same global cloud batch — the
    analog of all robots' topics reaching the one merge node
    (map_merge_node.cpp:57-100).

    `local` maps robot name -> (xyz, rgb|None) numpy arrays. Byte blobs of
    each host's dict are padded to the global max and allgathered (a
    host-side collective over the network); the union is returned on every host.
    COLLECTIVE: every process in the job must call this in lockstep.
    """
    if jax.process_count() == 1:
        return dict(local)
    import pickle

    import numpy as np
    from jax.experimental import multihost_utils

    blob = np.frombuffer(pickle.dumps(local), np.uint8)
    sizes = multihost_utils.process_allgather(
        np.asarray([blob.size], np.int32), tiled=True
    )  # (P,)
    padded = np.zeros((int(sizes.max()),), np.uint8)
    padded[: blob.size] = blob
    blobs = multihost_utils.process_allgather(padded)  # (P, max_size)
    merged: dict = {}
    for pid in range(sizes.shape[0]):
        merged.update(pickle.loads(blobs[pid, : int(sizes[pid])].tobytes()))
    return merged
