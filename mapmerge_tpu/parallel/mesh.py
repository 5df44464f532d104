"""Device mesh utilities.

The replacement for the reference's distribution story (SURVEY.md §2c):
where map_merge_3d parallelizes nothing (sequential per-cloud loops +
sequential O(N^2) pair loop, map_merging.cpp:211-269) and distributes only
via ROS topic transport, this framework shards the cloud batch axis and the
registration pair axis over a jax.sharding.Mesh, with XLA collectives
(NCCL over NVLink between the GPUs of one host). Every GPU of a host
reaches every other at the same rate, so the mesh is 1-D and follows the
algorithm alone. One mesh serves both stages.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PAIR_AXIS = "pairs"


def make_mesh(devices=None, axis: str = PAIR_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices for pair/cloud sharding."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PAIR_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, devices: int) -> int:
    return -(-n // devices) * devices
