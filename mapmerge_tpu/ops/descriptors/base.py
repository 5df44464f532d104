"""Descriptor result container shared by all descriptor kernels.

JAX equivalent of the reference's type-erased pcl::PCLPointCloud2 descriptor
transport (typedefs.h:27-29): one fixed-shape (K, D) array regardless of
descriptor type, with a validity mask replacing the reference's physical
removal of invalid descriptors + their keypoints (features.cpp:118-141).
The descriptor type remains recoverable from the data (its feature dim),
mirroring the name-embedded dispatch at matching.cpp:102.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Descriptors:
    data: jax.Array  # (K, D) float32
    valid: jax.Array  # (K,) bool — invalid descriptor == dropped keypoint

    @property
    def dim(self) -> int:
        return self.data.shape[-1]

    @property
    def count(self) -> jax.Array:
        return jnp.sum(self.valid)
