"""Padded fixed-shape point-cloud array model.

Fixed-shape replacement for the reference's dynamic PCL clouds
(map_merge_3d/include/map_merge_3d/typedefs.h:15-36, PointT=pcl::PointXYZRGB).
XLA wants static shapes, so a cloud is a `(capacity, ...)` array bundle with a
validity mask; every op in the framework is mask-aware. Where the reference
physically removes points (filters, invalid-descriptor dropping,
features.cpp:118-141), we clear mask bits instead.

Masked-out points have their coordinates parked at a far sentinel so that any
distance-based op naturally excludes them even before masking.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

#: parked coordinate for invalid points; squared distances stay finite in f32
FAR = 1.0e8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A padded XYZRGB point cloud.

    Attributes:
      xyz:  (N, 3) float32 positions; invalid rows parked at FAR.
      rgb:  (N, 3) float32 colors in [0, 1]; invalid rows zero.
      mask: (N,)   bool validity.
    """

    xyz: jax.Array
    rgb: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def count(self) -> jax.Array:
        """Number of valid points (traced value)."""
        return jnp.sum(self.mask, axis=-1)

    def park_invalid(self) -> "PointCloud":
        """Return a copy with invalid xyz parked at FAR and rgb zeroed."""
        m = self.mask[..., None]
        return PointCloud(
            xyz=jnp.where(m, self.xyz, FAR),
            rgb=jnp.where(m, self.rgb, 0.0),
            mask=self.mask,
        )

    @staticmethod
    def from_arrays(
        xyz: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Build a padded cloud from host arrays of shape (n, 3)."""
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        if rgb is None:
            rgb = np.zeros((n, 3), dtype=np.float32)
        else:
            rgb = np.asarray(rgb, dtype=np.float32).reshape(-1, 3)
            if rgb.shape[0] != n:
                raise ValueError("rgb and xyz must have the same point count")
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pad = cap - n
        xyz_p = np.concatenate([xyz, np.full((pad, 3), FAR, np.float32)], axis=0)
        rgb_p = np.concatenate([rgb, np.zeros((pad, 3), np.float32)], axis=0)
        mask = np.concatenate(
            [np.ones((n,), bool), np.zeros((pad,), bool)], axis=0
        )
        return PointCloud(
            xyz=jnp.asarray(xyz_p), rgb=jnp.asarray(rgb_p), mask=jnp.asarray(mask)
        )

    def to_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Return compacted host (xyz, rgb) arrays of valid points only."""
        mask = np.asarray(self.mask)
        return np.asarray(self.xyz)[mask], np.asarray(self.rgb)[mask]


def stack_clouds(clouds: list[PointCloud], capacity: Optional[int] = None):
    """Stack clouds into one batched PointCloud of shape (B, N, ...).

    Pads every cloud to a common capacity (max of inputs by default) so the
    per-cloud feature stage can be vmapped/shard_mapped over the batch axis —
    the batched answer to the reference's sequential per-cloud loops
    (map_merge_3d/src/map_merging.cpp:211-242).
    """
    cap = capacity or max(c.capacity for c in clouds)
    padded = [pad_cloud(c, cap) for c in clouds]
    return PointCloud(
        xyz=jnp.stack([c.xyz for c in padded]),
        rgb=jnp.stack([c.rgb for c in padded]),
        mask=jnp.stack([c.mask for c in padded]),
    )


def pad_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Pad (or validate) a cloud to `capacity` points."""
    n = cloud.capacity
    if capacity == n:
        return cloud
    if capacity < n:
        raise ValueError(f"capacity {capacity} < cloud capacity {n}")
    pad = capacity - n
    return PointCloud(
        xyz=jnp.concatenate(
            [cloud.xyz, jnp.full((pad, 3), FAR, jnp.float32)], axis=0
        ),
        rgb=jnp.concatenate([cloud.rgb, jnp.zeros((pad, 3), jnp.float32)], axis=0),
        mask=jnp.concatenate([cloud.mask, jnp.zeros((pad,), bool)], axis=0),
    )
