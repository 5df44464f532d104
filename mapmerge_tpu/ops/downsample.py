"""Voxel-grid downsampling.

JAX equivalent of pcl::VoxelGrid as used by the reference
(map_merge_3d/src/features.cpp:17-27): cubic leaves of size `resolution`,
each occupied voxel replaced by the centroid of its points — including RGB
(PCL's downsample_all_data default). Used both at input resampling
(map_merging.cpp:212-215) and output compositing (map_merging.cpp:302).

No hash tables: points are lexicographically sorted by integer voxel
coordinates (jax.lax.sort with num_keys=3), runs of equal keys become
segments, and centroids come from sorted segment-sums. Fixed shapes
throughout; the result is a padded cloud with occupied voxels compacted to
the front.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import FAR, PointCloud

_KEY_SENTINEL = jnp.iinfo(jnp.int32).max


def voxel_downsample(
    cloud: PointCloud,
    resolution: float,
    out_capacity: int | None = None,
    with_stats: bool = False,
) -> PointCloud | tuple[PointCloud, jax.Array]:
    """Downsample to one centroid per occupied `resolution`-cube.

    `out_capacity` bounds the number of emitted voxels (defaults to the
    input capacity, which is always sufficient). If a smaller capacity is
    given, voxels beyond it (in lexicographic key order) are dropped — pass
    `with_stats=True` to also get the number of valid input points that were
    dropped this way (an int32 scalar; 0 means no geometry was lost), so
    callers can surface overflow instead of losing points silently.
    """
    n = cloud.capacity
    cap = out_capacity or n
    inv = jnp.float32(1.0 / resolution)

    mask = cloud.mask
    xyz_safe = jnp.where(mask[:, None], cloud.xyz, 0.0)
    keys = jnp.floor(xyz_safe * inv).astype(jnp.int32)
    kx = jnp.where(mask, keys[:, 0], _KEY_SENTINEL)
    ky = jnp.where(mask, keys[:, 1], _KEY_SENTINEL)
    kz = jnp.where(mask, keys[:, 2], _KEY_SENTINEL)

    # lexsort the permutation, then gather the payload: sequential 2-operand
    # sorts compile and run far faster at large N than one 10-operand
    # lax.sort carrying xyz/rgb/mask as sort values
    order = jnp.lexsort((kz, ky, kx))
    kx, ky, kz = kx[order], ky[order], kz[order]
    x, y, z = (cloud.xyz[order, c] for c in range(3))
    r, g, b = (cloud.rgb[order, c] for c in range(3))
    w = mask[order].astype(jnp.float32)

    # segment boundaries: first element, or any key component change
    prev_differs = (
        (kx[1:] != kx[:-1]) | (ky[1:] != ky[:-1]) | (kz[1:] != kz[:-1])
    )
    boundary = jnp.concatenate([jnp.ones((1,), bool), prev_differs])
    seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    overflow = seg >= cap
    seg_ids = jnp.where(overflow, cap, seg)  # cap = scrap bucket

    def seg_sum(vals):
        return jax.ops.segment_sum(
            vals, seg_ids, num_segments=cap + 1, indices_are_sorted=True
        )[:cap]

    wsum = seg_sum(w)
    denom = jnp.maximum(wsum, 1.0)
    cx = seg_sum(x * w) / denom
    cy = seg_sum(y * w) / denom
    cz = seg_sum(z * w) / denom
    cr = seg_sum(r * w) / denom
    cg = seg_sum(g * w) / denom
    cb = seg_sum(b * w) / denom

    out_mask = wsum > 0.0
    out_xyz = jnp.stack([cx, cy, cz], axis=-1)
    out_rgb = jnp.stack([cr, cg, cb], axis=-1)
    out_xyz = jnp.where(out_mask[:, None], out_xyz, FAR)
    out_rgb = jnp.where(out_mask[:, None], out_rgb, 0.0)
    out = PointCloud(xyz=out_xyz, rgb=out_rgb, mask=out_mask)
    if with_stats:
        dropped = jnp.sum(jnp.where(overflow, w, 0.0)).astype(jnp.int32)
        return out, dropped
    return out
