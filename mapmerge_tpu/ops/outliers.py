"""Radius outlier removal.

JAX equivalent of pcl::RadiusOutlierRemoval as used by the reference
(map_merge_3d/src/features.cpp:31-43): drop points with fewer than
`min_neighbors` points within `radius`. PCL's radiusSearch counts the query
point itself (the query is drawn from the same cloud), so we do too.
Instead of erasing points we clear mask bits — downstream ops are mask-aware.
"""

from __future__ import annotations

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.ops.neighbors import radius_count


def remove_outliers(
    cloud: PointCloud,
    radius: float,
    min_neighbors: int,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> PointCloud:
    # query overflow is bounded by the feature-stage probe: queries are the
    # indexed points themselves, so the query grid IS the point grid and
    # its overflow is what extract_features' widest-radius probe reports
    counts, _ = radius_count(
        cloud.xyz, cloud.xyz, radius, p_mask=cloud.mask, tile=tile,
        include_self=True, engine=engine, scan_cap=scan_cap,
    )
    keep = cloud.mask & (counts >= min_neighbors)
    return PointCloud(xyz=cloud.xyz, rgb=cloud.rgb, mask=keep).park_invalid()
