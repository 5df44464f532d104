"""Per-cloud feature stage.

Equivalent of the reference's four sequential per-cloud loops in
estimateMapsTransforms (map_merge_3d/src/map_merging.cpp:211-242):
downsample -> outlier removal -> normals -> keypoints -> descriptors,
with the same parameter plumbing (keypoint radius = normal_radius,
SIFT min_scale = resolution, descriptor radius = descriptor_radius).
One jittable function over a single padded cloud — vmap it over the batch
axis for the N-cloud stage (the reference loops; we fan out).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.ops.descriptors import Descriptors, compute_descriptors
from mapmerge_tpu.ops.downsample import voxel_downsample
from mapmerge_tpu.ops.keypoints import Keypoints, detect_keypoints
from mapmerge_tpu.ops.normals import SurfaceNormals, compute_surface_normals
from mapmerge_tpu.ops.outliers import remove_outliers


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CloudFeatures:
    """Everything the pairwise stage needs about one cloud."""

    cloud: PointCloud  # registration-resolution cloud (padded, masked)
    normals: SurfaceNormals
    keypoints: Keypoints
    descriptors: Descriptors
    #: valid input points dropped because the voxel grid overflowed
    #: `max_points` — nonzero means geometry was lost; surfaced as a warning
    #: by estimate_maps_transforms (no silent caps)
    dropped_points: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )
    #: under the grid neighbor engine: how far the fullest hash bucket
    #: exceeds grid_scan_cap (0 = every neighbor query was exact); nonzero
    #: means neighborhoods may have been truncated — surfaced as a warning
    scan_overflow: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )


#: capacity above which the feature stage runs as separately-jitted stages
#: instead of one fused program, which bounds the intermediates live at
#: once. Chosen on the earlier accelerator (16 GB of device memory); not
#: measured on the H100.
STAGED_THRESHOLD = 1 << 19


def extract_features_staged(
    cloud: PointCloud, params: MergeParams
) -> CloudFeatures:
    """extract_features with each stage its own jit (big-cloud path).

    Identical math to extract_features; intermediates of one stage are
    released before the next compiles/runs, bounding peak device memory."""
    resized, dropped = _jit_downsample(cloud, params)
    # probe BEFORE outlier removal: the outlier pass itself queries this
    # cloud (its query overflow silently zeroes counts), and every later
    # stage queries a subset of it — so this grid upper-bounds them all
    scan_overflow = _jit_overflow_probe(resized, params)
    resized = _jit_outliers(resized, params)
    normals = _jit_normals(resized, params)
    keypoints = _jit_keypoints(resized, normals, params)
    descriptors = _jit_descriptors(resized, normals, keypoints, params)
    keypoints = dataclasses.replace(
        keypoints, mask=keypoints.mask & descriptors.valid
    )
    return CloudFeatures(
        cloud=resized,
        normals=normals,
        keypoints=keypoints,
        descriptors=descriptors,
        dropped_points=dropped,
        scan_overflow=scan_overflow,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_downsample(cloud, params):
    return voxel_downsample(
        cloud, params.resolution,
        out_capacity=min(cloud.capacity, params.max_points),
        with_stats=True,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_outliers(resized, params):
    return remove_outliers(
        resized, params.descriptor_radius, params.outliers_min_neighbours,
        tile=params.neighbor_tile, engine=params.neighbor_engine,
        scan_cap=params.grid_scan_cap,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_normals(resized, params):
    return compute_surface_normals(
        resized, params.normal_radius, tile=params.neighbor_tile,
        engine=params.neighbor_engine, scan_cap=params.grid_scan_cap,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_keypoints(resized, normals, params):
    return detect_keypoints(
        resized, normals, params.keypoint_type,
        threshold=params.keypoint_threshold,
        radius=params.normal_radius,
        resolution=params.resolution,
        max_keypoints=params.max_keypoints,
        tile=params.neighbor_tile,
        sift_octaves=params.sift_octaves,
        sift_scales_per_octave=params.sift_scales_per_octave,
        engine=params.neighbor_engine,
        scan_cap=params.grid_scan_cap,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_descriptors(resized, normals, keypoints, params):
    return compute_descriptors(
        resized, normals, keypoints, params.descriptor_type,
        params.descriptor_radius, max_neighbors=params.max_neighbors,
        tile=params.neighbor_tile, engine=params.neighbor_engine,
        scan_cap=params.grid_scan_cap,
    )


@partial(jax.jit, static_argnames=("params",))
def _jit_overflow_probe(resized, params):
    from mapmerge_tpu.ops.neighbors import _resolve_engine

    if _resolve_engine(params.neighbor_engine, resized.capacity) == "grid":
        from mapmerge_tpu.ops.grid import build_grid, max_bucket_count

        probe_f = build_grid(
            resized.xyz, resized.mask, params.descriptor_radius
        )
        probe_r = build_grid(
            resized.xyz, resized.mask, params.max_correspondence_distance
        )
        return jnp.maximum(
            jnp.maximum(max_bucket_count(probe_f) - params.grid_scan_cap, 0),
            jnp.maximum(
                max_bucket_count(probe_r) - params.registration_scan_cap, 0
            ),
        ).astype(jnp.int32)
    return jnp.zeros((), jnp.int32)


@partial(jax.jit, static_argnames=("params",))
def extract_features(cloud: PointCloud, params: MergeParams) -> CloudFeatures:
    """Reference stage order map_merging.cpp:211-242."""
    resized, dropped = voxel_downsample(
        cloud,
        params.resolution,
        # a voxel grid never grows the cloud; don't pad past the input
        out_capacity=min(cloud.capacity, params.max_points),
        with_stats=True,
    )
    engine = params.neighbor_engine
    scan_cap = params.grid_scan_cap
    # grid-engine overflow probe on the PRE-outlier cloud: the outlier pass
    # itself queries this cloud (query overflow silently zeroes counts), and
    # every later stage queries a subset — this grid upper-bounds them all.
    # Probed radii: widest feature-stage cell (descriptor radius) vs
    # scan_cap, widest registration cell (ICP/score bound) vs its cap.
    from mapmerge_tpu.ops.neighbors import _resolve_engine

    if _resolve_engine(engine, resized.capacity) == "grid":
        from mapmerge_tpu.ops.grid import build_grid, max_bucket_count

        probe_f = build_grid(
            resized.xyz, resized.mask, params.descriptor_radius
        )
        probe_r = build_grid(
            resized.xyz, resized.mask, params.max_correspondence_distance
        )
        scan_overflow = jnp.maximum(
            jnp.maximum(max_bucket_count(probe_f) - scan_cap, 0),
            jnp.maximum(
                max_bucket_count(probe_r) - params.registration_scan_cap, 0
            ),
        ).astype(jnp.int32)
    else:
        scan_overflow = jnp.zeros((), jnp.int32)
    resized = remove_outliers(
        resized,
        params.descriptor_radius,
        params.outliers_min_neighbours,
        tile=params.neighbor_tile,
        engine=engine,
        scan_cap=scan_cap,
    )
    normals = compute_surface_normals(
        resized, params.normal_radius, tile=params.neighbor_tile,
        engine=engine, scan_cap=scan_cap,
    )
    keypoints = detect_keypoints(
        resized,
        normals,
        params.keypoint_type,
        threshold=params.keypoint_threshold,
        radius=params.normal_radius,  # map_merging.cpp:233
        resolution=params.resolution,
        max_keypoints=params.max_keypoints,
        tile=params.neighbor_tile,
        sift_octaves=params.sift_octaves,
        sift_scales_per_octave=params.sift_scales_per_octave,
        engine=engine,
        scan_cap=scan_cap,
    )
    descriptors = compute_descriptors(
        resized,
        normals,
        keypoints,
        params.descriptor_type,
        params.descriptor_radius,
        max_neighbors=params.max_neighbors,
        tile=params.neighbor_tile,
        engine=engine,
        scan_cap=scan_cap,
    )
    # the reference drops keypoints whose descriptors are invalid
    # (features.cpp:118-141); masks keep the arrays aligned here
    keypoints = dataclasses.replace(
        keypoints, mask=keypoints.mask & descriptors.valid
    )
    return CloudFeatures(
        cloud=resized,
        normals=normals,
        keypoints=keypoints,
        descriptors=descriptors,
        dropped_points=dropped,
        scan_overflow=scan_overflow,
    )
