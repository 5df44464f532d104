"""Descriptor dispatch registry.

JAX equivalent of the reference's compile-time descriptor registry
(map_merge_3d/src/dispatch_descriptors.h:28-121): one call surface for all
descriptor types, dispatch by enum or by dimensionality recovered from the
data itself (the reference recovers type from the PointCloud2 field name,
matching.cpp:102; here the feature dim is the discriminator).
"""

from __future__ import annotations

from typing import Callable

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.core.enums import DESCRIPTOR_DIMS, Descriptor
from mapmerge_tpu.ops.descriptors.base import Descriptors
from mapmerge_tpu.ops.descriptors.fpfh import compute_fpfh
from mapmerge_tpu.ops.keypoints.harris import Keypoints
from mapmerge_tpu.ops.normals import SurfaceNormals

_REGISTRY: dict[Descriptor, Callable] = {}


def register(kind: Descriptor):
    def deco(fn):
        _REGISTRY[kind] = fn
        return fn

    return deco


def compute_descriptors(
    cloud: PointCloud,
    normals: SurfaceNormals,
    keypoints: Keypoints,
    kind: Descriptor,
    radius: float,
    max_neighbors: int = 64,
    tile: int = 1024,
    engine: str = "auto",
    scan_cap: int = 128,
) -> Descriptors:
    """Compute `kind` descriptors at keypoints over the `cloud` surface
    (reference features.cpp:152-166 -> dispatch_descriptors.h:113)."""
    fn = _REGISTRY.get(kind)
    if fn is None:
        raise NotImplementedError(
            f"descriptor {kind} not implemented yet; available: "
            f"{sorted(k.value for k in _REGISTRY)}"
        )
    return fn(
        cloud, normals, keypoints, radius, max_neighbors=max_neighbors,
        tile=tile, engine=engine, scan_cap=scan_cap,
    )


def descriptor_kind_from_dim(dim: int) -> Descriptor:
    """Recover descriptor type from data dimensionality (the reference
    recovers it from the embedded field name, matching.cpp:96-107)."""
    for kind, d in DESCRIPTOR_DIMS.items():
        if d == dim:
            return kind
    raise ValueError(f"no descriptor type with dimensionality {dim}")


from mapmerge_tpu.ops.descriptors.pfh import compute_pfh, compute_pfhrgb  # noqa: E402
from mapmerge_tpu.ops.descriptors.rsd import compute_rsd  # noqa: E402
from mapmerge_tpu.ops.descriptors.sc3d import compute_sc3d  # noqa: E402
from mapmerge_tpu.ops.descriptors.shot import compute_shot  # noqa: E402

_REGISTRY[Descriptor.FPFH] = compute_fpfh
_REGISTRY[Descriptor.PFH] = compute_pfh
_REGISTRY[Descriptor.PFHRGB] = compute_pfhrgb
_REGISTRY[Descriptor.RSD] = compute_rsd
_REGISTRY[Descriptor.SHOT] = compute_shot
_REGISTRY[Descriptor.SC3D] = compute_sc3d

__all__ = [
    "Descriptors",
    "compute_descriptors",
    "descriptor_kind_from_dim",
    "register",
]
