"""String-typed config enums.

JAX equivalent of the reference's ENUM_CLASS preprocessor reflection
(reference: map_merge_3d/include/map_merge_3d/enum.h:30-67). The reference
generates to_string/from_string for three enums used in string-typed config
(map_merge_3d/include/map_merge_3d/features.h, matching.h). Python's StrEnum
gives us the same capability natively; `from_string` mirrors the reference's
strict parse-or-throw contract (enum.h:43-61).
"""

from __future__ import annotations

import enum


class Keypoint(enum.StrEnum):
    """Keypoint detector selection (reference: features.h `enum class Keypoint`)."""

    SIFT = "SIFT"
    HARRIS = "HARRIS"


class Descriptor(enum.StrEnum):
    """Local descriptor selection (reference: features.h `enum class Descriptor`).

    Dimensionalities mirror the reference's PCL signature types
    (map_merge_3d/src/dispatch_descriptors.h:38-48):
    PFH=125, PFHRGB=250, FPFH=33, RSD=2 (principal radii), SHOT=1344
    (color SHOT), SC3D=1980. RIFT is declared-but-disabled in the reference
    (dispatch_descriptors.h:41-42) and intentionally omitted here.
    """

    PFH = "PFH"
    PFHRGB = "PFHRGB"
    FPFH = "FPFH"
    RSD = "RSD"
    SHOT = "SHOT"
    SC3D = "SC3D"


#: descriptor name -> feature dimensionality (dispatch_descriptors.h:38-48)
DESCRIPTOR_DIMS: dict[Descriptor, int] = {
    Descriptor.PFH: 125,
    Descriptor.PFHRGB: 250,
    Descriptor.FPFH: 33,
    Descriptor.RSD: 2,
    Descriptor.SHOT: 1344,
    Descriptor.SC3D: 1980,
}


class EstimationMethod(enum.StrEnum):
    """Initial transform estimation method (reference: matching.h)."""

    MATCHING = "MATCHING"
    SAC_IA = "SAC_IA"


def from_string(enum_cls: type[enum.StrEnum], value: str):
    """Parse-or-throw, mirroring reference enums::from_string (enum.h:43-61)."""
    try:
        return enum_cls(value.upper())
    except ValueError:
        valid = ", ".join(m.value for m in enum_cls)
        raise ValueError(
            f"{value!r} is not a valid {enum_cls.__name__} (expected one of: {valid})"
        ) from None
