"""Merge pipeline configuration.

JAX equivalent of the reference's `MapMergingParams`
(map_merge_3d/include/map_merge_3d/map_merging.h:28-70): the same 16 tunables
with the same defaults and the same derived-default semantics, plus the
static capacity knobs a fixed-shape XLA program needs (padded sizes,
hypothesis counts, neighbor caps). The whole params object is hashable and
frozen so it can be a `static_argnum` under `jax.jit`.

Derived-default semantics faithfully mirror the reference: the derived fields
(`descriptor_radius = resolution*8`, `normal_radius = resolution*6`,
`inlier_threshold = resolution*5`, `max_correspondence_distance =
inlier_threshold*2`) are evaluated from the *defaults* at construction time
only — overriding `resolution` alone does NOT re-derive them
(map_merge_3d/src/map_merging.cpp:10-98 parses each field independently).
Use `MergeParams.derived(resolution=...)` to opt into re-derivation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from mapmerge_tpu.core.enums import (
    Descriptor,
    EstimationMethod,
    Keypoint,
    from_string,
)

_DEFAULT_RESOLUTION = 0.1


@dataclasses.dataclass(frozen=True)
class MergeParams:
    """All tunables for N-map transform estimation + compositing.

    Field-for-field parity with the reference struct
    (map_merging.h:29-44); capacity fields are new (static shapes).
    """

    # ---- reference tunables (map_merging.h:29-44) ----
    resolution: float = _DEFAULT_RESOLUTION
    descriptor_radius: float = _DEFAULT_RESOLUTION * 8.0
    outliers_min_neighbours: int = 50
    normal_radius: float = _DEFAULT_RESOLUTION * 6.0
    keypoint_type: Keypoint = Keypoint.SIFT
    keypoint_threshold: float = 5.0
    descriptor_type: Descriptor = Descriptor.PFH
    estimation_method: EstimationMethod = EstimationMethod.MATCHING
    refine_transform: bool = True
    inlier_threshold: float = _DEFAULT_RESOLUTION * 5.0
    max_correspondence_distance: float = _DEFAULT_RESOLUTION * 5.0 * 2.0
    max_iterations: int = 500
    matching_k: int = 5
    transform_epsilon: float = 1e-2
    confidence_threshold: float = 0.0
    output_resolution: float = 0.05

    # ---- capacity knobs (static shapes; no reference analog) ----
    #: padded per-cloud point capacity at registration resolution
    max_points: int = 65536
    #: padded keypoint / descriptor capacity per cloud
    max_keypoints: int = 1024
    #: neighbor cap for gather-based descriptor neighborhoods
    max_neighbors: int = 64
    #: batched RANSAC hypothesis count (replaces PCL's sequential iterations,
    #: reference matching.cpp:119-124 via SampleConsensusModelRegistration)
    ransac_hypotheses: int = 1024
    #: batched SAC-IA hypothesis count — the batched analog of the
    #: reference's sequential max_iterations for SAC_IA (matching.cpp:159-173);
    #: hypotheses are batched matmul work, so the default is generous
    sacia_hypotheses: int = 4096
    #: query tile size for the dense tiled neighbor engine
    neighbor_tile: int = 1024
    #: weight merge-graph edges by coverage^2/score instead of the
    #: reference's raw 1/score (map_merging.cpp:265-268) — prevents
    #: low-overlap false alignments from outranking genuine edges in the
    #: max spanning tree; set False for strict reference parity
    robust_confidence: bool = True
    #: SIFT scale-space shape (reference features.cpp:92: 3 octaves x 3 scales)
    sift_octaves: int = 3
    sift_scales_per_octave: int = 3
    #: per-iteration shrink factor of the ICP correspondence bound
    #: (coarse-to-fine, ops/icp.py); 1.0 = strict PCL fixed-bound semantics
    icp_anneal: float = 0.85
    #: neighbor engine: "dense" (exact O(Q*P) tiled sweeps), "grid"
    #: (hash-grid bounded scans, ops/grid.py — the scale path), or "auto"
    #: (grid above neighbors.GRID_AUTO_THRESHOLD points)
    neighbor_engine: str = "auto"
    #: max candidates read per hash bucket under the grid engine; overflow
    #: is detected and surfaced (CloudFeatures.scan_overflow), never silent
    grid_scan_cap: int = 128
    #: after MST chaining, relax ALL confident pairwise edges with a damped
    #: Gauss-Newton on SE(3) (graph/pose_graph.py) — the batched pair stage
    #: registers every pair anyway, while the reference discards all but
    #: N-1 of them (map_merging.cpp:137-186); False = strict MST chaining
    global_refinement: bool = True

    def __post_init__(self):
        if isinstance(self.keypoint_type, str) and not isinstance(
            self.keypoint_type, Keypoint
        ):
            object.__setattr__(
                self, "keypoint_type", from_string(Keypoint, self.keypoint_type)
            )
        if isinstance(self.descriptor_type, str) and not isinstance(
            self.descriptor_type, Descriptor
        ):
            object.__setattr__(
                self, "descriptor_type", from_string(Descriptor, self.descriptor_type)
            )
        if isinstance(self.estimation_method, str) and not isinstance(
            self.estimation_method, EstimationMethod
        ):
            object.__setattr__(
                self,
                "estimation_method",
                from_string(EstimationMethod, self.estimation_method),
            )

    @property
    def registration_scan_cap(self) -> int:
        """Bucket capacity for the pair-stage grids (ICP correspondence,
        transform score). Their cells are max_correspondence_distance wide
        — much wider than the feature-stage cells — so they get twice the
        feature-stage cap (and never less than 256)."""
        return max(256, self.grid_scan_cap * 2)

    # ---- construction helpers ----
    @classmethod
    def strict_parity(cls, **overrides: Any) -> "MergeParams":
        """Params with every behavior-deviating default switched off.

        The stock defaults deviate from the reference in exactly three
        ways, all opt-out improvements:
          - `robust_confidence=True`: graph edges weighted by
            coverage^2/score * inliers instead of the raw 1/score
            (map_merging.cpp:265-268);
          - `icp_anneal=0.85`: coarse-to-fine ICP correspondence bound
            instead of PCL's fixed max_correspondence_distance
            (matching.cpp:204-220);
          - `global_refinement=True`: pose-graph relaxation over all
            confident edges after the reference's MST-only chaining
            (map_merging.cpp:137-186).
        This constructor restores strict reference semantics for all (the
        parity path is e2e-tested in tests/test_pipeline_e2e.py).
        """
        base = dict(
            robust_confidence=False, icp_anneal=1.0, global_refinement=False
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def derived(cls, resolution: float = _DEFAULT_RESOLUTION, **overrides: Any):
        """Build params with radii re-derived from `resolution`.

        Convenience the reference lacks (its derivation runs only at default
        time, map_merging.h:29-38); explicit overrides still win.
        """
        derived_fields = dict(
            resolution=resolution,
            descriptor_radius=resolution * 8.0,
            normal_radius=resolution * 6.0,
            inlier_threshold=resolution * 5.0,
            max_correspondence_distance=resolution * 10.0,
        )
        if "inlier_threshold" in overrides and (
            "max_correspondence_distance" not in overrides
        ):
            derived_fields["max_correspondence_distance"] = (
                overrides["inlier_threshold"] * 2.0
            )
        derived_fields.update(overrides)
        return cls(**derived_fields)

    @classmethod
    def command_line_overrides(cls, argv: list[str]) -> dict[str, Any]:
        """Extract `--param value` field overrides from argv, mirroring
        MapMergingParams::fromCommandLine (map_merging.cpp:10-54): each field
        is parsed independently against the defaults (no re-derivation)."""
        overrides: dict[str, Any] = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg.startswith("--"):
                name = arg[2:]
                if name in fields and i + 1 < len(argv):
                    raw = argv[i + 1]
                    overrides[name] = _parse_field(fields[name], raw)
                    i += 2
                    continue
            i += 1
        # mirror reference: matching_k only overridden when > 0
        # (map_merging.cpp:44-47)
        if "matching_k" in overrides and overrides["matching_k"] <= 0:
            del overrides["matching_k"]
        return overrides

    @classmethod
    def from_command_line(cls, argv: list[str]) -> "MergeParams":
        """Params from `--param value` CLI args (map_merging.cpp:10-54)."""
        return cls(**cls.command_line_overrides(argv))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MergeParams":
        """Params from a mapping (the ROS-params analog,
        map_merging.cpp:56-98); unknown keys are ignored."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        overrides = {
            k: _parse_field(fields[k], v) for k, v in d.items() if k in fields
        }
        if "matching_k" in overrides and overrides["matching_k"] <= 0:
            del overrides["matching_k"]
        return cls(**overrides)

    def replace(self, **overrides: Any) -> "MergeParams":
        return dataclasses.replace(self, **overrides)

    def __str__(self) -> str:
        # pretty-print parity with operator<< (map_merging.cpp:100-123)
        lines = [
            f"{f.name}: {getattr(self, f.name)}"
            for f in dataclasses.fields(self)
        ]
        return "\n".join(lines)


def _parse_field(field: dataclasses.Field, raw: Any) -> Any:
    if field.type in ("float", float):
        return float(raw)
    if field.type in ("int", int):
        return int(raw)
    if field.type in ("bool", bool):
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    if field.name == "keypoint_type":
        return from_string(Keypoint, raw) if isinstance(raw, str) else raw
    if field.name == "descriptor_type":
        return from_string(Descriptor, raw) if isinstance(raw, str) else raw
    if field.name == "estimation_method":
        return from_string(EstimationMethod, raw) if isinstance(raw, str) else raw
    return raw
