"""Offline N-map merge CLI.

Equivalent of the reference's map_merge_tool (src/map_merge_tool.cpp:8-55):
load >= 2 .pcd files, estimate transforms, print them, compose the global
map, write output.pcd. Params use the same `--name value` CLI format
(MergeParams.from_command_line, mirroring map_merging.cpp:10-54), plus
`--output` (default output.pcd, a fixed name in the reference) and
`--mesh` to shard the pair axis over all visible devices.

Usage:
  python -m mapmerge_tpu.tools.merge_tool map1.pcd map2.pcd \
      [--resolution 0.1 --descriptor_type PFH ...] [--output out.pcd]
"""

from __future__ import annotations

import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    pcd_files = [a for a in argv if a.endswith(".pcd")]
    output = "output.pcd"
    if "--output" in argv:
        output = argv[argv.index("--output") + 1]
        if output in pcd_files:
            pcd_files.remove(output)
    if len(pcd_files) < 2:
        print(
            "usage: merge_tool map1.pcd map2.pcd [...] [--param value ...]",
            file=sys.stderr,
        )
        return 1

    import jax

    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.io.pcd import read_pcd_arrays, write_pcd
    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.pipeline.merging import (
        compose_maps,
        estimate_maps_transforms,
    )

    params = MergeParams.from_command_line(argv)
    print(params)

    clouds = []
    cap = 0
    raw = []
    for path in pcd_files:
        xyz, rgb = read_pcd_arrays(path)
        print(f"loaded {path}: {len(xyz)} points")
        raw.append((xyz, rgb))
        cap = max(cap, len(xyz))
    for xyz, rgb in raw:
        clouds.append(PointCloud.from_arrays(xyz, rgb, capacity=cap))

    mesh = None
    if "--mesh" in argv and len(jax.devices()) > 1:
        from mapmerge_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
        print(f"sharding pairs over {mesh.devices.size} devices")

    print("estimating transforms...")
    transforms = estimate_maps_transforms(clouds, params, mesh=mesh)

    # the reference passes estimateMapsTransforms' result straight to
    # composeMaps, which throws on size mismatch (possible when trailing
    # clouds had no keypoints); pad with zero (= failed) transforms instead
    while len(transforms) < len(clouds):
        transforms.append(np.zeros((4, 4), np.float32))

    for i, t in enumerate(transforms):
        print(f"transform for map {i} ({pcd_files[i]}):")
        print(np.array2string(np.asarray(t), precision=6, suppress_small=True))

    print("compositing...")
    merged = compose_maps(clouds, transforms, params.output_resolution)
    if merged is None:
        print("nothing to compose", file=sys.stderr)
        return 1
    xyz, rgb = merged.to_arrays()
    write_pcd(output, (xyz, rgb))
    print(f"merged map: {len(xyz)} points -> {output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
