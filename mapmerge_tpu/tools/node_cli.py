"""Online merge node launcher.

Equivalent of the reference's map_merge_node executable + launch files
(src/map_merge_node.cpp:253-267, launch/map_merge.launch,
launch/from_pcds.launch): runs the MapMergeNode over a directory transport
(each `<robot>.pcd` in --watch-dir is a robot's latest published map —
overwrite the file to publish an update), periodically writing the latched
merged map to --output and printing pose updates (the tf-broadcast analog).

Usage:
  python -m mapmerge_tpu.tools.node_cli --watch-dir maps/ \
      [--config params.yaml|json] [--output merged.pcd]
      [--compositing-rate 0.3] [--discovery-rate 0.05]
      [--estimation-rate 0.01] [--param value ...]

`--config` sources everything (node rates, watch dir, output, every merge
param) from one YAML/JSON file — the analog of the reference's
launch/map_merge.launch:1-15, which feeds node rates and private params to
the node from a single launch file. Explicit CLI flags override the file.
"""

from __future__ import annotations

import signal
import sys
import time

import numpy as np

#: node-level keys a config file may set (map_merge.launch:5-13 analog:
#: rates + topology; everything else in the file is a MergeParams field)
NODE_KEYS = (
    "watch_dir",
    "output",
    "compositing_rate",
    "discovery_rate",
    "estimation_rate",
    "run_seconds",
)


def load_config(path: str) -> dict:
    """Read a YAML or JSON params file into a flat dict."""
    import json

    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError(f"config {path}: expected a mapping at top level")
    return data


def resolve_config(argv: list[str]):
    """Resolve node settings + merge params from CLI args and an optional
    `--config` YAML/JSON file. CLI flags override file values, which
    override defaults (launch-file semantics: map_merge.launch sources
    rates + private params once; the CLI can still tweak fields on top).

    Returns (node_settings dict, MergeParams)."""
    from mapmerge_tpu.core.params import MergeParams

    cfg: dict = {}
    if "--config" in argv:
        cfg = load_config(argv[argv.index("--config") + 1])

    def opt(name: str, default):
        if name in argv:
            return type(default)(argv[argv.index(name) + 1])
        key = name[2:].replace("-", "_")
        if key in cfg:
            return type(default)(cfg[key])
        return default

    node_settings = dict(
        watch_dir=opt("--watch-dir", ""),
        output=opt("--output", "merged.pcd"),
        compositing_rate=opt("--compositing-rate", 0.3),
        discovery_rate=opt("--discovery-rate", 0.05),
        estimation_rate=opt("--estimation-rate", 0.01),
        run_seconds=opt("--run-seconds", 0.0),  # 0 = until SIGINT
    )
    merge_cfg = {k: v for k, v in cfg.items() if k not in NODE_KEYS}
    merge_cfg.update(MergeParams.command_line_overrides(argv))
    return node_settings, MergeParams.from_dict(merge_cfg)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    settings, params = resolve_config(argv)
    watch_dir = settings["watch_dir"]
    if not watch_dir:
        print("--watch-dir is required", file=sys.stderr)
        return 1
    output = settings["output"]
    rates = {
        k: settings[k]
        for k in ("compositing_rate", "discovery_rate", "estimation_rate")
    }
    run_seconds = settings["run_seconds"]

    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from mapmerge_tpu.io.pcd import write_pcd
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import DirectoryTransport

    print(params)

    def on_pose(robot: str, t: np.ndarray):
        trans = t[:3, 3] if t.any() else None
        print(f"[tf] {robot}: {'FAILED' if trans is None else trans}", flush=True)

    node = MapMergeNode(
        DirectoryTransport(watch_dir),
        params=params,
        pose_callback=on_pose,
        **rates,
    )

    stop = {"flag": False}
    signal.signal(signal.SIGINT, lambda *_: stop.__setitem__("flag", True))
    signal.signal(signal.SIGTERM, lambda *_: stop.__setitem__("flag", True))

    deadline = time.time() + run_seconds if run_seconds else None
    last_stamp = 0.0
    with node:
        print(f"watching {watch_dir} (Ctrl-C to stop)", flush=True)
        while not stop["flag"]:
            if deadline and time.time() > deadline:
                break
            merged = node.get_merged_map()
            stamp = node._merged_stamp
            if merged is not None and stamp > last_stamp:
                xyz, rgb = merged.to_arrays()
                write_pcd(output, (xyz, rgb))
                print(
                    f"[map] wrote {len(xyz)} points -> {output} "
                    f"(robots: {node.get_robots()})",
                    flush=True,
                )
                last_stamp = stamp
            time.sleep(0.5)
    print("node stopped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
