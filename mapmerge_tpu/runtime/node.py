"""Online incremental merge node.

JAX equivalent of the reference's ROS node runtime (class MapMerge3d,
src/map_merge_node.cpp + include/map_merge_3d/map_merge_node.h): three
rate-decoupled periodic jobs —

  - discovery (default 0.05 Hz): find newly publishing robots via the
    transport (the topic-pattern scan, map_merge_node.cpp:57-100);
  - transforms estimation (default 0.01 Hz): full re-estimation from the
    latest map snapshot — stateless per tick, exactly like the reference
    (map_merge_node.cpp:133-153; re-estimating from scratch is what makes
    the design robust to drift and joining robots, SURVEY.md §5);
  - map compositing (default 0.3 Hz): cheap re-composition with the most
    recent (possibly stale) transforms (map_merge_node.cpp:105-131),
    aligned to the maps known at the last estimation (clouds.resize
    semantics, map_merge_node.cpp:114-116).

plus a pose publication hook (the tf-broadcast analog,
map_merge_node.cpp:231-249): subscribers receive (robot, 4x4 world pose)
updates; failed maps get a zero pose (doc/wiki.txt:183).

Snapshot isolation mirrors the reference's locking: transport snapshots
under its own lock, results under the node lock, the latest merged map
latched for late subscribers (the latched publisher, map_merge_node.cpp:28).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from mapmerge_tpu.core.cloud import PointCloud
from mapmerge_tpu.core.params import MergeParams
from mapmerge_tpu.pipeline.merging import compose_maps, estimate_maps_transforms
from mapmerge_tpu.runtime.transport import Transport
from mapmerge_tpu.utils.metrics import MetricsRegistry, maybe_sink


class MapMergeNode:
    def __init__(
        self,
        transport: Transport,
        params: Optional[MergeParams] = None,
        compositing_rate: float = 0.3,
        discovery_rate: float = 0.05,
        estimation_rate: float = 0.01,
        world_frame: str = "world",
        mesh=None,
        pose_callback: Optional[Callable[[str, np.ndarray], None]] = None,
        seed: int = 0,
        incremental: bool = False,
        max_robots: int = 64,
        metrics_log: Optional[str] = None,
    ):
        self.transport = transport
        self.params = params or MergeParams()
        self.rates = {
            "compositing": compositing_rate,
            "discovery": discovery_rate,
            "estimation": estimation_rate,
        }
        self.world_frame = world_frame
        self.mesh = mesh
        self.pose_callback = pose_callback
        self.seed = seed
        #: incremental register-to-world mode (pipeline/incremental.py):
        #: features cached per map version, new maps localized against the
        #: world model instead of stateless O(N^2) re-estimation. Default
        #: False = reference semantics (map_merge_node.cpp:141-142).
        self.incremental = incremental
        self._world = None
        self._max_robots = max_robots
        self._feat_cache: dict[str, tuple] = {}  # robot -> (stamp, features)

        self._lock = threading.Lock()
        self._robots: list[str] = []  # discovery order = node index order
        self._transforms: dict[str, np.ndarray] = {}
        self._estimated_robots: list[str] = []
        self._merged: Optional[PointCloud] = None
        self._merged_stamp: float = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._ticks = {"compositing": 0, "discovery": 0, "estimation": 0}
        self._stats = {"subsampled_points": 0}
        #: structured per-stage metrics (utils/metrics.py) — the
        #: observability layer the reference lacks (SURVEY.md §5: its only
        #: quantitative signal is transformScore + ROS_DEBUG logs). Every
        #: job tick records its wall-clock; estimation ticks additionally
        #: log one structured record to `metrics_log` (JSONL) when set.
        self.metrics = MetricsRegistry()
        self._metrics_sink = maybe_sink(metrics_log)

    # ---- public thread-safe accessors (map_merge_node.h:84-120) ----
    def get_robots(self) -> list[str]:
        with self._lock:
            return list(self._robots)

    def get_transforms(self) -> dict[str, np.ndarray]:
        with self._lock:
            return {k: v.copy() for k, v in self._transforms.items()}

    def get_merged_map(self) -> Optional[PointCloud]:
        with self._lock:
            return self._merged  # latched (map_merge_node.cpp:28-29)

    def get_metrics(self) -> dict:
        """Structured metrics snapshot: counters, gauges, and per-job
        timing summaries (utils/metrics.py)."""
        return self.metrics.snapshot()

    # ---- periodic jobs ----
    def discovery(self) -> None:
        with self.metrics.time_stage("discovery"):
            found = self.transport.discover()
            with self._lock:
                for robot in found:
                    if robot not in self._robots:
                        self._robots.append(robot)
                        self.metrics.inc("robots_discovered")
                self._ticks["discovery"] += 1
                self.metrics.set_gauge("robots_known", len(self._robots))

    def _snapshot_clouds(self, robots: list[str]):
        """Latest map per robot (two-level locking analog,
        map_merge_node.cpp:164-175)."""
        clouds = []
        kept = []
        for robot in robots:
            latest = self.transport.latest(robot)
            if latest is None:
                continue
            _, xyz, rgb = latest
            kept.append(robot)
            clouds.append((xyz, rgb))
        return kept, clouds

    def _fit_to_capacity(self, xyz, rgb, cap: int, robot: str):
        """Bound a raw cloud to `cap` points without silent geometry bias.

        Head-truncation (`x[:cap]`) keeps whatever points happen to come
        first in the message — a spatially biased cut. Instead take a
        uniform random subsample (deterministic per robot + node seed) and
        account for every dropped point in the node stats.
        """
        n = len(xyz)
        if n <= cap:
            return xyz, rgb, 0
        # zlib.crc32, not hash(): str hashes are salted per process, which
        # would make the subsample (and thus registration) run-dependent
        import zlib

        rng = np.random.default_rng(
            (zlib.crc32(f"{robot}/{self.seed}".encode()) & 0x7FFFFFFF) or 1
        )
        keep = rng.choice(n, size=cap, replace=False)
        keep.sort()
        return xyz[keep], None if rgb is None else rgb[keep], n - cap

    def get_stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def _global_maps(self, kept: list[str], raw: list):
        """Union of all hosts' snapshots when the node's mesh spans
        processes (per-host ingest -> cross-host exchange -> identical SPMD input
        on every host; parallel/multihost.py). Single-process: identity.

        COLLECTIVE in multi-process mode — every host's node must drive
        its estimation/compositing ticks in lockstep (the runner below is
        for single-process use; distributed deployments tick the jobs from
        a coordinator-driven loop)."""
        import jax

        if self.mesh is None or jax.process_count() == 1:
            return kept, raw
        from mapmerge_tpu.parallel import multihost

        merged = multihost.allgather_robot_maps(
            {r: c for r, c in zip(kept, raw)}
        )
        names = sorted(merged)
        return names, [merged[r] for r in names]

    def _transforms_estimation_incremental(self) -> None:
        """Incremental register-to-world estimation tick
        (pipeline/incremental.py): extract features only for new/updated
        maps, localize them against the world model, keep everyone else's
        pose. Not composed with multi-process meshes (the stateless path
        is; incremental state is per-node)."""
        from mapmerge_tpu.pipeline.incremental import WorldModel, features_for

        import jax

        if self._world is None:
            self._world = WorldModel(self.params, max_maps=self._max_robots)
        world = self._world

        robots = self.get_robots()
        cap = self.params.max_points
        updated: list[str] = []
        for robot in robots:
            latest = self.transport.latest(robot)
            if latest is None:
                continue
            stamp, xyz, rgb = latest
            cached = self._feat_cache.get(robot)
            if cached is not None and cached[0] == stamp:
                continue
            xyz, rgb, dropped = self._fit_to_capacity(xyz, rgb, cap, robot)
            if dropped:
                with self._lock:
                    self._stats["subsampled_points"] += dropped
            cloud = PointCloud.from_arrays(xyz, rgb, capacity=cap)
            self._feat_cache[robot] = (stamp, features_for(cloud, self.params))
            updated.append(robot)

        tick = self._ticks["estimation"]
        key = jax.random.key(self.seed)
        # seed the world: first known map is the reference frame
        # (identity), exactly like the single-cloud contract
        def _n_desc(robot: str) -> int:
            f = self._feat_cache[robot][1]
            return int(
                np.asarray(
                    (f.descriptors.valid & f.keypoints.mask).sum()
                )
            )

        seeded = None
        if not world.entries:
            # the seed anchors the world frame: pick the most featureful
            # map (an unfeatured/garbage map as anchor strands everyone)
            candidates = [r for r in robots if r in self._feat_cache]
            if candidates:
                robot = max(candidates, key=_n_desc)
                world.add(
                    robot, self._feat_cache[robot][1],
                    np.eye(4, dtype=np.float32),
                )
                seeded = robot
        # localize everything not yet registered, plus updated maps
        pending = [
            r for r in robots
            if r in self._feat_cache
            and r != seeded
            and (r not in world or r in updated)
        ]
        # a map may register only after a same-tick earlier map joined the
        # world (chains of views): retry until a round makes no progress
        for n_retry in range(max(2, len(pending))):
            still = []
            for robot in pending:
                feats = self._feat_cache[robot][1]
                import zlib

                k = jax.random.fold_in(
                    key,
                    zlib.crc32(f"{robot}/{tick}/{n_retry}".encode())
                    & 0x7FFFFFFF,
                )
                res = world.localize(feats, k)
                if res is None:
                    still.append(robot)
                    continue
                world.add(robot, feats, res.pose)
                world.add_edges(robot, res.edges)
            if not still or len(still) == len(pending):
                break  # done, or no progress this round
            pending = still

        # a lone anchor that attracted nobody may itself be the problem
        # (e.g. a degenerate map was the most featureful at seed time):
        # while the world holds just one map, re-anchoring is free — no
        # other pose depends on the frame yet
        if (
            len(world.entries) == 1
            and still
            and max(map(_n_desc, still)) > _n_desc(world.entries[0].name)
        ):
            from mapmerge_tpu.pipeline.incremental import WorldModel

            self._world = world = WorldModel(
                self.params, max_maps=self._max_robots
            )
            robot = max(still, key=_n_desc)
            world.add(
                robot, self._feat_cache[robot][1],
                np.eye(4, dtype=np.float32),
            )
            import zlib

            for other in [r for r in still if r != robot]:
                k = jax.random.fold_in(
                    key,
                    zlib.crc32(f"{other}/{tick}/reseed".encode())
                    & 0x7FFFFFFF,
                )
                res = world.localize(self._feat_cache[other][1], k)
                if res is not None:
                    world.add(other, self._feat_cache[other][1], res.pose)
                    world.add_edges(other, res.edges)

        # loop closure: relax the accumulated edge set (redundant edges
        # from top-2 localization) so stream drift is corrected in-stream,
        # not just bounded by pairwise quality (VERDICT r4 missing 3)
        if self.params.global_refinement:
            world.refine(self.params.confidence_threshold)
        self.metrics.set_gauge("world_edges", len(world.edges))
        self.metrics.set_gauge(
            "world_edges_ambiguous",
            sum(1 for e in world.edges if e.ambiguous),
        )

        with self._lock:
            self._transforms = {
                r: (
                    world.pose_of(r).copy()
                    if r in world
                    else np.zeros((4, 4), np.float32)
                )
                for r in robots
            }
            self._estimated_robots = list(robots)
            self._ticks["estimation"] += 1
        self._publish_poses()

    def transforms_estimation(self) -> None:
        """One estimation tick, instrumented: wall-clock, map counts, and
        registration outcomes land in `self.metrics` (and the JSONL sink
        when configured)."""
        t0 = time.perf_counter()
        with self.metrics.time_stage("estimation"):
            if self.incremental:
                self._transforms_estimation_incremental()
            else:
                self._transforms_estimation_stateless()
        wall = time.perf_counter() - t0
        with self._lock:
            transforms = dict(self._transforms)
            tick = self._ticks["estimation"]
            subsampled = self._stats["subsampled_points"]
        registered = sum(1 for t in transforms.values() if t.any())
        failed = len(transforms) - registered
        self.metrics.set_gauge("maps_registered", registered)
        self.metrics.set_gauge("maps_failed", failed)
        if self._metrics_sink is not None:
            self._metrics_sink.write(
                {
                    "ts": time.time(),
                    "job": "estimation",
                    "tick": tick,
                    "wall_s": round(wall, 4),
                    "mode": "incremental" if self.incremental else "stateless",
                    "maps_in": len(transforms),
                    "maps_registered": registered,
                    "maps_failed": failed,
                    "subsampled_points": subsampled,
                }
            )

    def _transforms_estimation_stateless(self) -> None:
        """Stateless full re-estimation (reference semantics,
        map_merge_node.cpp:141-142)."""
        robots = self.get_robots()
        kept, raw = self._snapshot_clouds(robots)
        # global exchange BEFORE the empty-guard: the collective must run
        # on every process even when this host has no maps yet
        kept, raw = self._global_maps(kept, raw)
        if len(kept) == 0:
            return
        cap = max(len(x) for x, _ in raw)
        cap = min(cap, self.params.max_points)
        clouds = []
        dropped_total = 0
        for robot, (x, r) in zip(kept, raw):
            x, r, dropped = self._fit_to_capacity(x, r, cap, robot)
            dropped_total += dropped
            clouds.append(PointCloud.from_arrays(x, r, capacity=cap))
        if dropped_total:
            with self._lock:
                self._stats["subsampled_points"] += dropped_total
            print(
                f"[estimation] input exceeds max_points={self.params.max_points}; "
                f"randomly subsampled {dropped_total} points this tick",
                flush=True,
            )
        info: dict = {}
        transforms = estimate_maps_transforms(
            clouds, self.params, seed=self.seed, mesh=self.mesh,
            info_out=info,
        )
        # ambiguity flags from registration time (PairEstimate.ambiguous):
        # a confidently-scored but structurally weak registration is an
        # operator-visible condition, not a silent one
        self.metrics.set_gauge("pairs_registered", info.get("n_pairs", 0))
        self.metrics.set_gauge("pairs_ambiguous", info.get("n_ambiguous", 0))
        if info.get("n_ambiguous"):
            self.metrics.inc(
                "ambiguous_registrations", info["n_ambiguous"]
            )
        with self._lock:
            self._transforms = {}
            for i, robot in enumerate(kept):
                t = (
                    transforms[i]
                    if i < len(transforms)
                    else np.zeros((4, 4), np.float32)
                )
                self._transforms[robot] = np.asarray(t, np.float32)
            self._estimated_robots = kept
            self._ticks["estimation"] += 1
        self._publish_poses()

    def map_compositing(self) -> None:
        with self.metrics.time_stage("compositing"):
            self._map_compositing_impl()
        merged = self.get_merged_map()
        if merged is not None:
            self.metrics.set_gauge("merged_points", int(merged.count))

    def _map_compositing_impl(self) -> None:
        with self._lock:
            est_robots = list(self._estimated_robots)
            transforms = {r: self._transforms.get(r) for r in est_robots}
        kept, raw = self._snapshot_clouds(self.get_robots())
        # collective first (lockstep across hosts), guards after
        kept, raw = self._global_maps(kept, raw)
        if not est_robots:
            return
        have = dict(zip(kept, raw))
        # align with the maps known at the last estimation
        # (clouds.resize semantics, map_merge_node.cpp:114-116)
        robots = [
            r for r in est_robots
            if r in have and transforms[r] is not None
        ]
        if not robots:
            return
        raw_sel = [have[r] for r in robots]
        cap = max(len(x) for x, _ in raw_sel)
        clouds = [
            PointCloud.from_arrays(x, r, capacity=cap) for x, r in raw_sel
        ]
        merged = compose_maps(
            clouds, [transforms[r] for r in robots],
            self.params.output_resolution,
        )
        with self._lock:
            self._merged = merged
            self._merged_stamp = time.time()
            self._ticks["compositing"] += 1

    def _publish_poses(self) -> None:
        if self.pose_callback is None:
            return
        for robot, t in self.get_transforms().items():
            # zero transform published as-is for failed maps (wiki.txt:183)
            self.pose_callback(robot, t)

    # ---- lifecycle ----
    def start(self) -> None:
        def loop(name: str, fn: Callable[[], None]):
            period = 1.0 / self.rates[name]
            while not self._stop.is_set():
                t0 = time.time()
                try:
                    fn()
                except Exception as e:  # keep the loop alive (spinner analog)
                    print(f"[{name}] error: {e}", flush=True)
                dt = time.time() - t0
                self._stop.wait(max(0.0, period - dt))

        jobs = {
            "discovery": self.discovery,
            "estimation": self.transforms_estimation,
            "compositing": self.map_compositing,
        }
        for name, fn in jobs.items():
            th = threading.Thread(
                target=loop, args=(name, fn), name=f"mapmerge-{name}",
                daemon=True,
            )
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30.0)
        self._threads.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
