"""Metrics/observability subsystem (utils/metrics.py + node integration).

The reference's only observability is ROS logging + the transformScore
scalar (SURVEY.md §5); these tests pin the structured replacement: a
thread-safe registry, per-job timing on the node, and the JSONL sink.
"""

import json
import threading

import numpy as np

from mapmerge_tpu.utils.metrics import (
    JsonlMetricsSink,
    MetricsRegistry,
    read_jsonl,
)


def test_registry_counters_gauges_timings():
    m = MetricsRegistry()
    m.inc("a")
    m.inc("a", by=4)
    m.set_gauge("g", 7.5)
    m.observe("t", 0.5)
    m.observe("t", 1.5)
    snap = m.snapshot()
    assert snap["counters"]["a"] == 5
    assert snap["gauges"]["g"] == 7.5
    t = snap["timings"]["t"]
    assert t["count"] == 2
    assert abs(t["mean_s"] - 1.0) < 1e-9
    assert t["min_s"] == 0.5 and t["max_s"] == 1.5 and t["last_s"] == 1.5


def test_registry_time_stage_and_thread_safety():
    m = MetricsRegistry()

    def work():
        for _ in range(200):
            m.inc("n")
            with m.time_stage("stage"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = m.snapshot()
    assert snap["counters"]["n"] == 800
    assert snap["timings"]["stage"]["count"] == 800


def test_jsonl_sink_roundtrip(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    sink = JsonlMetricsSink(path)
    sink.write({"tick": 0, "wall_s": 0.1})
    sink.write({"tick": 1, "wall_s": 0.2})
    rows = read_jsonl(path)
    assert [r["tick"] for r in rows] == [0, 1]


def _two_view_node(tmp_path=None, **node_kwargs):
    from synthetic import make_scene, overlapping_views, rotation_z, se3

    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import InProcTransport

    rng = np.random.default_rng(0)
    xyz, rgb = make_scene(rng, n_boxes=6, extent=8.0, density=40.0)
    truth = se3(rotation_z(0.3), [0.8, -0.3, 0.1])
    va, vb = overlapping_views(np.random.default_rng(1), xyz, rgb, truth)
    params = MergeParams(
        keypoint_type="HARRIS",
        descriptor_type="FPFH",
        refine_transform=False,
        max_points=4096,
        max_keypoints=128,
        max_neighbors=32,
        ransac_hypotheses=256,
        neighbor_tile=256,
    )
    transport = InProcTransport()
    transport.publish("robot_a", np.asarray(va.xyz)[np.asarray(va.mask)],
                      np.asarray(va.rgb)[np.asarray(va.mask)])
    transport.publish("robot_b", np.asarray(vb.xyz)[np.asarray(vb.mask)],
                      np.asarray(vb.rgb)[np.asarray(vb.mask)])
    node = MapMergeNode(transport, params=params, seed=0, **node_kwargs)
    return node


def test_node_metrics_and_sink(tmp_path):
    log = str(tmp_path / "node_metrics.jsonl")
    node = _two_view_node(metrics_log=log)
    node.discovery()
    node.transforms_estimation()
    node.map_compositing()

    snap = node.get_metrics()
    assert snap["gauges"]["robots_known"] == 2
    assert snap["counters"]["robots_discovered"] == 2
    assert snap["timings"]["discovery"]["count"] == 1
    assert snap["timings"]["estimation"]["count"] == 1
    assert snap["timings"]["compositing"]["count"] == 1
    assert snap["timings"]["estimation"]["last_s"] > 0
    assert snap["gauges"]["maps_registered"] == 2
    assert snap["gauges"]["maps_failed"] == 0
    assert snap["gauges"]["merged_points"] > 100

    rows = read_jsonl(log)
    assert len(rows) == 1
    rec = rows[0]
    assert rec["job"] == "estimation"
    assert rec["mode"] == "stateless"
    assert rec["maps_in"] == 2 and rec["maps_registered"] == 2
    assert rec["wall_s"] > 0
    # record is plain JSON (no numpy leakage)
    json.dumps(rec)

