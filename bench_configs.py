"""Eval configs #2-#5 (BASELINE.json "configs").

Each config prints ONE JSON line naming the devices it ran on:

  config1_pfh: the bench.py pair at the reference's default SIFT+PFH-125
  config2:     5-map ~500k-pt all-pairs merge, 1 chip (grid engine)
  config3:     1000-hypothesis RANSAC registration on a ~2M-pt LiDAR-style map
  config5:     50-map online stream through MapMergeNode
  config5_big: 50 x ~500k-pt maps streamed through the incremental node

Every config carries an accuracy gate (the bench.py pattern): a fast wrong
answer fails the run. Every config runs on the GPU only and in this one
process. The 20-map mesh fixture (bench_fixtures.config4_fixture) is run
by `chip_smoke.py --four`.

Usage: python bench_configs.py config2 [config3 ...]   (no args = all)
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from bench_fixtures import (
    big_params,
    check_chain,
    check_golden,
    pose_err,
    require_gpu,
    stream_params,
    town_views,
)


def emit(record: dict) -> None:
    record.update(require_gpu())
    print(json.dumps(record), flush=True)


def check_adjacent(transforms, truths, rot_tol, trans_tol, min_ok):
    """Gate on ADJACENT-pair relative poses: with N views around a circle
    the graph is a ~N/2-hop chain, and per-hop RANSAC error accumulates
    into end-to-end drift (the reference chains identically,
    map_merging.cpp:177-183) — so quality is judged per hop, and the
    end-to-end drift is reported as a metric, not gated."""
    n_ok, errs = 0, []
    for i in range(len(truths) - 1):
        ta, tb = transforms[i], transforms[i + 1]
        if not (np.asarray(ta).any() and np.asarray(tb).any()):
            continue
        rel = np.linalg.inv(ta) @ tb
        truth_rel = np.linalg.inv(truths[i]) @ truths[i + 1]
        rot, trans = pose_err(rel, truth_rel.astype(np.float32))
        errs.append((rot, trans))
        if rot < rot_tol and trans < trans_tol:
            n_ok += 1
    assert n_ok >= min_ok, (
        f"adjacent-pair gate: only {n_ok} pairs ok ({errs[:8]}...)"
    )
    return errs


def end_to_end_drift(transforms, truths):
    """Worst relative-pose error vs truth over registered maps (deg, m)."""
    ok = [i for i in range(len(truths)) if np.asarray(transforms[i]).any()]
    if len(ok) < 2:
        return None
    a = ok[0]
    inv_ta = np.linalg.inv(transforms[a])
    inv_truth_a = np.linalg.inv(truths[a])
    worst = (0.0, 0.0)
    for i in ok:
        rot, trans = pose_err(
            inv_ta @ transforms[i],
            (inv_truth_a @ truths[i]).astype(np.float32),
        )
        worst = max(worst, (rot, trans))
    return [round(worst[0], 2), round(worst[1], 3)]


def config1_pfh():
    """The REFERENCE's default operating point (map_merging.h:35:
    SIFT keypoints + PFH-125 descriptors) at eval-config-#1 scale — the
    headline bench (bench.py) runs FPFH; this line shows what the
    reference's own defaults cost on the same 50k-pt pair (VERDICT r4
    missing 6). Same fixture, same gates, descriptor swapped."""
    from bench import build_views, bench_params
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    va, vb, truth = build_views()
    params = bench_params().replace(descriptor_type="PFH")

    transforms = estimate_maps_transforms([va, vb], params, seed=0)  # warm
    rot_err, trans_err = pose_err(
        np.linalg.inv(transforms[0]) @ transforms[1], truth
    )
    assert rot_err < 1.0 and trans_err < 0.1, (
        f"accuracy gate failed: rot {rot_err} deg, trans {trans_err} m"
    )
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        estimate_maps_transforms([va, vb], params, seed=0)
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls))
    emit(
        {
            "config": "config1_pfh_reference_default",
            "metric": "50k-pt pair end-to-end at the reference's DEFAULT "
            "operating point (SIFT+PFH-125), 1 chip, median of 5",
            "value": round(1.0 / med, 4),
            "unit": "pairs/s",
            "median_s": round(med, 4),
            "min_s": round(min(walls), 4),
            "max_s": round(max(walls), 4),
            "pose_err_deg_m": [round(rot_err, 3), round(trans_err, 4)],
        }
    )


def config2():
    """5-map ~500k-pt all-pairs merge on one chip (grid engine)."""
    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    views, truths = town_views(5, view_resized_target=500_000)
    sizes = [len(v[0]) for v in views]
    cap = 1 << int(np.ceil(np.log2(max(sizes))))
    clouds = [PointCloud.from_arrays(x, r, capacity=cap) for x, r in views]
    # raw capacity covers the input; the registration-resolution cloud is
    # bounded separately (resized ~500k -> 2^20 keeps padding waste low)
    params = big_params(min(cap, 1 << 20))

    estimate_maps_transforms(clouds, params, seed=0)  # compile warm-up
    t0 = time.perf_counter()
    transforms = estimate_maps_transforms(clouds, params, seed=0)
    wall = time.perf_counter() - t0
    check_chain(transforms, truths, rot_tol=2.0, trans_tol=0.3, min_ok=4)

    # vs the frozen CPU-oracle baseline (scripts/run_oracle.py config2:
    # the faithful scipy-cKDTree reimplementation of the reference pipeline
    # on the IDENTICAL fixture + params), with a pose gate against its
    # golden poses — the same protocol as bench.py/config1
    golden, _ = check_golden(transforms, "config2", rot_tol=2.0, trans_tol=0.3)
    emit({
        "config": "config2_5map_500k",
        "metric": "5-map all-pairs merge wall-clock (1 chip, warm)",
        "cloud_points": sizes,
        "value": round(wall, 2),
        "unit": "s",
        "maps_per_min": round(5 * 60.0 / wall, 2),
        "oracle_wall_s": golden["wall_seconds"],
        "vs_baseline": round(golden["wall_seconds"] / wall, 2),
    })


def config3():
    """1000-hypothesis RANSAC registration on a ~2M-pt LiDAR-style pair."""
    import jax

    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.pipeline.features import extract_features
    from mapmerge_tpu.pipeline.registration import estimate_transform

    views, truths = town_views(2, view_resized_target=800_000, keep=0.75, seed=9)
    sizes = [len(v[0]) for v in views]
    cap = 1 << int(np.ceil(np.log2(max(sizes))))
    clouds = [PointCloud.from_arrays(x, r, capacity=cap) for x, r in views]
    params = big_params(1 << 20).replace(ransac_hypotheses=1024)

    fa = extract_features(clouds[0], params)  # compile warm-up
    fb = extract_features(clouds[1], params)
    jax.block_until_ready(
        estimate_transform(fa, fb, params, jax.random.key(0)).transform
    )

    t0 = time.perf_counter()
    fa = extract_features(clouds[0], params)
    fb = extract_features(clouds[1], params)
    est = estimate_transform(fa, fb, params, jax.random.key(0))
    jax.block_until_ready(est.transform)
    wall = time.perf_counter() - t0

    truth_rel = np.linalg.inv(truths[1]) @ truths[0]
    rot, trans = pose_err(np.asarray(est.transform), truth_rel)
    assert rot < 2.0 and trans < 0.3, f"accuracy gate: {rot} deg {trans} m"
    emit(
        {
            "config": "config3_2M_ransac1000",
            "metric": "2M-pt pair registration incl. features, 1024-hypothesis "
            "RANSAC + ICP (1 chip, warm)",
            "cloud_points": sizes,
            "value": round(wall, 2),
            "unit": "s",
            "pose_err_deg_m": [round(rot, 3), round(trans, 4)],
        }
    )


def config5():
    """50-map online stream through MapMergeNode."""
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import InProcTransport

    views, truths = town_views(50, view_resized_target=2048, seed=5)
    params = stream_params()
    transport = InProcTransport()
    node = MapMergeNode(transport, params=params, seed=0)

    t0 = time.perf_counter()
    # stream maps in (robots joining over time), re-estimating as they come
    batch = 10
    est_ticks = 0
    for start in range(0, 50, batch):
        for i in range(start, start + batch):
            transport.publish(f"robot_{i:02d}", views[i][0], views[i][1])
        node.discovery()
        node.transforms_estimation()
        node.map_compositing()
        est_ticks += 1
    wall = time.perf_counter() - t0

    transforms = node.get_transforms()
    ok = sum(1 for t in transforms.values() if t.any())
    assert len(transforms) == 50, len(transforms)
    assert ok >= 35, f"accuracy gate: only {ok}/50 maps registered"
    ordered = [transforms[f"robot_{i:02d}"] for i in range(50)]
    check_adjacent(ordered, truths, rot_tol=8.0, trans_tol=0.5, min_ok=38)
    drift = end_to_end_drift(ordered, truths)
    # refined pose graph must hold end-to-end (VERDICT r2 item 3 gate)
    assert drift[0] < 10.0 and drift[1] < 0.5, f"drift gate: {drift}"
    merged = node.get_merged_map()
    assert merged is not None and int(merged.count) > 1000
    emit(
        {
            "config": "config5_50map_stream",
            "metric": "50-map online stream: 5 estimation ticks x growing "
            "robot set through MapMergeNode",
            "value": round(wall, 2),
            "unit": "s",
            "maps_registered": ok,
            "est_ticks": est_ticks,
            "maps_per_sec": round(50.0 / wall, 3),
            "end_to_end_drift_deg_m": drift,
        }
    )


def config5_big():
    """THE north-star config (BASELINE.json): 50 x ~half-million-pt maps
    streamed through the online node on one chip, >= 10x the CPU oracle at
    gated accuracy.

    The node runs in incremental register-to-world mode
    (pipeline/incremental.py): features are extracted once per map and new
    maps localize against the world model — the batched answer to the
    reference's per-tick stateless O(N^2) re-estimation.

    vs_baseline protocol (VERDICT r2 item 1 allows a documented
    subset-scaled oracle): the scipy-cKDTree oracle (the faithful
    reference-pipeline implementation, mapmerge_tpu/oracle.py) is MEASURED
    in this same run on 2 of the 50 maps (features) and 1 pair
    (matching + RANSAC + ICP + score), then scaled to ONE offline
    all-pairs merge: 50 x t_features + C(50,2) x t_pair. That is the
    CHEAPEST work a reference-style merge of these maps can do — the
    reference node actually re-runs all of it on every estimation tick
    (map_merge_node.cpp:141-142), so the reported ratio is a lower bound.
    """
    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import InProcTransport

    n_maps = 50
    # ~500k RAW points per view (config2 protocol: raw size names the map)
    views, truths = town_views(n_maps, view_resized_target=200_000, keep=0.8,
                               seed=5)
    raw_sizes = [len(v[0]) for v in views]
    cap = 1 << int(np.ceil(np.log2(max(raw_sizes))))
    params = MergeParams(
        keypoint_type="SIFT", keypoint_threshold=3.0,
        descriptor_type="FPFH", refine_transform=True, max_iterations=30,
        max_points=cap, max_keypoints=384, max_neighbors=32,
        ransac_hypotheses=768, neighbor_tile=1024,
    )

    # ---- oracle subset measurement (CPU, same fixture + params) ----
    from mapmerge_tpu.oracle import (
        estimate_transform_np,
        extract_features_np,
    )

    t0 = time.perf_counter()
    of_a = extract_features_np(views[0][0], views[0][1], params)
    of_b = extract_features_np(views[1][0], views[1][1], params)
    t_feat = (time.perf_counter() - t0) / 2.0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    estimate_transform_np(of_a, of_b, params, rng)
    t_pair = time.perf_counter() - t0
    oracle_wall = n_maps * t_feat + (n_maps * (n_maps - 1) // 2) * t_pair

    # ---- the stream on the chip ----
    transport = InProcTransport()
    node = MapMergeNode(
        transport, params=params, seed=0, incremental=True, max_robots=64
    )
    t0 = time.perf_counter()
    batch = 5
    for start in range(0, n_maps, batch):
        for i in range(start, start + batch):
            transport.publish(f"robot_{i:02d}", views[i][0], views[i][1])
        node.discovery()
        node.transforms_estimation()
    node.map_compositing()
    wall = time.perf_counter() - t0

    transforms = node.get_transforms()
    ok = sum(1 for t in transforms.values() if t.any())
    assert len(transforms) == n_maps, len(transforms)
    assert ok >= 45, f"accuracy gate: only {ok}/{n_maps} maps registered"
    ordered = [transforms[f"robot_{i:02d}"] for i in range(n_maps)]
    check_adjacent(ordered, truths, rot_tol=5.0, trans_tol=0.5, min_ok=40)
    drift = end_to_end_drift(ordered, truths)
    # loop closures + map-radius-scaled pose-graph refinement (r5) hold
    # the stream to 0.28 deg / 0.10 m measured; gate at the VERDICT r4
    # item 3 target, tighter than r4's observed 0.65/0.28
    assert drift[0] < 0.5 and drift[1] < 0.25, f"drift gate: {drift}"
    merged = node.get_merged_map()
    assert merged is not None and int(merged.count) > 10000
    vs = oracle_wall / wall
    emit(
        {
            "config": "config5_big_50map_500k",
            "metric": "50-map ~500k-pt online stream, incremental "
            "register-to-world on 1 chip",
            "raw_points_per_map": [min(raw_sizes), max(raw_sizes)],
            "value": round(wall, 2),
            "unit": "s",
            "maps_registered": ok,
            "maps_per_min": round(n_maps * 60.0 / wall, 2),
            "end_to_end_drift_deg_m": drift,
            "oracle_wall_est_s": round(oracle_wall, 1),
            # Unrounded components so oracle_wall_est_s is reproducible
            # from this line alone (ADVICE r3): est = n*t_feat + C(n,2)*t_pair.
            "oracle_t_feat_s": t_feat,
            "oracle_t_pair_s": t_pair,
            "oracle_protocol": (
                f"measured on this run: features {t_feat:.4f}s/cloud x "
                f"{n_maps} + pair {t_pair:.4f}s x "
                f"{n_maps * (n_maps - 1) // 2} (one offline all-pairs "
                "merge; the reference node redoes this every tick)"
            ),
            "vs_baseline": round(vs, 2),
        }
    )
    assert vs >= 10.0, f"north-star gate: vs_baseline {vs:.1f} < 10"


if __name__ == "__main__":
    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    which = sys.argv[1:] or ["config2", "config3", "config5"]
    for name in which:
        globals()[name]()
