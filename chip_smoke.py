"""Smoke run of the map-merge engine on the GPU.

Drives the main path once through the entry points a user calls
(estimate_maps_transforms, compose_maps, MapMergeNode) at the repo's real
sizes, and checks every answer against ground truth, the frozen CPU-oracle
poses (golden/) or the plain jnp reference:

  1 device   JAX's first device is a GPU (never falls back to the CPU)
  2 kernels  each Pallas kernel vs its plain jnp reference at real widths,
             timed against the plain version XLA compiles; descriptor
             matching at 1024 slots vs a numpy oracle
  3 pair     the bench.py 50k-pt pair (SIFT+FPFH+RANSAC+ICP), twice, then
             compose_maps
  4 fleet    config2's 5 maps of ~1.15M points (staged features, grid
             engine, per-pair jits)
  5 node     one estimation + compositing tick of MapMergeNode, stateless
             and incremental

With --four it runs only the paths that exist across four GPUs: the
sharded 20-map merge beside the same merge on one device, and staged
big-cloud features round-robined over the cards.

Every phase prints its wall time and compile time. The last line is one
JSON object naming the device; any failed phase exits non-zero before it.
One process drives the card(s).

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

_COMPILE_EVENTS = {
    "/jax/core/compile/backend_compile_duration": "compile",
    "/jax/core/compile/jaxpr_trace_duration": "trace",
    "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
}
_compile_s = {"compile": 0.0, "trace": 0.0, "lower": 0.0}


def _on_event(event: str, duration: float, **_) -> None:
    kind = _COMPILE_EVENTS.get(event)
    if kind is not None:
        _compile_s[kind] += duration


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's wall time and the compile time spent inside it."""
    before = dict(_compile_s)
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    spent = {k: _compile_s[k] - before[k] for k in _compile_s}
    print(
        f"[{name}] wall {wall:.3f} s, XLA/Triton compile {spent['compile']:.3f} s, "
        f"trace {spent['trace']:.3f} s, lower {spent['lower']:.3f} s",
        flush=True,
    )


def card_info() -> str:
    """The card's name and power limit from nvidia-smi, in a child process
    that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def check_device(n: int = 1):
    """Phase 1: the first n JAX devices are GPUs. Exits non-zero with a
    message otherwise; never falls back to the CPU."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no GPU found: {e}") from e
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); chip_smoke runs on a GPU only"
        )
    if len(devices) < n:
        raise SystemExit(f"need {n} GPUs, JAX found {len(devices)}")
    return devices[:n]


def _median_time(fn, *args, reps: int = 5) -> float:
    """Median wall of `reps` runs after one warm-up, each ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


# ------------------------------------------------------------ phase 2: kernels
def nn_data(n: int = 32768, seed: int = 0):
    """Q = P = n points in a 20 m room-sized box; a 70% target mask."""
    rng = np.random.default_rng(seed)
    q = (rng.random((n, 3)) * [20.0, 20.0, 3.0]).astype(np.float32)
    p = (rng.random((n, 3)) * [20.0, 20.0, 3.0]).astype(np.float32)
    return q, p, rng.random(n) < 0.7


def check_nn(idx_k, d2_k, idx_r, d2_r, q, p, mask) -> int:
    """Kernel vs reference 1-NN: indices equal except at distance ties,
    d2 to rtol 1e-5. A differing index counts as a tie when its own
    distance, recomputed in float32 direct-difference arithmetic, equals
    the reference minimum to float32 rounding. Returns the tie count."""
    np.testing.assert_allclose(d2_k, d2_r, rtol=1e-5)
    diff = np.nonzero(idx_k != idx_r)[0]
    if len(diff):
        pen = np.zeros(len(p), np.float32) if mask is None else np.where(
            mask, np.float32(0.0), np.float32(1.0e12)
        )
        d = q[diff] - p[idx_k[diff]]
        d_own = (d * d).sum(-1) + pen[idx_k[diff]]
        np.testing.assert_allclose(
            d_own, d2_r[diff], rtol=4 * np.finfo(np.float32).eps,
            err_msg="1-NN index differs from the reference off a tie",
        )
    return len(diff)


def spfh_dense_data(radius: float, seed: int = 0):
    """24,576 queries (512 keypoints x 48 neighbours) against 32,768
    candidates drawn from the bench scene's first view, with unit normals
    (the dense FPFH phase of the bench pair)."""
    from bench import build_views

    va, _, _ = build_views()
    xyz = np.asarray(va.xyz)[np.asarray(va.mask)]
    rng = np.random.default_rng(seed)
    cand = xyz[rng.choice(len(xyz), 32768, replace=False)]
    nrm = rng.normal(size=cand.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ok = rng.random(32768) < 0.95
    pick = rng.choice(32768, 512 * 48)
    return (
        cand[pick].reshape(192, 128, 3), nrm[pick].reshape(192, 128, 3),
        cand[None], nrm[None], ok[None], radius * radius,
    )


def spfh_grid_data(radius: float, b: int = 16, cq: int = 128, seed: int = 0):
    """The cell-tile shape _spfh_grid hands the sweep: B cells of Cq
    queries against their 27 neighbour cells of 128 slots each."""
    rng = np.random.default_rng(seed)
    m = 27 * 128
    q = (rng.random((b, cq, 3)) * radius).astype(np.float32)
    c = (rng.random((b, m, 3)) * 3 * radius - radius).astype(np.float32)
    c[:, :cq] = q  # the queries are grid points too (self hits)

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return q, unit((b, cq, 3)), c, unit((b, m, 3)), rng.random((b, m)) < 0.8, radius * radius


def _boundary_pairs(qx, qn, cx, cn, cok, r2, tol=1e-5):
    """Per query, in float64: pairs within `tol` of the radius and pairs
    within `tol` of an 11-bin boundary of theta, alpha or phi — the
    measure-zero sets where float32 implementations may round a pair
    into a neighbouring bin (or across the radius)."""
    d = cx[None] - qx[:, None]
    dist2 = (d * d).sum(-1)
    near_r = np.abs(dist2 - r2) <= tol * r2 + tol
    dist = np.sqrt(np.maximum(dist2, 1e-12))
    dh = d / dist[..., None]
    cos1 = (qn[:, None] * dh).sum(-1)
    cos2 = -(cn[None] * dh).sum(-1)
    swap = np.abs(cos1) < np.abs(cos2)
    ns = np.where(swap[..., None], cn[None], qn[:, None])
    nt = np.where(swap[..., None], qn[:, None], cn[None])
    ds = np.where(swap[..., None], -dh, dh)
    phi = np.where(swap, cos2, cos1)
    v = np.cross(ds, ns)
    v /= np.sqrt(np.maximum((v * v).sum(-1), 1e-12))[..., None]
    w = np.cross(ns, v)
    alpha = (v * nt).sum(-1)
    theta = np.arctan2((w * nt).sum(-1), (ns * nt).sum(-1))
    inside = (dist2 <= r2 * (1 + tol) + tol) & cok[None]

    def near_edge(x, lo, hi):
        f = (x - lo) / (hi - lo) * 11
        return np.abs(f - np.rint(f)) <= tol * 11

    near_b = (
        near_edge(theta, -np.pi, np.pi) | near_edge(alpha, -1, 1)
        | near_edge(phi, -1, 1)
    )
    return (near_r & cok[None]).sum(-1), (near_b & inside).sum(-1)


def check_spfh(got, ref, args) -> tuple[int, int]:
    """Kernel vs reference SPFH. Pair counts must be equal and the sum-100
    histograms agree to atol 2e-3 (tests/test_pallas.py), except where a
    pair lies on a measure-zero bin or radius boundary: there float32
    rounding may move it, so a query may differ by at most its float64
    count of such boundary pairs. Returns (queries with a boundary
    difference, boundary pairs moved)."""
    (h_k, t_k), (h_r, t_r) = (np.asarray(got[0]), np.asarray(got[1])), (
        np.asarray(ref[0]), np.asarray(ref[1]))
    q_xyz, q_nrm, c_xyz, c_nrm, c_ok, r2 = args
    # integer bin counts back from the sum-100 histograms
    n_k = np.rint(h_k * t_k[..., None] / 100.0)
    n_r = np.rint(h_r * t_r[..., None] / 100.0)
    moved = np.abs(n_k - n_r).sum(-1) + 3 * np.abs(t_k - t_r)
    bad = np.argwhere(moved > 0)
    n_moved = 0
    for bi, qi in bad:
        ci = 0 if c_xyz.shape[0] == 1 else bi
        near_r, near_b = _boundary_pairs(
            q_xyz[bi, qi : qi + 1].astype(np.float64),
            q_nrm[bi, qi : qi + 1].astype(np.float64),
            c_xyz[ci].astype(np.float64), c_nrm[ci].astype(np.float64),
            c_ok[ci], r2,
        )
        dt = abs(t_k[bi, qi] - t_r[bi, qi])
        assert dt <= near_r[0], (
            f"SPFH pair count differs off the radius boundary at {bi, qi}: "
            f"{t_k[bi, qi]} vs {t_r[bi, qi]}"
        )
        assert moved[bi, qi] <= 6 * (near_r[0] + near_b[0]), (
            f"SPFH bins differ off a bin boundary at {bi, qi}: "
            f"{moved[bi, qi]} moves, {near_b[0]} boundary pairs"
        )
        n_moved += int(moved[bi, qi])
    same = moved == 0
    np.testing.assert_allclose(h_k[same], h_r[same], atol=2e-3)
    return len(bad), n_moved


def matching_data(n: int = 1024, seed: int = 0):
    """Descriptor sets at the fleet configs' padded keypoint capacity
    (1024 slots, ~60% valid): targets are noisy copies of the sources."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n, 33)).astype(np.float32)
    t = (s + 0.3 * rng.normal(size=(n, 33))).astype(np.float32)
    return s, t, rng.random(n) < 0.6, rng.random(n) < 0.6


def check_matching(corr, s, t, sv, tv, k: int = 5) -> int:
    """find_correspondences vs a float64 numpy oracle of the reciprocal
    first-match rule. Returns the number of matches."""
    d2 = ((s[:, None].astype(np.float64) - t[None]) ** 2).sum(-1)
    d2 = np.where(sv[:, None] & tv[None], d2, np.inf)
    fwd = np.argsort(d2, axis=1, kind="stable")[:, :k]
    back = np.argsort(d2.T, axis=1, kind="stable")[:, :k]
    valid, target = np.asarray(corr.valid), np.asarray(corr.target)
    assert not valid[~sv].any(), "a masked source slot matched"
    n = 0
    for i in np.nonzero(sv)[0]:
        hit = next((j for j in fwd[i] if tv[j] and i in back[j]), None)
        assert valid[i] == (hit is not None), f"source {i}: match {valid[i]}"
        if hit is not None:
            assert target[i] == hit, f"source {i}: target {target[i]} != {hit}"
            n += 1
    return n


def transposed_topk_rows_wrong(s, t, sv, tv, k: int = 5) -> int:
    """Rows of XLA's top_k over a masked, transposed distance matrix
    (the form find_correspondences used to take) that differ from numpy.
    Informational: on the GPU this form has returned wrong indices."""
    import jax
    import jax.numpy as jnp

    from mapmerge_tpu.ops.matching import descriptor_sq_dists

    @jax.jit
    def both_ways(a, b, av, bv):
        d2 = descriptor_sq_dists(a, b)
        d2 = jnp.where(bv[None, :], d2, 1.0e12)
        d2 = jnp.where(av[:, None], d2, 1.0e12)
        # the forward top_k in the same program is part of the repro
        return jax.lax.top_k(-d2, k)[1], jax.lax.top_k(-d2.T, k)[1]

    got = np.asarray(both_ways(*(jnp.asarray(x) for x in (s, t, sv, tv)))[1])
    d2 = np.asarray(descriptor_sq_dists(jnp.asarray(s), jnp.asarray(t)))
    d2 = np.where(sv[:, None] & tv[None], d2, 1.0e12)
    ref = np.argsort(d2.T, axis=1, kind="stable")[:, :k]
    return int((got[tv] != ref[tv]).any(-1).sum())


def run_matching():
    """Reciprocal descriptor matching at 1024 slots on the card, and a
    bare top_k over a transposed matrix, both against numpy."""
    import jax
    import jax.numpy as jnp

    from mapmerge_tpu.ops.matching import find_correspondences

    s, t, sv, tv = matching_data()
    corr = jax.jit(find_correspondences, static_argnames=("k",))(
        *(jnp.asarray(x) for x in (s, t)), k=5,
        source_valid=jnp.asarray(sv), target_valid=jnp.asarray(tv),
    )
    n = check_matching(corr, s, t, sv, tv)
    x = np.random.default_rng(1).random((1024, 1024)).astype(np.float32)
    _, idx = jax.jit(lambda a: jax.lax.top_k(-a.T, 5))(jnp.asarray(x))
    np.testing.assert_array_equal(
        np.asarray(idx), np.argsort(x.T, axis=1, kind="stable")[:, :5]
    )
    print(
        f"[kernels] matching 1024 slots: {n} reciprocal matches equal to "
        f"numpy; bare top_k(-x.T) 1024x1024 equal to numpy; masked "
        f"transposed top_k (jax {jax.__version__}): "
        f"{transposed_topk_rows_wrong(s, t, sv, tv)} of {int(tv.sum())} "
        "rows wrong (not used by the program)",
        flush=True,
    )


def run_kernels():
    import jax
    import jax.numpy as jnp

    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.ops.descriptors.fpfh import spfh_tile_plain
    from mapmerge_tpu.pallas.nn import (
        nearest_neighbor_direct,
        nearest_neighbor_pallas,
    )
    from mapmerge_tpu.pallas.spfh import spfh_tile_pallas

    q, p, mask = nn_data()
    qd, pd, md = jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask)
    for tag, m_np, m_dev in (("nn", None, None), ("nn_masked", mask, md)):
        got = jax.block_until_ready(nearest_neighbor_pallas(qd, pd, m_dev))
        ref = jax.block_until_ready(nearest_neighbor_direct(qd, pd, m_dev))
        ties = check_nn(
            *(np.asarray(a) for a in (*got, *ref)), q, p, m_np
        )
        t_k = _median_time(nearest_neighbor_pallas, qd, pd, m_dev)
        t_x = _median_time(nearest_neighbor_direct, qd, pd, m_dev)
        print(
            f"[kernels] {tag} Q=P=32768: kernel {t_k * 1e3:.3f} ms, "
            f"plain XLA {t_x * 1e3:.3f} ms, ties {ties}",
            flush=True,
        )

    radius = MergeParams().descriptor_radius
    for tag, args in (
        ("spfh_dense 24576x32768", spfh_dense_data(radius)),
        ("spfh_grid B=16 Cq=128 M=3456", spfh_grid_data(radius)),
    ):
        dev = [jnp.asarray(a) for a in args[:5]]
        kern = jax.jit(lambda *a: spfh_tile_pallas(*a, r2=args[5]))
        plain = jax.jit(lambda *a: spfh_tile_plain(*a, r2=args[5]))
        got = jax.block_until_ready(kern(*dev))
        ref = jax.block_until_ready(plain(*dev))
        n_q, n_moved = check_spfh(got, ref, args)
        t_k = _median_time(kern, *dev)
        t_x = _median_time(plain, *dev)
        print(
            f"[kernels] {tag}: kernel {t_k * 1e3:.3f} ms, plain XLA "
            f"{t_x * 1e3:.3f} ms, boundary pairs moved {n_moved} "
            f"in {n_q} queries",
            flush=True,
        )
    run_matching()


# --------------------------------------------------------------- phase 3: pair
def _pair_gate(transforms, truth):
    from bench_fixtures import check_golden, pose_err

    rot, trans = pose_err(np.linalg.inv(transforms[0]) @ transforms[1], truth)
    assert rot < 1.0 and trans < 0.1, (
        f"accuracy gate failed: rot {rot} deg, trans {trans} m"
    )
    _, gerr = check_golden(transforms, "config1", rot_tol=1.0, trans_tol=0.1)
    return rot, trans, gerr


def run_pair():
    from bench import bench_params, build_views
    from bench_fixtures import pose_err
    from mapmerge_tpu.pipeline.merging import (
        compose_maps,
        estimate_maps_transforms,
    )

    va, vb, truth = build_views()
    params = bench_params()
    runs = []
    for k in range(2):
        t0 = time.perf_counter()
        transforms = estimate_maps_transforms([va, vb], params, seed=0)
        wall = time.perf_counter() - t0
        rot, trans, gerr = _pair_gate(transforms, truth)
        print(
            f"[pair] run {k}: {wall:.3f} s, vs truth {rot:.4f} deg "
            f"{trans:.5f} m, vs golden {gerr[-1][0]:.4f} deg "
            f"{gerr[-1][1]:.5f} m",
            flush=True,
        )
        runs.append(transforms)
    d_rot, d_trans = pose_err(runs[0][1], runs[1][1])
    print(
        f"[pair] pose difference between the two runs: {d_rot:.6f} deg "
        f"{d_trans:.7f} m (scatter-adds on the GPU are not bit-reproducible)",
        flush=True,
    )
    merged = compose_maps([va, vb], runs[1], resolution=params.output_resolution)
    n = int(merged.count)
    xyz = np.asarray(merged.xyz)[np.asarray(merged.mask)]
    assert n > 0 and np.isfinite(xyz).all(), "compose_maps produced no points"
    print(f"[pair] compose_maps: {n} points", flush=True)


# -------------------------------------------------------------- phase 4: fleet
def run_fleet():
    import jax

    from bench_fixtures import big_params, check_chain, check_golden, town_views
    from mapmerge_tpu.core.cloud import PointCloud
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    views, truths = town_views(5, view_resized_target=500_000)
    sizes = [len(v[0]) for v in views]
    cap = 1 << int(np.ceil(np.log2(max(sizes))))
    clouds = [PointCloud.from_arrays(x, r, capacity=cap) for x, r in views]
    params = big_params(min(cap, 1 << 20))
    print(f"[fleet] 5 maps of {sizes} points, capacity {cap}", flush=True)
    t0 = time.perf_counter()
    transforms = estimate_maps_transforms(clouds, params, seed=0)
    print(f"[fleet] merge (cold): {time.perf_counter() - t0:.3f} s", flush=True)
    errs = check_chain(transforms, truths, rot_tol=2.0, trans_tol=0.3, min_ok=4)
    _, gerr = check_golden(transforms, "config2", rot_tol=2.0, trans_tol=0.3)
    print(
        f"[fleet] vs truth (deg, m): {[(round(a, 4), round(b, 5)) for a, b in errs]}; "
        f"vs golden: {[(round(a, 4), round(b, 5)) for a, b in gerr]}",
        flush=True,
    )
    stats = jax.devices()[0].memory_stats() or {}
    print(
        f"[fleet] peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
        flush=True,
    )


# --------------------------------------------------------------- phase 5: node
def run_node():
    from bench_fixtures import check_chain, stream_params, town_views
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import InProcTransport

    views, truths = town_views(50, view_resized_target=2048, seed=5)
    views, truths = views[:4], truths[:4]
    for incremental in (False, True):
        transport = InProcTransport()
        node = MapMergeNode(
            transport, params=stream_params(), seed=0, incremental=incremental
        )
        for i, (xyz, rgb) in enumerate(views):
            transport.publish(f"robot_{i:02d}", xyz, rgb)
        t0 = time.perf_counter()
        node.discovery()
        node.transforms_estimation()
        node.map_compositing()
        wall = time.perf_counter() - t0
        transforms = node.get_transforms()
        ordered = [transforms[f"robot_{i:02d}"] for i in range(len(views))]
        assert all(t.any() for t in ordered), (
            f"node (incremental={incremental}): a robot got no pose"
        )
        # config5's per-hop gate (bench_configs.config5)
        errs = check_chain(ordered, truths, rot_tol=8.0, trans_tol=0.5)
        merged = node.get_merged_map()
        assert merged is not None and int(merged.count) > 1000
        print(
            f"[node] incremental={incremental}: tick {wall:.3f} s, "
            f"poses vs truth {[(round(a, 3), round(b, 4)) for a, b in errs]}, "
            f"merged map {int(merged.count)} points",
            flush=True,
        )


# ---------------------------------------------------------- four-card phases
def run_mesh(devices):
    from bench_fixtures import config4_fixture, pose_err
    from mapmerge_tpu.parallel.mesh import make_mesh
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    clouds, truths, params, _ = config4_fixture()
    mesh = make_mesh(devices)
    out = {}
    for tag, kw in (("mesh4", {"mesh": mesh}), ("single", {"mesh": None})):
        for k in ("cold", "warm"):
            t0 = time.perf_counter()
            out[tag] = estimate_maps_transforms(clouds, params, seed=0, **kw)
            print(
                f"[mesh] {tag} {k}: {time.perf_counter() - t0:.3f} s",
                flush=True,
            )
    a, b = out["mesh4"], out["single"]
    t_a, t_b, g0 = np.linalg.inv(a[0]), np.linalg.inv(b[0]), np.linalg.inv(truths[0])
    rows = []
    for i in range(len(clouds)):
        registered = np.asarray(a[i]).any(), np.asarray(b[i]).any()
        assert registered[0] == registered[1], (
            f"map {i}: registered sharded {registered[0]}, single {registered[1]}"
        )
        if not registered[0]:
            rows.append((i, None, None, None))
            continue
        truth = g0 @ truths[i]
        rows.append((
            i, pose_err(t_a @ a[i], t_b @ b[i]),
            pose_err(t_a @ a[i], truth), pose_err(t_b @ b[i], truth),
        ))
    for i, diff, e_a, e_b in rows:
        print(
            f"[mesh] map {i}: sharded vs single {_fmt(diff)}; vs truth "
            f"sharded {_fmt(e_a)}, single {_fmt(e_b)}",
            flush=True,
        )
    # sharding distributes the same pairs; it must not move any map
    off = [(i, _fmt(d)) for i, d, _, _ in rows
           if d is not None and not (d[0] < 0.5 and d[1] < 0.05)]
    assert not off, f"sharded vs single-device poses differ: {off}"


def _fmt(err) -> str:
    return "unregistered" if err is None else f"{err[0]:.4f} deg {err[1]:.5f} m"


def run_staged(devices):
    import jax

    from bench_fixtures import big_params, town_views
    from mapmerge_tpu.core.cloud import PointCloud, pad_cloud
    from mapmerge_tpu.parallel.mesh import make_mesh
    from mapmerge_tpu.parallel.pair_shard import (
        extract_features_staged_parallel,
    )
    from mapmerge_tpu.pipeline import features

    extract_features_staged = features.extract_features_staged
    views, _ = town_views(4, view_resized_target=400_000, seed=11)
    cap = 1 << 20
    clouds = [PointCloud.from_arrays(x, r, capacity=cap) for x, r in views]
    params = big_params(cap)
    placement: list = []

    def watched(cloud, params):
        # where each cloud's staged features are computed
        out = extract_features_staged(cloud, params)
        placement.append(next(iter(out.keypoints.xyz.devices())))
        return out

    features.extract_features_staged = watched
    t0 = time.perf_counter()
    try:
        feats = extract_features_staged_parallel(
            clouds, params, make_mesh(devices)
        )
        jax.block_until_ready(feats)
    finally:
        features.extract_features_staged = extract_features_staged
    print(
        f"[staged] 4 clouds of {[len(v[0]) for v in views]} points at "
        f"capacity {cap}: {time.perf_counter() - t0:.3f} s",
        flush=True,
    )
    for i, devs in enumerate(placement):
        print(f"[staged] cloud {i} features computed on {devs}", flush=True)
    print(f"[staged] stacked result on {sorted(map(str, feats.keypoints.xyz.devices()))}")
    assert len(set(map(str, placement))) == len(devices), (
        "staged features did not spread over the cards"
    )
    # what it is compared with: cloud 1 alone on one device
    ref = extract_features_staged(
        jax.device_put(pad_cloud(clouds[1], cap), devices[0]), params
    )
    n_par = int(np.asarray(feats.keypoints.mask[1]).sum())
    n_ref = int(np.asarray(ref.keypoints.mask).sum())
    assert n_ref > 0 and abs(n_par - n_ref) <= max(2, n_ref // 100), (
        f"cloud 1 keypoints: {n_par} round-robined vs {n_ref} on one device"
    )
    print(f"[staged] cloud 1 keypoints: {n_par} round-robined, {n_ref} alone")


PHASES = {
    "kernels": run_kernels,
    "pair": run_pair,
    "fleet": run_fleet,
    "node": run_node,
}


def main(argv: list[str]) -> int:
    four = "--four" in argv
    print(f"card: {card_info()}", flush=True)

    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_event)
    with phase("device"):
        devices = check_device(4 if four else 1)
        print(f"[device] {devices}", flush=True)
    from mapmerge_tpu.utils.compile_cache import enable_compile_cache

    print(f"[device] compile cache {enable_compile_cache()}", flush=True)

    if four:
        for name, fn in (("mesh", run_mesh), ("staged", run_staged)):
            with phase(name):
                fn(devices)
    else:
        for name, fn in PHASES.items():
            with phase(name):
                fn()
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
