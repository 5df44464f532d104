"""End-to-end A/B of the Pallas kernels on the GPU (dev tool).

Times the bench.py pair, config2's 5-map fleet and the 20-map
config4 fixture (one device) with the kernels off
(plain jnp, as the CPU runs it) and on, in the order off, on, on, off, in
one process on one card. Each block recompiles for its mode, warms up, and
then times warm merges: 3 of the pair and of the 20-map fixture, 2 of the
fleet, so every mode gets at least 4 warm runs over its two blocks. Every
wall is printed, and every run's per-map pose errors against the truth.

Usage, from the repo root: python scripts/kernel_ab.py [pair] [fleet] [config4]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mapmerge_tpu import pallas  # noqa: E402
from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def _fixtures(which):
    from bench import bench_params, build_views
    from bench_fixtures import big_params, config4_fixture, town_views
    from mapmerge_tpu.core.cloud import PointCloud

    out = {}
    if "pair" in which:
        va, vb, truth = build_views()
        out["pair"] = ([va, vb], [np.eye(4), truth], bench_params(), 3)
    if "fleet" in which:
        views, truths = town_views(5, view_resized_target=500_000)
        cap = 1 << int(np.ceil(np.log2(max(len(v[0]) for v in views))))
        clouds = [PointCloud.from_arrays(x, r, capacity=cap) for x, r in views]
        out["fleet"] = (clouds, truths, big_params(min(cap, 1 << 20)), 2)
    if "config4" in which:
        clouds, truths, params, _ = config4_fixture()
        out["config4"] = (clouds, truths, params, 3)
    return out


def _errors(transforms, truths) -> list:
    """(deg, m) of each map relative to map 0 vs the truth; None where a
    map did not register."""
    from bench_fixtures import pose_err

    t0, g0 = np.linalg.inv(transforms[0]), np.linalg.inv(truths[0])
    return [
        tuple(round(e, 4) for e in pose_err(t0 @ t, g0 @ g))
        if np.asarray(t).any() else None
        for t, g in zip(transforms, truths)
    ]


def main(argv: list[str]) -> None:
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    cs.check_device()
    enable_compile_cache()
    print(f"card: {cs.card_info()}", flush=True)
    fixtures = _fixtures(argv or ["pair", "fleet"])
    real = pallas.use_kernels
    for mode in ("plain", "kernels", "kernels", "plain"):
        pallas.use_kernels = real if mode == "kernels" else (lambda p=None: False)
        jax.clear_caches()  # traces bake the kernel choice in
        for name, (clouds, truths, params, reps) in fixtures.items():
            t0 = time.perf_counter()
            out = estimate_maps_transforms(clouds, params, seed=0)
            cold = time.perf_counter() - t0
            errs = [_errors(out, truths)]
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = estimate_maps_transforms(clouds, params, seed=0)
                walls.append(time.perf_counter() - t0)
                errs.append(_errors(out, truths))
            print(
                f"{name} {mode}: cold {cold:.3f} s, warm "
                f"{[round(w, 4) for w in walls]} s; "
                f"pose errors per run {errs}",
                flush=True,
            )
    pallas.use_kernels = real


if __name__ == "__main__":
    main(sys.argv[1:])
