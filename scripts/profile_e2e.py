"""Host-side breakdown of one estimate_maps_transforms call (dev tool).

Usage, from the repo root: python scripts/profile_e2e.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import bench  # noqa: E402
from mapmerge_tpu.core.cloud import stack_clouds
from mapmerge_tpu.pipeline.merging import (
    estimate_maps_transforms,
    estimate_pairs_batch,
    extract_features_batch,
)

va, vb, truth = bench.build_views()
params = bench.bench_params()

# full warm-up
estimate_maps_transforms([va, vb], params, seed=0)

for rep in range(3):
    t0 = time.perf_counter()
    batch = stack_clouds([va, vb])
    jax.block_until_ready(batch)
    t1 = time.perf_counter()
    features = extract_features_batch(batch, params)
    jax.block_until_ready(features)
    t2 = time.perf_counter()
    kp_counts = np.asarray(jnp.sum(features.keypoints.mask, axis=-1))
    t3 = time.perf_counter()
    src = jnp.asarray([0], jnp.int32)
    tgt = jnp.asarray([1], jnp.int32)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(0), jnp.arange(1)
    )
    est = estimate_pairs_batch(features, src, tgt, params, keys)
    jax.block_until_ready(est)
    t4 = time.perf_counter()
    tr = np.asarray(est.transform)
    conf = np.asarray(est.confidence)
    t5 = time.perf_counter()
    print(
        f"rep{rep}: stack={1e3*(t1-t0):.1f}ms features={1e3*(t2-t1):.1f}ms "
        f"kpD2H={1e3*(t3-t2):.1f}ms pairs={1e3*(t4-t3):.1f}ms "
        f"D2H={1e3*(t5-t4):.1f}ms total={1e3*(t5-t0):.1f}ms"
    )

# and the true end-to-end for comparison
t0 = time.perf_counter()
estimate_maps_transforms([va, vb], params, seed=0)
print(f"estimate_maps_transforms: {1e3*(time.perf_counter()-t0):.1f}ms")
