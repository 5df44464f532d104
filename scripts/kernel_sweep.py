"""Time each Pallas kernel's tile configurations against its plain jnp
version at the chip_smoke.py phase-2 shapes (dev tool, GPU only).

Usage, from the repo root: python scripts/kernel_sweep.py
Prints one line per configuration: median of 5 runs after a warm-up.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mapmerge_tpu.core.params import MergeParams  # noqa: E402
from mapmerge_tpu.ops.descriptors.fpfh import spfh_tile_plain  # noqa: E402
from mapmerge_tpu.pallas.nn import (  # noqa: E402
    nearest_neighbor_direct,
    nearest_neighbor_pallas,
)
from mapmerge_tpu.pallas.spfh import spfh_tile_pallas  # noqa: E402
from mapmerge_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

NN_CONFIGS = [  # (tile_q, tile_p, num_warps, defer)
    (32, 256, 4, False), (32, 512, 4, False), (16, 1024, 4, False),
    (32, 64, 4, True), (32, 128, 4, True), (64, 64, 4, True),
    (16, 128, 4, True), (64, 128, 8, True), (128, 32, 4, True),
    (32, 32, 4, True), (64, 32, 4, True),
]
SPFH_CONFIGS = [  # (block_q, chunk, num_warps)
    (8, 32, 4), (4, 32, 4), (8, 16, 4), (16, 16, 4), (4, 64, 4),
    (8, 32, 2), (8, 64, 8), (16, 32, 8),
]


def _ms(fn, *args) -> str:
    try:
        return f"{cs._median_time(fn, *args) * 1e3:.3f} ms"
    except Exception as e:  # a configuration the compiler refuses
        return f"failed: {type(e).__name__}: {str(e)[:160]}"


def main() -> None:
    cs.check_device()
    enable_compile_cache()
    print(f"card: {cs.card_info()}", flush=True)
    q, p, mask = (jnp.asarray(a) for a in cs.nn_data())
    print(f"nn plain XLA: {_ms(nearest_neighbor_direct, q, p, mask)}", flush=True)
    for tq, tp, nw, defer in NN_CONFIGS:
        fn = jax.jit(
            lambda a, b, m, tq=tq, tp=tp, nw=nw, defer=defer: (
                nearest_neighbor_pallas(
                    a, b, m, tile_q=tq, tile_p=tp, num_warps=nw, defer=defer
                )
            )
        )
        print(
            f"nn tile_q={tq} tile_p={tp} warps={nw} defer={defer}: "
            f"{_ms(fn, q, p, mask)}",
            flush=True,
        )

    radius = MergeParams().descriptor_radius
    for tag, args in (
        ("spfh_dense", cs.spfh_dense_data(radius)),
        ("spfh_grid", cs.spfh_grid_data(radius)),
    ):
        dev = [jnp.asarray(a) for a in args[:5]]
        plain = jax.jit(lambda *a: spfh_tile_plain(*a, r2=args[5]))
        print(f"{tag} plain XLA: {_ms(plain, *dev)}", flush=True)
        for bq, ch, nw in SPFH_CONFIGS:
            fn = jax.jit(
                lambda *a, bq=bq, ch=ch, nw=nw: spfh_tile_pallas(
                    *a, r2=args[5], block_q=bq, chunk=ch, num_warps=nw
                )
            )
            print(
                f"{tag} block_q={bq} chunk={ch} warps={nw}: {_ms(fn, *dev)}",
                flush=True,
            )


if __name__ == "__main__":
    main()
