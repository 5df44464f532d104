"""One place that decides where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os

#: default cache directory: `.jax_cache/` beside the mapmerge_tpu package,
#: i.e. at the root of a checkout (listed in .gitignore). A fixed path
#: matters: the directory is part of the cache key, so a moving one never
#: hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set here; otherwise the cache goes to DEFAULT_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
