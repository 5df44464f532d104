"""Hand-written Pallas kernels (Triton route) for the GPU hot paths."""

from __future__ import annotations


def use_kernels(platform: str | None = None) -> bool:
    """Which path the kernel call sites take on `platform` (default: JAX's
    default backend): the compiled kernels on "gpu", the plain jnp path on
    "cpu". Any other platform has no route here and raises."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(
        f"no kernel route for platform {platform!r}; "
        "mapmerge_tpu runs on 'gpu' (CUDA) or 'cpu'"
    )
