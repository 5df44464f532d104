"""SE(3) rigid-transform helpers.

The reference passes transforms as Eigen::Matrix4f with an in-band failure
convention: the zero matrix means "could not register"
(map_merge_3d/include/map_merge_3d/map_merging.h:81-84,
src/matching.cpp:128-133). We keep 4x4 float32 matrices and the same zero
convention, but batched code additionally threads an explicit validity flag
so vmapped kernels never branch on data.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def identity() -> jax.Array:
    return jnp.eye(4, dtype=jnp.float32)


def zero() -> jax.Array:
    return jnp.zeros((4, 4), dtype=jnp.float32)


def is_zero(t: jax.Array, tol: float = 0.0) -> jax.Array:
    """Reference failure check (Eigen isZero, map_merging.cpp:293)."""
    return jnp.max(jnp.abs(t), axis=(-2, -1)) <= tol


def from_rotation_translation(r: jax.Array, t: jax.Array) -> jax.Array:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = jnp.broadcast_to(r, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([r, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2).astype(jnp.float32)


def rotation(t: jax.Array) -> jax.Array:
    return t[..., :3, :3]


def translation(t: jax.Array) -> jax.Array:
    return t[..., :3, 3]


def rigid_inverse(t: jax.Array) -> jax.Array:
    """Exact inverse for rigid transforms: [R|p]^-1 = [R^T | -R^T p]."""
    r = rotation(t)
    p = translation(t)
    rt = jnp.swapaxes(r, -1, -2)
    return from_rotation_translation(
        rt,
        -jnp.einsum("...ij,...j->...i", rt, p, precision=jax.lax.Precision.HIGHEST),
    )


def compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """a @ b — apply b first, then a (matches Eigen operator*)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def apply(t: jax.Array, xyz: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., N, 3).

    JAX equivalent of pcl::transformPointCloud
    (reference src/matching.cpp:211, src/map_merging.cpp:297).
    """
    r = rotation(t)
    p = translation(t)
    return (
        jnp.einsum(
            "...ij,...nj->...ni", r, xyz, precision=jax.lax.Precision.HIGHEST
        )
        + p[..., None, :]
    )


def rotation_geodesic_deg(a: jax.Array, b: jax.Array) -> jax.Array:
    """Angle in degrees between the rotation parts of two transforms."""
    ra, rb = rotation(a), rotation(b)
    m = jnp.einsum(
        "...ij,...kj->...ik", ra, rb, precision=jax.lax.Precision.HIGHEST
    )
    cos = (jnp.trace(m, axis1=-2, axis2=-1) - 1.0) / 2.0
    return jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))


def translation_error(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.linalg.norm(translation(a) - translation(b), axis=-1)
