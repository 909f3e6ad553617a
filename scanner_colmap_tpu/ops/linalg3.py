"""Closed-form small-matrix linear algebra (loop-free), and the matmul
precision of the geometric solvers.

jnp.linalg.{solve,det,inv} on batched 3x3s lower to loopy LU
factorizations — slow to compile and to run. SfM needs millions of tiny
solves (DoG subpixel refinement, landmark blocks, homography chains); these
adjugate/cofactor forms are pure elementwise arithmetic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def f32_matmuls(fn):
    """Trace `fn` with float32 matmuls at the highest precision.

    Without it the backend picks the precision of f32 products (TF32 on
    tensor-core GPUs), and the margins of RANSAC scores, LM acceptance and
    cheirality tests can land on the other side. Stack it under the
    function's jax.jit so the choice is part of the compiled program."""
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return traced


def det33(A: jax.Array) -> jax.Array:
    """Batched 3x3 determinant."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv33(A: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Batched closed-form 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33],
                    axis=-1).reshape(A.shape)
    return adj / det[..., None, None]


def solve33(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 3x3 solve: x = A^-1 b. b: (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv33(A), b)
