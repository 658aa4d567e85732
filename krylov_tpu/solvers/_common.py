"""Shared solver preamble.

Uniform argument handling for every method (matching the reference's uniform
solver signature, reference: src/krylov/cg.py:96-113 et al.): RHS coercion,
square-shape checks, operator normalization, default inner product, default
zero initial guess, ``maxiter=None -> N``.
"""

import jax
import jax.numpy as jnp

from .._inner import get_default_inner
from .._operators import Identity, as_operator


def setup(A, b, x0=None, inner=None, maxiter=None, needs_rmatvec=False):
    b = jnp.asarray(b)
    A = as_operator(A)
    assert len(A.shape) == 2
    assert A.shape[0] == A.shape[1]
    N = A.shape[0]
    # operators may declare a native (non-flat) vector space, e.g. the
    # grid-shaped (M, ny) vectors of GridStencilOperator that avoid a
    # reshape per matvec; such solves need an explicit full-contraction inner
    vec_shape = getattr(A, "vector_shape", None)
    if vec_shape is not None and tuple(b.shape[: len(vec_shape)]) == tuple(
        vec_shape
    ):
        # native vector shape, optionally with trailing blocked-RHS axes
        if inner is None:
            raise ValueError(
                "operator-native vector shapes require an explicit inner"
            )
    else:
        assert A.shape[1] == b.shape[0]
        inner = get_default_inner(b.shape) if inner is None else inner
    maxiter = N if maxiter is None else maxiter
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    return A, b, x0, N, inner, maxiter


def initial_residual(A, b, x0, x0_is_default):
    """``r0 = b - A @ x0``, short-circuited for the default zero guess.

    With ``x0_is_default`` the matvec is skipped: ``A @ 0`` sums
    ``c * 0 = +0.0`` exactly and ``b - 0.0 == b`` for every float, so
    the VALUES are bitwise identical.  The DTYPE is made faithful too:
    mixed-precision operators (e.g. bf16 coefficients applied to f32
    vectors) promote the residual, so ``b`` is cast to the dtype the real
    computation would produce — resolved by an abstract ``eval_shape``
    trace, zero FLOPs.  Beyond saving a matvec, keeping the compiled
    prologue free of an operator kernel whose output seeds the loop
    carry preserves XLA's in-place buffer aliasing for the whole
    while_loop.
    """
    if not x0_is_default:
        return b - A @ x0
    try:
        dt = jax.eval_shape(lambda v: b - A @ v, x0).dtype
    except Exception:
        # user-supplied operators may be numpy-only (reference parity:
        # any object with __matmul__, reference: src/krylov/cg.py:33) —
        # not abstractly traceable, so pay the real matvec; these run on
        # the eager path where the aliasing concern does not apply
        return b - A @ x0
    return b.astype(dt)


def preconditioner(M):
    return Identity() if M is None else as_operator(M)


def inner_tail(inner, v):
    """Shape of per-RHS scalars = shape of ``inner(v, v)``.

    For the default inner this equals ``b.shape[1:]`` (multi-RHS blocking);
    for full-contraction inners (grid-shaped vectors) it is ``()`` — deriving
    it from the inner, not the RHS shape, keeps every solver's scalar
    recurrences correct for operator-native vector spaces.
    """
    return tuple(jnp.shape(inner(v, v)))
