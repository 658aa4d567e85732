"""Inner products and norms.

The blocked/multi-RHS capability of the whole library hinges on one dispatch:
a 1-D right-hand side uses a plain conjugated dot product, an ``(N, k)``
right-hand side contracts only the leading axis so that every downstream
scalar (alpha, beta, resnorm, ...) silently becomes a ``(k,)`` array and all
RHS columns iterate simultaneously (capability parity with reference:
src/krylov/_helpers.py:101-110).

On a sharded operator the same contraction is wrapped in a mesh ``psum``;
see :mod:`krylov_tpu.parallel`.
"""

import jax
import jax.numpy as jnp

from . import _precision as prec


def get_default_inner(b_shape):
    """Return the Euclidean inner product matching the RHS shape.

    ``inner(x, y) == sum_i conj(x_i) * y_i`` contracted over axis 0 only, so
    the result has shape ``b_shape[1:]``.
    """
    if len(b_shape) == 1:

        def inner_dot(x, y):
            return prec.dot(jnp.conj(x), y)

        return inner_dot

    def inner_einsum(x, y):
        return prec.einsum("i...,i...->...", jnp.conj(x), y)

    return inner_einsum


def _is_traced(x) -> bool:
    return isinstance(x, jax.core.Tracer)


def ensure_real(x2, what="<x, M x>"):
    """Drop the imaginary part of an inner-product value, after checking it.

    Mirrors the defensive imaginary-part guards of the reference (e.g.
    reference: src/krylov/cg.py:91-93), with one deviation: the reference
    checks ``imag != 0`` exactly, which only works because numpy's complex
    multiply makes ``conj(x) * x`` exactly real.  XLA lowers complex products
    through FMAs, leaving ~eps-level imaginary residue, so the check here is
    relative: raise when ``|imag| > sqrt(eps) * (1 + |value|)``.  Under
    tracing (compiled driver) the check is skipped.
    """
    if jnp.iscomplexobj(x2):
        if not _is_traced(x2):
            tol = float(jnp.sqrt(jnp.finfo(x2.dtype).eps))
            if bool(jnp.any(jnp.abs(x2.imag) > tol * (1.0 + jnp.abs(x2)))):
                raise ValueError(f"inner product {what} gave nonzero imaginary part")
        return x2.real
    return x2


def inner_norm(inner, x, y=None, B=None, what="<x, x>"):
    """sqrt of a (checked-real) inner product; ``B`` optionally applied to y."""
    y = x if y is None else y
    if B is not None:
        y = B @ y
    return jnp.sqrt(ensure_real(inner(x, y), what))
