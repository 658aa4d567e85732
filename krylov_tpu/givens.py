"""Givens plane rotations (L1 primitive).

The reference generates rotations one RHS column at a time through LAPACK's
``?lartg`` in a Python loop (reference: src/krylov/givens.py:5-47).  Here the
generator is a branch-free, overflow-safe jnp computation matching the LAPACK
``lartg`` edge-case conventions:

* ``g == 0``        -> ``c = 1, s = 0, r = f``
* ``f == 0, g != 0``-> ``c = 0, s = 1`` (real) / ``s = conj(g)/|g|`` (complex)
* otherwise ``c`` real-positive-scaled so that ``|f| > |g|`` gives ``c > 0``.

Being pure ``jnp.where`` arithmetic, it vectorizes across all RHS columns at
once and runs on-device inside compiled solver loops (no LAPACK FFI crossing).
"""

import jax.numpy as jnp

from . import _precision as prec


def lartg(f, g):
    """Elementwise robust Givens generation.

    Returns ``(c, s, r)`` with ``c`` real such that::

        [  c        s ]   [ f ]   [ r ]
        [ -conj(s)  c ] @ [ g ] = [ 0 ]

    Works on scalars or arrays (elementwise), real or complex.
    """
    f = jnp.asarray(f)
    g = jnp.asarray(g)
    dtype = jnp.result_type(f, g)
    f = f.astype(dtype)
    g = g.astype(dtype)

    af = jnp.abs(f)
    ag = jnp.abs(g)

    # overflow-safe scaling
    scale = jnp.maximum(af, ag)
    safe_scale = jnp.where(scale > 0, scale, 1.0)
    fs = f / safe_scale
    gs = g / safe_scale
    d = safe_scale * jnp.sqrt(jnp.abs(fs) ** 2 + jnp.abs(gs) ** 2)
    safe_d = jnp.where(d > 0, d, 1.0)

    if jnp.iscomplexobj(f):
        # sign(f) = f / |f|, guarded for f == 0
        safe_af = jnp.where(af > 0, af, 1.0)
        sgn_f = jnp.where(af > 0, f / safe_af, jnp.ones_like(f))
        safe_ag = jnp.where(ag > 0, ag, 1.0)
        sgn_g = jnp.where(ag > 0, g / safe_ag, jnp.ones_like(g))

        c_gen = af / safe_d
        s_gen = sgn_f * jnp.conj(g) / safe_d
        r_gen = sgn_f * d

        # f == 0, g != 0
        c_f0 = jnp.zeros_like(c_gen)
        s_f0 = jnp.conj(sgn_g)
        r_f0 = ag.astype(dtype)
    else:
        sgn_f = jnp.where(f >= 0, 1.0, -1.0).astype(dtype)
        c_gen = af / safe_d
        s_gen = sgn_f * g / safe_d
        r_gen = sgn_f * d

        c_f0 = jnp.zeros_like(c_gen)
        s_f0 = jnp.ones_like(s_gen)
        r_f0 = g

    f_zero = af == 0
    g_zero = ag == 0

    c = jnp.where(g_zero, 1.0, jnp.where(f_zero, c_f0, c_gen))
    s = jnp.where(g_zero, jnp.zeros_like(s_gen), jnp.where(f_zero, s_f0, s_gen))
    r = jnp.where(g_zero, f, jnp.where(f_zero, r_f0, r_gen))
    # c is always real
    c = c.real if jnp.iscomplexobj(c) else c
    return c, s, r


def givens(X):
    """Stacked Givens rotations for a batch of 2-vectors.

    ``X`` has shape ``(2, ...)``; returns ``(G, R)`` where ``G`` has shape
    ``(2, 2, ...)`` with ``G[:, :, idx] @ X[:, idx] = [R[idx], 0]`` — the same
    stacked layout the reference produces from its per-column LAPACK loop
    (reference: src/krylov/givens.py:39-47), computed here in one vectorized
    shot.
    """
    X = jnp.asarray(X)
    assert X.shape[0] == 2
    c, s, r = lartg(X[0], X[1])
    c = c.astype(X.dtype) if jnp.iscomplexobj(X) else c
    row0 = jnp.stack([c.astype(s.dtype), s], axis=0)
    row1 = jnp.stack([-jnp.conj(s), c.astype(s.dtype)], axis=0)
    G = jnp.stack([row0, row1], axis=0)
    return G, r


def apply_givens(G, v):
    """``G @ v`` for stacked rotations: G.shape == (m, n, ...), v.shape == (n, ...)."""
    return prec.einsum("ij...,j...->i...", G, v)
