"""Preconditioned MINRES.

Capability parity with the reference (reference: src/krylov/minres.py:28-253):
M/Ml/Mr preconditioning, arbitrary inner product, multi-RHS, callback,
num_operations model.

The three-term Lanczos recurrence and the Givens-QR update of the tridiagonal
are inlined functionally in :class:`MinresState` (the reference drives a
stateful iterator object).  The two stored rotations are initialized to
*identity* rotations instead of None — applying them at k<2 is then an exact
no-op, which removes every host branch from the hot loop and lets the same
step run under ``lax.while_loop``.
"""

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Product
from ..givens import apply_givens, givens
from ._common import initial_residual, inner_tail, preconditioner, setup


class MinresState(NamedTuple):
    yk: jnp.ndarray
    W0: jnp.ndarray
    W1: jnp.ndarray
    lan_v: jnp.ndarray
    lan_p: jnp.ndarray
    lan_p_old: jnp.ndarray
    lan_beta: jnp.ndarray  # previous Lanczos subdiagonal (real)
    G1: jnp.ndarray  # last Givens rotation (2, 2, *tail)
    G2: jnp.ndarray  # second-to-last Givens rotation
    y: jnp.ndarray  # rotated rhs 2-vector of the projected system
    resnorm: jnp.ndarray


def _identity_rotation(tail_shape, dtype):
    eye = jnp.eye(2, dtype=dtype)
    return jnp.broadcast_to(eye.reshape((2, 2) + (1,) * len(tail_shape)), (2, 2) + tail_shape).copy() if tail_shape else eye


def minres(
    A,
    b,
    M=None,
    Ml=None,
    Mr=None,
    inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M)
    Ml = preconditioner(Ml)
    Mr = preconditioner(Mr)
    Ml_A_Mr = Product(Ml, A, Mr)

    tail = inner_tail(inner, b)

    def residual_norm(z):
        Ml_r = Ml @ (b - A @ z)
        return jnp.sqrt(ensure_real(inner(Ml_r, M @ Ml_r), "<x, M x>"))

    # default x0 = 0: r0 == b bitwise; skipping the matvec also keeps
    # the compiled prologue free of an operator kernel that would
    # perturb XLA's while-loop buffer aliasing
    r0 = initial_residual(A, b, x0, x0_default)
    Ml_r0 = Ml @ r0
    M_Ml_r0 = M @ Ml_r0
    norm0 = jnp.sqrt(ensure_real(inner(Ml_r0, M_Ml_r0), "<x, M x>"))

    vdtype = M_Ml_r0.dtype
    rdtype = norm0.dtype

    if callback is not None:
        callback(x0, norm0)

    safe0 = jnp.where(norm0 != 0.0, norm0, 1.0)
    zeros_v = jnp.zeros(b.shape, dtype=vdtype)
    state0 = MinresState(
        yk=zeros_v,
        W0=zeros_v,
        W1=zeros_v,
        lan_v=M_Ml_r0 / safe0,
        lan_p=Ml_r0 / safe0,
        lan_p_old=zeros_v,
        lan_beta=jnp.zeros(tail, rdtype),
        G1=_identity_rotation(tail, rdtype),
        G2=_identity_rotation(tail, rdtype),
        y=jnp.stack([norm0, jnp.zeros_like(norm0)]),
        resnorm=norm0,
    )

    def step(s: MinresState, criterion) -> MinresState:
        v = s.lan_v

        # --- Lanczos: one three-term recurrence step ------------------------
        Av = Ml_A_Mr @ v
        h0 = s.lan_beta  # previous subdiagonal moves to the superdiagonal
        Av = Av - h0 * s.lan_p_old
        alpha = inner(v, Av)
        Av = Av - alpha * s.lan_p
        MAv = M @ Av
        beta = jnp.sqrt(ensure_real(inner(Av, MAv), "<v, M v>"))
        safe_beta = jnp.where(beta != 0.0, beta, 1.0)

        # Lanczos coefficients are real for self-adjoint operators
        alpha_r = ensure_real(alpha, "Lanczos <v, Av> (is A self-adjoint?)")

        # --- implicit QR update of the tridiagonal via stored rotations ----
        R01 = apply_givens(s.G2, jnp.stack([jnp.zeros_like(h0), h0]))
        R12 = apply_givens(s.G1, jnp.stack([R01[1], alpha_r]))
        G_new, r = givens(jnp.stack([R12[1], beta]))
        R0, R1, R2 = R01[0], R12[0], r

        y_rot = apply_givens(G_new, s.y)

        # --- solution update (the two axpys dominating the iteration) ------
        z = (v - R0 * s.W0 - R1 * s.W1) / jnp.where(R2 != 0.0, R2, 1.0)
        yk = s.yk + y_rot[0] * z

        resnorm = jnp.abs(y_rot[1])
        return MinresState(
            yk=yk,
            W0=s.W1,
            W1=z,
            lan_v=MAv / safe_beta,
            lan_p=Av / safe_beta,
            lan_p_old=s.lan_p,
            lan_beta=beta,
            G1=G_new.astype(s.G1.dtype),
            G2=s.G1,
            y=jnp.stack([y_rot[1], jnp.zeros_like(y_rot[1])]),
            resnorm=resnorm,
        )

    def xk_of(s: MinresState):
        return x0 + Mr @ s.yk

    method = Method(
        step=step,
        xk=xk_of,
        explicit_resnorm=residual_norm,
        callback_args=lambda s: (xk_of(s), s.resnorm),
    )

    state, success, k, resnorms = run(
        state0,
        method,
        tol=tol,
        atol=atol,
        maxiter=maxiter,
        callback=callback,
        backend=backend,
    )

    xk = xk_of(state)
    num_operations = {
        "A": 1 + k,
        "M": 2 + k,
        "Ml": 2 + k,
        "Mr": 1 + k,
        "inner": 2 + 2 * k,
        "axpy": 4 + 8 * k,
    }
    info = Info(success, xk, k, resnorms, num_operations)
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info
