"""LSQR — least-squares via Golub–Kahan bidiagonalization (Paige &
Saunders, ACM TOMS 1982).

Extension beyond the reference: the reference reaches least-squares /
normal-equations problems only through CGNE/CGNR
(reference: src/krylov/cgne.py:17-41, cgnr.py:15-21), which square the
condition number; LSQR works on ``A`` directly through the bidiagonalization
and is the numerically sound tool for rectangular and ill-conditioned
systems.  Supports rectangular ``A`` (the only solver family here that
does), Tikhonov damping ``min ||b - A x||^2 + damp^2 ||x||^2``, blocked
multi-RHS, complex operators, and both backends (the whole solve is one
``lax.while_loop`` under ``backend="while_loop"``).

Stopping combines the library's uniform residual criterion
``||r|| <= max(tol * ||r0||, atol)`` (with the explicit-residual double
check) with the least-squares criterion
``||A^H r|| <= max(tol * ||A|| * ||r||, atol)`` — the latter is the one an
inconsistent system can actually satisfy; it exits through the drivers'
``early_success`` mechanism.
"""

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real, get_default_inner
from .._operators import as_operator


class LsqrState(NamedTuple):
    x: jnp.ndarray
    u: jnp.ndarray      # left Lanczos vector  (m-space)
    v: jnp.ndarray      # right Lanczos vector (n-space)
    w: jnp.ndarray      # search direction     (n-space)
    alpha: jnp.ndarray
    phibar: jnp.ndarray
    rhobar: jnp.ndarray
    anorm2: jnp.ndarray  # running ||B_k||_F^2 estimate of ||A||^2
    resnorm: jnp.ndarray
    early_success: jnp.ndarray


def _guard(d):
    return jnp.where(d != 0.0, d, 1.0)


def lsqr(
    A,
    b,
    damp: float = 0.0,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Solve ``min ||b - A x||`` (+ optional damping) by LSQR.

    ``A`` may be rectangular ``(m, n)``; it must provide ``rmatvec`` (the
    adjoint matvec), as every two-sided solver here does.  Returns the
    library's uniform ``(sol_or_None, Info)``; ``info.resnorms`` is the
    ``||b - A x_k||`` history.  When the solve stops on the least-squares
    criterion (inconsistent systems), the final history entry is the
    converged iterate's residual estimate.
    """
    b = jnp.asarray(b)
    A = as_operator(A)
    m, n = A.shape
    assert b.shape[0] == m
    rhs_shape = b.shape[1:]
    if inner is None:
        inner_u = get_default_inner(b.shape)
        inner_v = get_default_inner((n,) + rhs_shape)
    else:
        inner_u = inner_v = inner
    if maxiter is None:
        maxiter = 2 * min(m, n)
    damp = float(damp)

    def _norm_u(z):
        return jnp.sqrt(jnp.abs(ensure_real(inner_u(z, z), "<u, u>")))

    def _norm_v(z):
        return jnp.sqrt(jnp.abs(ensure_real(inner_v(z, z), "<v, v>")))

    x_init = (
        jnp.zeros((n,) + rhs_shape, b.dtype)
        if x0 is None
        else jnp.asarray(x0)
    )
    r0 = b if x0 is None else b - A @ x_init

    beta0 = _norm_u(r0)
    u = r0 / _guard(beta0)
    Ahu = A.rmatvec(u)
    alpha0 = _norm_v(Ahu)
    v = Ahu / _guard(alpha0)

    x_init = x_init.astype(v.dtype)
    if callback is not None:
        callback(x_init, r0)

    state0 = LsqrState(
        x=x_init,
        u=u,
        v=v,
        w=v,
        alpha=alpha0,
        phibar=beta0,
        rhobar=alpha0,
        # starts at 0 (Paige-Saunders / scipy): the first step adds
        # alpha0^2 + beta1^2 itself — seeding alpha0^2 here would double
        # count it and loosen the least-squares stopping test
        anorm2=jnp.zeros_like(alpha0),
        resnorm=beta0,
        early_success=jnp.asarray(False),
    )

    def step(s: LsqrState, criterion) -> LsqrState:
        # Golub–Kahan bidiagonalization: next left/right vectors
        u = A @ s.v - s.alpha * s.u
        beta = _norm_u(u)
        u = u / _guard(beta)
        v = A.rmatvec(u) - beta * s.v
        alpha = _norm_v(v)
        v = v / _guard(alpha)

        # eliminate the damping row (no-op when damp == 0)
        rhobar1 = jnp.sqrt(s.rhobar * s.rhobar + damp * damp)
        c1 = s.rhobar / _guard(rhobar1)
        phibar_d = c1 * s.phibar

        # plane rotation zeroing the subdiagonal beta
        rho = jnp.sqrt(rhobar1 * rhobar1 + beta * beta)
        c = rhobar1 / _guard(rho)
        sn = beta / _guard(rho)
        theta = sn * alpha
        rhobar = -c * alpha
        phi = c * phibar_d
        phibar = sn * phibar_d

        x = s.x + (phi / _guard(rho)) * s.w
        w = v - (theta / _guard(rho)) * s.w

        anorm2 = s.anorm2 + s.alpha * s.alpha + beta * beta + damp * damp
        # the rotations carry SIGNED recurrences (rhobar = -c alpha flips
        # phibar through later products); every norm-valued quantity takes
        # the absolute value
        resnorm = jnp.abs(phibar)
        # ||A^H r_k|| = |phibar * alpha * c| (Paige & Saunders eq. 5.2)
        arnorm = jnp.abs(phibar * alpha * c)
        ls_ok = arnorm <= jnp.maximum(
            tol * jnp.sqrt(anorm2) * resnorm, atol
        )
        return LsqrState(
            x=x, u=u, v=v, w=w, alpha=alpha, phibar=phibar,
            rhobar=rhobar, anorm2=anorm2, resnorm=resnorm,
            early_success=jnp.all(ls_ok),
        )

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=lambda xk: _norm_u(b - A @ xk),
        # r_k = phibar_k * u_{k+1} exactly (in exact arithmetic)
        callback_args=lambda s: (s.x, s.phibar * s.u),
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    info = Info(success, state.x, k, resnorms)
    if isinstance(success, (bool, np.bool_)):
        return state.x if success else None, info
    return state.x, info
