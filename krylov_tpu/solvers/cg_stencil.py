"""Conjugate gradient on grid vectors for stencil operators (const- and
variable-coefficient).

Mathematically identical to :func:`krylov_tpu.cg` (same recurrence,
division guards, explicit-residual double-check — reference:
src/krylov/cg.py:155-217), specialised to unpreconditioned or
Jacobi-preconditioned Euclidean CG on one grid-shaped ``(M, ny)``
right-hand side.  Each iteration is

  ``p = z + omega p``, ``Ap = A p``, ``<p, Ap>``;
  ``y += alpha p``, ``r -= alpha Ap``, ``<r, M r>``

with no operator wrappers or generic inner products in between, so XLA
fuses each line into about one streaming pass (~15N words per iteration
for the variable-coefficient operator, ~10N for the constant one).
"""

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .._driver import WHILE_LOOP, Method, run
from .._info import Info
from ..ops.stencil import ConstStencilOperator, GridStencilOperator


class _StencilCGState(NamedTuple):
    y: jnp.ndarray  # solution increment (xk = x0 + y)
    r: jnp.ndarray
    p: jnp.ndarray
    rho_old: jnp.ndarray
    rho: jnp.ndarray
    resnorm: jnp.ndarray


def cg_stencil(
    A,
    b,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    M=None,
):
    """CG for :class:`ConstStencilOperator` / :class:`GridStencilOperator`
    on grid vectors.

    ``M="jacobi"`` (GridStencilOperator only) runs diagonally
    preconditioned CG with the same recurrence and resnorm convention as
    :func:`krylov_tpu.cg` with ``M=DiagonalOperator(1/diag)`` (resnorm is
    ``sqrt(<r, M r>)``).
    """
    if isinstance(A, ConstStencilOperator):
        variant = "const"
    elif isinstance(A, GridStencilOperator):
        variant = "grid"
    else:
        raise TypeError(
            "cg_stencil requires a ConstStencilOperator or GridStencilOperator"
        )
    Mg, ny = A.grid
    b = jnp.asarray(b)
    flat_in = b.ndim == 1
    b2 = b.reshape(Mg, ny) if flat_in else b
    if b2.shape != (Mg, ny):
        raise ValueError("cg_stencil supports a single grid-shaped RHS")
    N = Mg * ny
    maxiter = N if maxiter is None else maxiter

    if M is None:
        dinv2 = None
    elif M == "jacobi":
        if variant != "grid":
            raise ValueError(
                "M='jacobi' requires a GridStencilOperator (a constant-"
                "coefficient Jacobi preconditioner is a scalar scaling)"
            )
        d = A.diagonal().reshape(Mg, ny).astype(b2.dtype)
        dinv2 = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 1.0)
    else:
        raise ValueError("cg_stencil supports M=None or M='jacobi'; use "
                         "krylov_tpu.cg for general preconditioners")

    def mnorm2(r):
        return jnp.sum(r * r) if dinv2 is None else jnp.sum(r * (dinv2 * r))

    x02 = jnp.zeros_like(b2) if x0 is None else jnp.asarray(x0).reshape(Mg, ny)
    # x0 = 0 short-circuit: r0 = b - A@0 == b BITWISE (the stencil sums
    # c*0 = +0.0 exactly and b - 0.0 == b for every float including
    # -0.0/inf/nan), so trajectories are unchanged and one matvec is
    # skipped.  initial_residual also keeps the dtype faithful for
    # mixed-precision coefficients.
    from ._common import initial_residual

    r0 = initial_residual(A, b2, x02, x0 is None)
    rho0 = mnorm2(r0)
    resnorm0 = jnp.sqrt(rho0)

    state0 = _StencilCGState(
        y=jnp.zeros_like(b2),
        r=r0,
        p=jnp.zeros_like(b2),
        rho_old=jnp.ones_like(rho0),
        rho=rho0,
        resnorm=resnorm0,
    )

    def step(s: _StencilCGState, criterion) -> _StencilCGState:
        omega = s.rho / jnp.where(s.rho_old != 0, s.rho_old, 1.0)
        z = s.r if dinv2 is None else dinv2 * s.r
        p = z + omega * s.p
        Ap = A @ p
        pAp = jnp.sum(p * Ap)
        alpha = s.rho / jnp.where(pAp != 0, pAp, 1.0)
        y = s.y + alpha * p
        r = s.r - alpha * Ap
        rho_new = mnorm2(r)
        return _StencilCGState(
            y=y, r=r, p=p, rho_old=s.rho, rho=rho_new,
            resnorm=jnp.sqrt(rho_new),
        )

    def xk_of(s: _StencilCGState):
        return x02 + s.y

    def explicit_resnorm(xk):
        rr = b2 - (A @ xk)
        return jnp.sqrt(mnorm2(rr))

    method = Method(step=step, xk=xk_of, explicit_resnorm=explicit_resnorm)
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        backend=WHILE_LOOP,
    )

    xk = xk_of(state)
    if flat_in:
        xk = xk.reshape(-1)
    num_operations = {
        "A": 1 + k, "M": 2 + k, "Ml": 2 + k, "Mr": 1 + k,
        "inner": 2 + 2 * k, "axpy": 2 + 2 * k,
    }
    info = Info(success, xk, k, resnorms, num_operations, None)
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info
