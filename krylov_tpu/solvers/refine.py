"""Mixed-precision iterative refinement.

An extension with no reference counterpart: run the inner Krylov
solve in a cheap dtype (bf16 matvec and vectors — half the memory traffic) and
recover working-precision accuracy with an outer defect-correction loop:

    r_k = b - A x_k            (working precision)
    d_k = solve_low(A_low, r_k)   (low precision, loose tolerance)
    x_{k+1} = x_k + d_k

Classic Wilkinson refinement: each outer step multiplies the error by the
inner solve's residual-reduction factor, while all rounding happens against
the working-precision residual, so the iterate converges to the working
precision's accuracy even though the inner solver never sees it.
"""

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from .._info import Info
from .cg import cg


def refine(
    A,
    b,
    A_low=None,
    solver: Callable = cg,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 50,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: int = 50,
    x0=None,
    inner=None,
    **solver_kwargs,
):
    """Defect-correction refinement of ``A x = b``.

    * ``A`` — working-precision operator (residuals are computed with it).
    * ``A_low`` — low-precision operator for the inner solves (default:
      ``A`` itself — plain restarted refinement).
    * ``solver`` / ``inner_tol`` / ``inner_maxiter`` — the inner solve; its
      iterates are computed in ``A_low``'s dtype.
    * ``tol``/``atol``/``maxiter`` — outer convergence on the
      working-precision residual (reference-style absolute resnorms).

    Returns ``(sol_or_None, Info)`` with the outer residual history.
    """
    A_low = A if A_low is None else A_low
    b = jnp.asarray(b)
    low_dtype = getattr(A_low, "dtype", b.dtype)

    if inner is None:
        def inner(u, v):
            return jnp.sum(jnp.conj(u) * v)

    def norm(v):
        return float(jnp.sqrt(jnp.real(inner(v, v))))

    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - (A @ x)
    resnorms = [norm(r)]
    criterion = max(tol * resnorms[0], atol)
    success = False
    k = 0
    while True:
        if resnorms[-1] <= criterion:
            success = True
            break
        if k == maxiter:
            break
        scale = jnp.asarray(resnorms[-1], b.dtype)
        safe = jnp.where(scale != 0, scale, 1.0)
        r_low = (r / safe).astype(low_dtype)
        inner_kw = dict(solver_kwargs)
        inner_kw.setdefault("backend", "while_loop")
        _, info = solver(
            A_low, r_low, tol=inner_tol, maxiter=inner_maxiter, **inner_kw
        )
        d = info.xk.astype(b.dtype) * safe
        x = x + d
        r = b - (A @ x)
        resnorms.append(norm(r))
        k += 1

    resnorms = np.asarray(resnorms)
    info = Info(success, x, k, resnorms, None, None)
    return (x if success else None), info
