"""Preconditioned conjugate gradient method.

Capability parity with the reference CG (reference: src/krylov/cg.py:16-259):
left preconditioner ``Ml``, SPD preconditioner ``M`` defining the inner-product
geometry, arbitrary ``inner``, multi-RHS blocking, per-iteration callback,
``return_arnoldi`` reconstruction of the underlying Lanczos relation, and the
``num_operations`` analytic cost model.

Architecture differs from the reference: the recurrence is a pure functional
``step`` on a :class:`CGState` pytree driven by the shared driver
(:mod:`krylov_tpu._driver`), so the identical code runs as a float64 host loop
(parity mode) or as one compiled ``lax.while_loop`` on device.  The k==0 search
direction special case is removed by initializing ``p = 0`` — the first
update ``p = M_Ml_r + omega * 0`` is then exact and branch-free.
"""

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Product
from ._common import initial_residual, preconditioner, setup


class CGState(NamedTuple):
    yk: jnp.ndarray  # solution increment (xk = x0 + yk)
    Ml_rk: jnp.ndarray  # left-preconditioned residual
    M_Ml_rk: jnp.ndarray  # M-preconditioned residual
    p: jnp.ndarray  # search direction
    rho_old: jnp.ndarray  # previous <Ml_r, M Ml_r>
    rho: jnp.ndarray  # current  <Ml_r, M Ml_r>
    alpha: jnp.ndarray  # last step size (for Lanczos reconstruction)
    omega: jnp.ndarray  # last direction update coefficient
    resnorm: jnp.ndarray


def cg(
    A,
    b,
    M=None,
    Ml=None,
    inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    return_arnoldi: bool = False,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M)
    Ml = preconditioner(Ml)
    Ml_A = Product(Ml, A)

    def residual_and_norm2(z, zero_z=False):
        # zero_z: z is the default all-zero initial guess, so r = b
        # BITWISE (A@0 sums c*0 = +0.0 exactly; b - 0.0 == b for every
        # float).  Beyond saving a matvec, keeping the prologue free of
        # an operator kernel whose output seeds the compiled loop carry
        # preserves XLA's in-place buffer aliasing for the whole
        # while_loop.
        r = initial_residual(A, b, z, zero_z)
        Ml_r = Ml @ r
        M_Ml_r = M @ Ml_r
        norm2 = ensure_real(inner(Ml_r, M_Ml_r), "<x, M x>")
        return M_Ml_r, Ml_r, norm2

    M_Ml_r0, Ml_r0, norm2_0 = residual_and_norm2(x0, zero_z=x0_default)
    resnorm0 = jnp.sqrt(norm2_0)

    if callback is not None:
        callback(x0, Ml_r0)

    state0 = CGState(
        yk=jnp.zeros(x0.shape, dtype=M_Ml_r0.dtype),
        Ml_rk=Ml_r0,
        M_Ml_rk=M_Ml_r0,
        p=jnp.zeros_like(M_Ml_r0),
        rho_old=jnp.ones_like(norm2_0),
        rho=norm2_0,
        # alpha = rho / <p, Ap> inherits the (possibly complex) vector dtype
        alpha=jnp.zeros(jnp.shape(norm2_0), jnp.result_type(norm2_0, M_Ml_r0.dtype)),
        omega=jnp.zeros_like(norm2_0),
        resnorm=resnorm0,
    )

    def step(s: CGState, criterion) -> CGState:
        omega = s.rho / jnp.where(s.rho_old != 0, s.rho_old, 1.0)
        p = s.M_Ml_rk + omega * s.p  # exact for k==0 since p0 == 0
        Ap = Ml_A @ p
        pAp = inner(p, Ap)
        alpha = s.rho / jnp.where(pAp != 0, pAp, 1.0)
        yk = s.yk + alpha * p
        Ml_rk = s.Ml_rk - alpha * Ap
        M_Ml_rk = M @ Ml_rk
        rho_new = ensure_real(inner(Ml_rk, M_Ml_rk), "<r, M r>")
        return CGState(
            yk=yk,
            Ml_rk=Ml_rk,
            M_Ml_rk=M_Ml_rk,
            p=p,
            rho_old=s.rho,
            rho=rho_new,
            alpha=alpha,
            omega=omega,
            resnorm=jnp.sqrt(rho_new),
        )

    def xk_of(s: CGState):
        return x0 + s.yk

    def explicit_resnorm(xk):
        return jnp.sqrt(residual_and_norm2(xk)[2])

    # optional Lanczos-relation reconstruction, matching the reference
    # bookkeeping at src/krylov/cg.py:140-149, 219-232.  Compiled
    # backend: the V/P bases live in fixed (maxiter+1, N, ...) buffers
    # carried through the while_loop (same pattern as compiled GMRES);
    # eager: host-side list accumulation.
    if return_arnoldi and backend != EAGER:
        vdt = M_Ml_r0.dtype
        tail = tuple(b.shape[1:])
        hdt = jnp.result_type(norm2_0, vdt)
        safe0 = jnp.where(resnorm0 > 0.0, resnorm0, 1.0)

        class CGArnState(NamedTuple):
            yk: jnp.ndarray
            Ml_rk: jnp.ndarray
            M_Ml_rk: jnp.ndarray
            p: jnp.ndarray
            rho_old: jnp.ndarray
            rho: jnp.ndarray
            alpha: jnp.ndarray
            omega: jnp.ndarray
            resnorm: jnp.ndarray
            Vb: jnp.ndarray  # (maxiter+1, N, *tail) M-inner-orthonormal
            Pb: jnp.ndarray  # (maxiter+1, N, *tail) dual basis, V = M P
            Hb: jnp.ndarray  # (maxiter+1, maxiter, *tail) tridiagonal
            kk: jnp.ndarray
            alpha_old: jnp.ndarray

        arn_state0 = CGArnState(
            *state0,
            Vb=jnp.zeros((maxiter + 1,) + b.shape, vdt).at[0].set(
                M_Ml_r0 / safe0
            ),
            Pb=jnp.zeros((maxiter + 1,) + b.shape, vdt).at[0].set(
                Ml_r0 / safe0
            ),
            Hb=jnp.zeros((maxiter + 1, maxiter) + tail, hdt),
            kk=jnp.asarray(0, jnp.int32),
            alpha_old=jnp.ones_like(state0.alpha),
        )

        base_step = step

        def arn_step(s: CGArnState, criterion) -> CGArnState:
            ns = base_step(CGState(*s[:9]), criterion)
            k = s.kk
            sign = jnp.where((k + 1) % 2 == 0, 1.0, -1.0).astype(
                jnp.zeros((), vdt).real.dtype
            )
            Vb = s.Vb.at[k + 1].set(sign * ns.M_Ml_rk / ns.resnorm)
            Pb = s.Pb.at[k + 1].set(sign * ns.Ml_rk / ns.resnorm)
            Hkk = 1.0 / ns.alpha + jnp.where(
                k > 0, ns.omega / s.alpha_old, 0.0
            ).astype(hdt)
            Hb = s.Hb.at[k, k].set(Hkk.astype(hdt))
            # mirror last step's subdiagonal onto the superdiagonal
            # (H[k-1, k] = H[k, k-1]); at k == 0 this re-writes H[0, 0]
            # with the value just stored there — a no-op
            idx = jnp.maximum(k - 1, 0)
            prev_sub = Hb[k, idx]
            Hb = Hb.at[idx, k].set(
                jnp.where(k > 0, prev_sub, Hb[idx, k])
            )
            off = (jnp.sqrt(ns.rho / ns.rho_old) / ns.alpha).astype(hdt)
            Hb = Hb.at[k + 1, k].set(off)
            return CGArnState(
                *ns, Vb=Vb, Pb=Pb, Hb=Hb, kk=k + 1, alpha_old=ns.alpha
            )

        method = Method(
            step=arn_step,
            xk=lambda s: x0 + s.yk,
            explicit_resnorm=explicit_resnorm,
            callback_args=lambda s: (x0 + s.yk, s.Ml_rk),
        )
        state, success, k, resnorms = run(
            arn_state0, method, tol=tol, atol=atol, maxiter=maxiter,
            callback=callback, backend=backend,
        )
        xk = x0 + state.yk
        num_operations = {
            "A": 1 + k, "M": 2 + k, "Ml": 2 + k, "Mr": 1 + k,
            "inner": 2 + 2 * k, "axpy": 2 + 2 * k,
        }
        if isinstance(k, (int, np.integer)):
            V = [state.Vb[i] for i in range(k + 1)]
            P = [state.Pb[i] for i in range(k + 1)]
            H = np.asarray(state.Hb)[: k + 1, :k]
            arnoldi = [V, H, P]
        else:  # traced: hand back the raw fixed buffers + count
            arnoldi = [state.Vb, state.Hb, state.Pb]
        info = Info(success, xk, k, resnorms, num_operations, arnoldi)
        if isinstance(success, (bool, np.bool_)):
            return xk if success else None, info
        return xk, info

    on_step = None
    arnoldi_acc = None
    if return_arnoldi:
        safe0 = jnp.where(resnorm0 > 0.0, resnorm0, 1.0)
        arnoldi_acc = {
            "V": [M_Ml_r0 / safe0],
            "P": [Ml_r0 / safe0],
            "H": np.zeros([maxiter + 1, maxiter] + list(b.shape[1:]), dtype=float),
            "k": 0,
            "alpha_old": 0.0,
        }

        def on_step(old: CGState, new: CGState):
            acc = arnoldi_acc
            k = acc["k"]
            sign = (-1) ** (k + 1)
            acc["V"].append(sign * new.M_Ml_rk / new.resnorm)
            acc["P"].append(sign * new.Ml_rk / new.resnorm)
            H = acc["H"]
            H[k, k] = np.asarray(1.0 / new.alpha)
            if k > 0:
                H[k - 1, k] = H[k, k - 1]
                H[k, k] += np.asarray(new.omega / acc["alpha_old"])
            H[k + 1, k] = np.asarray(jnp.sqrt(new.rho / new.rho_old) / new.alpha)
            acc["alpha_old"] = new.alpha
            acc["k"] = k + 1

    method = Method(
        step=step,
        xk=xk_of,
        explicit_resnorm=explicit_resnorm,
        callback_args=lambda s: (xk_of(s), s.Ml_rk),
        on_step=on_step,
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
        "axpy": 2 + 2 * k,
    }

    arnoldi = None
    if return_arnoldi:
        H = arnoldi_acc["H"][: arnoldi_acc["k"] + 1, : arnoldi_acc["k"]]
        arnoldi = [arnoldi_acc["V"], H, arnoldi_acc["P"]]

    info = Info(success, xk, k, resnorms, num_operations, arnoldi)
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info  # traced (inside user jit): xk always returned
