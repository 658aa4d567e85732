"""Block CG (O'Leary 1980) — one Krylov space shared by all RHS columns.

The reference's "blocked" solves (selling point #4) iterate each RHS
column independently; every column builds its own Krylov space.  Block CG
searches the UNION of the columns' spaces: per iteration one blocked SpMV
``A @ P`` (an (N, k) SpMM) and two k-by-k matrix inner
products replace k independent scalar recurrences, and convergence is
governed by the (k-1)-deflated spectrum — outlier eigenvalues are
absorbed by the block, so ill-conditioned systems converge in
substantially fewer iterations than column-wise CG.

Device framing: the per-iteration reductions are two ``(k, N) @ (N, k)``
contractions (one ``psum`` each when sharded — independent of k, vs the
2k scalar reductions of column-wise CG), and the k-by-k solves run
on-device.  Near-converged columns make the direction Gram matrix
ill-conditioned; a relative ridge keeps the small solves stable (the
residual criterion is still checked per column, so finished columns just
stop improving).

``block_inner(U, V) -> (k, k)`` is the injection point for sharded runs
(auto-injected by ``sharded_solve`` as a single-psum contraction).
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .._driver import EAGER, Method, run
from .._info import Info
from .._operators import Identity
from ._common import preconditioner, setup
from .. import _precision as prec


class BlockCGState(NamedTuple):
    k: jnp.ndarray        # iteration counter
    X: jnp.ndarray        # (N, k) iterate offset from x0
    R: jnp.ndarray        # (N, k) residuals
    Z: jnp.ndarray        # (N, k) preconditioned residuals
    P: jnp.ndarray        # (N, k) search directions
    gamma: jnp.ndarray    # (k, k) R^H Z
    resnorm: jnp.ndarray  # (k,)


def _default_block_inner(U, V):
    # contract over ALL leading (vector) axes; trailing axis = RHS columns
    return prec.einsum("...k,...l->kl", jnp.conj(U), V)


def _ridge_solve(Gram, RHS):
    """Solve Gram @ Y = RHS with a RELATIVE ridge for near-singular Gram.

    The ridge must scale with the Gram itself: near convergence the Gram
    entries are ~resnorm^2 (tiny), and any absolute floor would swamp them
    and stall the recurrence at a spurious accuracy floor."""
    k = Gram.shape[0]
    rdtype = jnp.real(Gram).dtype
    scale = jnp.real(jnp.trace(Gram)) / k
    # eps must scale with the working precision: a fixed 1e-14 would be
    # additively invisible in f32 (no-op guard) yet dominant for tiny f64
    # Grams
    eps = 10.0 * k * jnp.finfo(rdtype).eps
    ridge = jnp.where(scale > 0, scale, 1.0) * eps
    return jnp.linalg.solve(Gram + ridge * jnp.eye(k, dtype=Gram.dtype), RHS)


def _gram_solve(Gram, RHS):
    """Gram solves in f64 when x64 is available: the k x k solve is the
    error amplifier of the block recurrences, and promoting just it is
    nearly free (k is tiny)."""
    if Gram.dtype in (jnp.float32, jnp.complex64) and jax.config.jax_enable_x64:
        wide = jnp.complex128 if jnp.iscomplexobj(Gram) else jnp.float64
        return _ridge_solve(
            Gram.astype(wide), RHS.astype(wide)
        ).astype(RHS.dtype)
    return _ridge_solve(Gram, RHS)


def cg_block(
    A,
    b,
    M=None,
    inner: Optional[Callable] = None,
    block_inner: Optional[Callable] = None,
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    replace_every: int = 150,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Block CG for Hermitian positive definite ``A`` with ``b`` of shape
    ``(N, k)`` (a 1-D ``b`` degenerates to standard CG recurrences).

    ``replace_every``: every that many iterations the residual block is
    recomputed explicitly and the direction block restarted -- block
    recurrences lose orthogonality faster than single-vector CG (observed
    divergence after ~450 f32 iterations without replacement)."""
    A, b, x0_arr, N, inner, maxiter = setup(
        A, b, x0=x0, inner=inner, maxiter=maxiter
    )
    M_op = preconditioner(M)
    unpreconditioned = isinstance(M_op, Identity)
    # vector shape: operator-native (e.g. grid (M, ny)) or flat (N,);
    # anything beyond it is the RHS column axis
    vshape = getattr(A, "vector_shape", None)
    if vshape is not None and tuple(b.shape[: len(vshape)]) == tuple(vshape):
        vdims = len(vshape)
    else:
        vdims = 1
    squeeze = b.ndim == vdims
    B = b[..., None] if squeeze else b
    X0 = x0_arr[..., None] if squeeze else x0_arr
    if block_inner is None:
        block_inner = _default_block_inner

    def residuals(X):
        return B - jnp.asarray(A @ X)

    R0 = residuals(X0)
    Z0 = jnp.asarray(M_op @ R0)
    gamma0 = block_inner(R0, Z0)
    resnorm0 = jnp.sqrt(jnp.abs(jnp.diagonal(block_inner(R0, R0))))

    if callback is not None:
        callback(x0_arr, R0[..., 0] if squeeze else R0)

    vdtype = jnp.result_type(Z0.dtype, R0.dtype)
    state0 = BlockCGState(
        k=jnp.asarray(0, jnp.int32),
        X=jnp.zeros(B.shape, vdtype),
        R=R0.astype(vdtype),
        Z=Z0.astype(vdtype),
        P=Z0.astype(vdtype),
        gamma=gamma0,
        resnorm=resnorm0,
    )

    def step(st: BlockCGState, criterion) -> BlockCGState:
        Q = jnp.asarray(A @ st.P)
        delta = block_inner(st.P, Q)          # (k, k), one reduction
        alpha = _gram_solve(delta, st.gamma)
        X = st.X + prec.einsum("...k,kl->...l", st.P, alpha)
        R = st.R - prec.einsum("...k,kl->...l", Q, alpha)
        Z = jnp.asarray(M_op @ R)
        gamma_new = block_inner(R, Z)         # (k, k), one reduction
        beta = _gram_solve(st.gamma, gamma_new)
        P = Z + prec.einsum("...k,kl->...l", st.P, beta)
        # Euclidean per-column residual norms; free when M is the identity
        # (Z == R), one extra contraction otherwise
        rr = (
            jnp.abs(jnp.diagonal(gamma_new))
            if unpreconditioned
            else jnp.abs(jnp.diagonal(block_inner(R, R)))
        )

        # periodic explicit replacement + direction restart (see docstring)
        from jax import lax as _lax

        k1 = st.k + 1
        do_replace = (k1 % replace_every) == 0

        def replaced(X_):
            # full restart: explicit residual AND P reset to Z -- the
            # conjugacy chain (P against gamma) is where f32 drift lives,
            # so a kept P after refreshing gamma diverges (measured)
            R_ = residuals(X0 + X_).astype(vdtype)
            Z_ = jnp.asarray(M_op @ R_).astype(vdtype)
            g_ = block_inner(R_, Z_)
            rr_ = (
                jnp.abs(jnp.diagonal(g_))
                if unpreconditioned
                else jnp.abs(jnp.diagonal(block_inner(R_, R_)))
            )
            return R_, Z_, Z_, g_, rr_

        if backend == EAGER:
            if bool(np.asarray(do_replace)):
                R, Z, P, gamma_new, rr = replaced(X)
        else:
            R, Z, P, gamma_new, rr = _lax.cond(
                do_replace, replaced,
                lambda X_: (R, Z, P, gamma_new, rr), X,
            )

        return BlockCGState(
            k=k1, X=X, R=R, Z=Z, P=P, gamma=gamma_new,
            resnorm=jnp.sqrt(rr),
        )

    def xk_of(st: BlockCGState):
        full = X0 + st.X
        return full[..., 0] if squeeze else full

    def explicit_resnorm(xk):
        Rx = residuals(xk[..., None] if squeeze else xk)
        rn = jnp.sqrt(jnp.abs(jnp.diagonal(block_inner(Rx, Rx))))
        return rn[0] if squeeze else rn

    def run_resnorm_view(st):
        return st.resnorm[0] if squeeze else st.resnorm

    # the driver reads state.resnorm directly; wrap states so the tail
    # matches b's shape
    class _View(NamedTuple):
        inner_state: BlockCGState
        resnorm: jnp.ndarray

    def vstep(v: _View, criterion) -> _View:
        s2 = step(v.inner_state, criterion)
        return _View(s2, run_resnorm_view(s2))

    vmethod = Method(
        step=vstep,
        xk=lambda v: xk_of(v.inner_state),
        explicit_resnorm=explicit_resnorm,
        callback_args=lambda v: (
            xk_of(v.inner_state),
            v.inner_state.R[..., 0] if squeeze else v.inner_state.R,
        ),
    )
    v0 = _View(state0, run_resnorm_view(state0))
    state, success, k, resnorms = run(
        v0, vmethod, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    xk = xk_of(state.inner_state)
    info = Info(success, xk, k, resnorms)
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info
