"""Preconditioned GMRES.

Capability parity with the reference (reference: src/krylov/gmres.py:41-251):
M/Ml/Mr preconditioning, arbitrary inner product, multi-RHS blocking,
``ortho`` in {"mgs", "mgs<N>", "householder"} (householder requires the
Euclidean inner product and M=Identity, as in the reference), per-iteration
callback, num_operations model.  The stray debug prints in the reference hot
loop (reference: src/krylov/gmres.py:201-205, a v0.0.3 bug) are of course not
replicated.

Build-side extension beyond the reference's ortho set: ``ortho="cgs"``
(alias "cgs2"; "cgs<N>" for N passes) — re-orthogonalized classical
Gram-Schmidt, where each sweep is ONE batched Gram contraction + ONE basis
combination instead of k+1 dependent inner products.  Under
``sharded_solve`` the sweep's coefficients travel in a single ``psum``
(the ``batch_inner`` injection point), cutting GMRES's per-iteration
allreduce count from O(k) to O(1); two passes (CGS2) keep MGS-level
orthogonality (Giraud/Langou/Rozložník 2005).

**Choosing ``ortho``.**  On one device the default ``ortho="mgs"`` does
the least work per iteration; the CGS sweep adds a second pass over the
basis (its combination step).  SHARDED solves are a different trade: there MGS still pays k+1
DEPENDENT ``psum`` latencies per iteration while the batched-CGS sweep
pays ONE — prefer ``ortho="cgs"`` under ``sharded_solve`` on real
multi-chip meshes where allreduce latency dominates.

Two drivers over the same mathematics:

* eager — host loop over the Arnoldi iterator classes (supports every ortho
  and custom inner products, float64 parity mode);
* while_loop — the full solve compiled: fixed ``(maxiter+1, N, ...)`` V/P
  basis buffers, masked-length MGS via ``fori_loop``, a stored-rotation
  buffer for the Givens QR, and a padded on-device triangular solve at exit.
  No host round-trips per iteration.
"""

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .._driver import EAGER, WHILE_LOOP, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import Identity, Product
from ..arnoldi import ArnoldiCGS, ArnoldiHouseholder, ArnoldiMGS, padded_reflector_at
from ..givens import apply_givens, givens
from ..ops.triangular import multi_solve_triangular
from ._common import initial_residual, preconditioner, setup
from .. import _precision as prec


def _num_operations(k):
    return {
        "A": 1 + k,
        "M": 2 + k,
        "Ml": 2 + k,
        "Mr": 1 + k,
        "inner": 2 + k + k * (k + 1) / 2,
        "axpy": 4 + 2 * k + k * (k + 1) / 2,
    }


def gmres(
    A,
    b,
    M=None,
    Ml=None,
    Mr=None,
    inner: Optional[Callable] = None,
    ortho: str = "mgs",
    x0=None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    restart: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
    batch_inner: Optional[Callable] = None,
):
    if restart is not None:
        return _gmres_restarted(
            A, b, M=M, Ml=Ml, Mr=Mr, inner=inner, ortho=ortho, x0=x0,
            tol=tol, atol=atol, maxiter=maxiter, restart=restart,
            callback=callback, backend=backend, batch_inner=batch_inner,
        )
    inner_is_none = inner is None
    if maxiter is None:
        bshape = jnp.shape(jnp.asarray(b)) if not hasattr(b, "shape") else b.shape
        # N = rows only; RHS columns scale the basis linearly, not the
        # iteration count that makes it O(N^2)
        if bshape and int(bshape[0]) >= (1 << 13):
            import warnings

            n_rhs = int(np.prod(bshape[1:])) if len(bshape) > 1 else 1
            warnings.warn(
                "full GMRES with maxiter=None allocates an O(N^2) basis "
                f"(N = {int(bshape[0])}"
                + (f", x{n_rhs} RHS columns" if n_rhs > 1 else "")
                + "); pass maxiter= or use restart= (GMRES(m)) at this "
                "scale",
                stacklevel=2,
            )
    x0_default = x0 is None
    A, b, x0, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)
    M = preconditioner(M)
    Ml = preconditioner(Ml)
    Mr = preconditioner(Mr)
    Ml_A_Mr = Product(Ml, A, Mr)

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

    if callback is not None:
        callback(x0, norm0)

    common = dict(
        A=A, b=b, x0=x0, M=M, Ml=Ml, Mr=Mr, Ml_A_Mr=Ml_A_Mr, inner=inner,
        residual_norm=residual_norm, Ml_r0=Ml_r0, M_Ml_r0=M_Ml_r0, norm0=norm0,
        tol=tol, atol=atol, maxiter=maxiter, callback=callback,
    )

    if backend == WHILE_LOOP:
        if ortho == "householder":
            if not inner_is_none:
                raise ValueError(
                    "ortho='householder' requires the default inner product"
                )
            if not isinstance(M, Identity):
                raise ValueError("ortho='householder' does not support M")
            return _gmres_while_householder(**common)
        if ortho.startswith("cgs"):
            num_passes = 2 if len(ortho) == 3 else int(ortho[3:])
            return _gmres_while(
                num_reorthos=num_passes, cgs=True,
                batch_inner=_make_batch_inner(batch_inner, inner, inner_is_none),
                **common,
            )
        if not ortho.startswith("mgs"):
            raise ValueError(f"unknown orthogonalization {ortho!r}")
        num_reorthos = 1 if len(ortho) == 3 else int(ortho[3:])
        return _gmres_while(num_reorthos=num_reorthos, **common)

    return _gmres_eager(ortho=ortho, inner_is_none=inner_is_none, **common)


def _make_batch_inner(batch_inner, inner, inner_is_none):
    """Batched basis-against-vector inner product for CGS sweeps.

    ``batch(Vbuf, w)`` contracts a stacked ``(K+1, N, *tail)`` basis
    buffer against one vector in a single operation — the injection point
    ``sharded_solve`` replaces with a one-``psum`` mesh reduction
    (parallel/mesh.py:psum_batch_inner).  Default: one einsum for the
    Euclidean inner; a vmap of the user inner otherwise (semantics
    preserved, batching win limited to dispatch).
    """
    if batch_inner is not None:
        return batch_inner
    if inner_is_none:
        return lambda Vb, w: prec.einsum("kn...,n...->k...", jnp.conj(Vb), w)
    return lambda Vb, w: jax.vmap(lambda v: inner(v, w))(Vb)


def _gmres_restarted(
    A, b, *, M, Ml, Mr, inner, ortho, x0, tol, atol, maxiter, restart,
    callback, backend, batch_inner=None,
):
    """GMRES(m): restart every ``restart`` iterations.

    A build-side extension (the reference has no restarts — SURVEY.md §7):
    full GMRES stores the whole O(maxiter * N) basis, which is infeasible at
    benchmark scale; GMRES(m) caps memory at O(m * N).  Convergence is judged
    against the criterion of the *initial* residual (``max(tol * resnorm0,
    atol)`` once, like every other solver), not per-cycle, so trajectories
    concatenate consistently.  Each cycle is one compiled solve; the restart
    loop runs on host (restart count is data-dependent and small).
    """
    import jax.numpy as _jnp

    b_arr = _jnp.asarray(b)
    N = b_arr.shape[0]
    total_max = N if maxiter is None else maxiter
    m = min(restart, total_max)

    x = x0
    resnorms = None
    criterion = None
    numsteps = 0
    success = False
    while True:
        cycle_max = min(m, total_max - numsteps)
        kw = dict(
            M=M, Ml=Ml, Mr=Mr, inner=inner, ortho=ortho, x0=x,
            maxiter=cycle_max, callback=callback, backend=backend,
            batch_inner=batch_inner,
        )
        if criterion is None:
            sol, info = gmres(A, b, tol=tol, atol=atol, **kw)
            # per-RHS-column criterion (the driver's atol broadcasts
            # elementwise, so each column keeps its own tol*resnorm0 bound
            # across restart cycles)
            criterion = np.maximum(tol * np.asarray(info.resnorms[0]), atol)
            resnorms = np.asarray(info.resnorms)
        else:
            sol, info = gmres(A, b, tol=0.0, atol=criterion, **kw)
            # entry 0 re-measures the explicit residual of the restart
            # iterate; keep it (it may differ from the previous recurrence
            # value — that is the honest trajectory)
            resnorms = np.concatenate([resnorms, np.asarray(info.resnorms)[1:]])
        numsteps += info.numsteps
        x = info.xk
        success = bool(info.success)
        if success or numsteps >= total_max or info.numsteps == 0:
            break

    info = Info(success, x, numsteps, resnorms, _num_operations(numsteps))
    return (x if success else None), info


class _EagerState(NamedTuple):
    R: jnp.ndarray
    y: jnp.ndarray
    resnorm: jnp.ndarray


def _gmres_eager(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback, ortho, inner_is_none,
):
    if ortho.startswith("mgs"):
        num_reorthos = 1 if len(ortho) == 3 else int(ortho[3:])
        arnoldi = ArnoldiMGS(
            Ml_A_Mr, Ml_r0, num_reorthos=num_reorthos, M=M,
            Mv=M_Ml_r0, Mv_norm=norm0, inner=inner,
        )
    elif ortho.startswith("cgs"):
        num_passes = 2 if len(ortho) == 3 else int(ortho[3:])
        arnoldi = ArnoldiCGS(
            Ml_A_Mr, Ml_r0, num_passes=num_passes, M=M,
            Mv=M_Ml_r0, Mv_norm=norm0, inner=inner,
        )
    elif ortho == "householder":
        if not inner_is_none:
            raise ValueError("ortho='householder' requires the default inner product")
        if not isinstance(M, Identity):
            raise ValueError("ortho='householder' does not support M")
        arnoldi = ArnoldiHouseholder(Ml_A_Mr, Ml_r0)
    else:
        raise ValueError(f"unknown orthogonalization {ortho!r}")

    dtype = M_Ml_r0.dtype
    tail = jnp.shape(norm0)
    R0 = jnp.zeros((maxiter + 1, maxiter) + tail, dtype=dtype)
    y0 = jnp.zeros((maxiter + 1,) + tail, dtype=dtype).at[0].set(norm0)
    G = []  # rotation history (host list, eager only)

    def step(s: _EagerState, criterion) -> _EagerState:
        k = arnoldi.iter
        _, h = next(arnoldi)

        R = s.R.at[: k + 2, k].set(h[: k + 2])
        for i in range(k):
            R = R.at[i : i + 2, k].set(apply_givens(G[i], R[i : i + 2, k]))
        g, r = givens(R[k : k + 2, k])
        G.append(g)
        R = R.at[k, k].set(r).at[k + 1, k].set(0.0)
        ypair = apply_givens(g, s.y[k : k + 2])
        y = s.y.at[k : k + 2].set(ypair)
        return _EagerState(R=R, y=y, resnorm=jnp.abs(ypair[1]))

    def xk_of(s: _EagerState):
        kk = arnoldi.iter
        if kk == 0:
            return x0
        yy = multi_solve_triangular(s.R[:kk, :kk], s.y[:kk])
        yk = sum(c * v for c, v in zip(yy, arnoldi.V))
        return x0 + Mr @ yk

    method = Method(
        step=step,
        xk=xk_of,
        explicit_resnorm=residual_norm,
        callback_args=lambda s: (xk_of(s), s.resnorm),
    )
    state0 = _EagerState(R=R0, y=y0, resnorm=norm0)
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=EAGER,
    )

    xk = xk_of(state)
    info = Info(success, xk, k, resnorms, _num_operations(k))
    return xk if success else None, info


def _givens_qr_update(G, R, y, h, k, dtype):
    """Fold Hessenberg column ``h`` into the running Givens QR.

    Applies the ``k`` stored rotations to ``h``, generates + stores the
    rotation annihilating the subdiagonal, updates column ``k`` of R and
    rotates the projected rhs ``y``.  Returns ``(G, R, y, |y[k+1]|)`` —
    the last value is the GMRES residual-norm recurrence.
    """

    def rot_body(i, c):
        pair = apply_givens(G[i], jnp.stack([c[i], c[i + 1]]))
        return c.at[i].set(pair[0]).at[i + 1].set(pair[1])

    c = lax.fori_loop(0, k, rot_body, h)

    g, r = givens(jnp.stack([c[k], c[k + 1]]))
    c = c.at[k].set(r).at[k + 1].set(jnp.zeros_like(r))
    R = lax.dynamic_update_index_in_dim(R, c[:-1].astype(dtype), k, 1)
    G = G.at[k].set(g.astype(dtype))

    ypair = apply_givens(g.astype(dtype), jnp.stack([y[k], y[k + 1]]))
    y = y.at[k].set(ypair[0]).at[k + 1].set(ypair[1])
    return G, R, y, jnp.abs(ypair[1])


def _eye2_rotations(K, tail, dtype):
    eye2 = jnp.broadcast_to(
        jnp.eye(2, dtype=dtype).reshape((2, 2) + (1,) * len(tail)),
        (2, 2) + tail,
    )
    return jnp.broadcast_to(eye2, (K, 2, 2) + tail).astype(dtype)


class _WhileState(NamedTuple):
    k: jnp.ndarray  # iteration counter (needed by the masked MGS)
    V: jnp.ndarray  # (K+1, N, *tail) M-preconditioned basis
    P: jnp.ndarray  # (K+1, N, *tail) dual basis, V = M P
    R: jnp.ndarray  # (K+1, K, *tail) triangular factor
    G: jnp.ndarray  # (K, 2, 2, *tail) rotation history
    y: jnp.ndarray  # (K+1, *tail) rotated projected rhs
    resnorm: jnp.ndarray


def _gmres_while(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback, num_reorthos, cgs=False,
    batch_inner=None,
):
    K = maxiter
    tail = jnp.shape(norm0)
    dtype = M_Ml_r0.dtype
    idxK1 = jnp.arange(K + 1).reshape((K + 1,) + (1,) * len(tail))

    safe0 = jnp.where(norm0 != 0.0, norm0, 1.0)
    V0 = jnp.zeros((K + 1,) + b.shape, dtype).at[0].set(M_Ml_r0 / safe0)
    P0 = jnp.zeros((K + 1,) + b.shape, dtype).at[0].set(Ml_r0 / safe0)
    R0 = jnp.zeros((K + 1, K) + tail, dtype)
    G0 = _eye2_rotations(K, tail, dtype)
    y0 = jnp.zeros((K + 1,) + tail, dtype).at[0].set(norm0)

    state0 = _WhileState(
        k=jnp.asarray(0, jnp.int32), V=V0, P=P0, R=R0, G=G0, y=y0, resnorm=norm0
    )

    def step(s: _WhileState, criterion) -> _WhileState:
        k = s.k
        v = s.V[k]
        Av = Ml_A_Mr @ v

        h = jnp.zeros((K + 1,) + tail, dtype)

        if cgs:
            # classical Gram-Schmidt: the whole sweep is ONE batched Gram
            # contraction + ONE basis combination (rows beyond k of the
            # V/P buffers are zero, so the contraction is self-masking;
            # the explicit mask keeps the invariant under future buffer
            # reuse).  One psum per sweep when sharded.
            active = (idxK1 <= k).astype(dtype)
            for _ in range(num_reorthos):
                alphas = batch_inner(s.V, Av) * active
                h = h + alphas
                Av = Av - prec.einsum("k...,kn...->n...", alphas, s.P)
        else:

            def mgs_body(j, carry):
                Av, h = carry
                alpha = inner(s.V[j], Av)
                h = h.at[j].add(alpha)
                Av = Av - alpha * s.P[j]
                return Av, h

            for _ in range(num_reorthos):
                Av, h = lax.fori_loop(0, k + 1, mgs_body, (Av, h))

        MAv = M @ Av
        hk1 = jnp.sqrt(inner(Av, MAv))
        h = h.at[k + 1].set(hk1)
        safe = jnp.where(hk1 != 0.0, hk1, 1.0)
        V = s.V.at[k + 1].set(MAv / safe)
        P = s.P.at[k + 1].set(Av / safe)

        G, R, y, resnorm = _givens_qr_update(s.G, s.R, s.y, h, k, dtype)
        return _WhileState(k=k + 1, V=V, P=P, R=R, G=G, y=y, resnorm=resnorm)

    def xk_of(s: _WhileState):
        kk = s.k
        # pad the (kk x kk) system to the static (K x K) buffer: unit diagonal
        # and zero rhs beyond kk decouple exactly
        idx = jnp.arange(K)
        active = idx < kk
        diag_fix = jnp.where(active, 0.0, 1.0).astype(dtype)
        Rsq = s.R[:K] + jnp.diag(diag_fix).reshape((K, K) + (1,) * len(tail))
        yv = jnp.where(
            active.reshape((K,) + (1,) * len(tail)), s.y[:K], jnp.zeros_like(s.y[:K])
        )
        yy = multi_solve_triangular(Rsq, yv)
        yk = prec.einsum("k...,kn...->n...", yy, s.V[:K])
        return x0 + Mr @ yk

    method = Method(
        step=step, xk=xk_of, explicit_resnorm=residual_norm,
        # xk_of per iteration costs a triangular solve + basis
        # combination; the driver only evaluates it when a callback is
        # actually installed
        callback_args=lambda s: (xk_of(s), s.resnorm),
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=WHILE_LOOP,
    )

    xk = xk_of(state)
    kk = int(k) if not isinstance(k, jax.core.Tracer) else k
    info = Info(success, xk, kk, resnorms, _num_operations(kk))
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info


class _WhileHouseState(NamedTuple):
    k: jnp.ndarray  # iteration counter
    V: jnp.ndarray  # (K+1, N, *tail) orthonormal basis (reconstructed)
    U: jnp.ndarray  # (K+2, N, *tail) padded reflector directions
    betas: jnp.ndarray  # (K+2, *tail)
    alphas: jnp.ndarray  # (K+2, *tail) phase factors
    R: jnp.ndarray  # (K+1, K, *tail) triangular factor
    G: jnp.ndarray  # (K, 2, 2, *tail) rotation history
    y: jnp.ndarray  # (K+1, *tail) rotated projected rhs
    resnorm: jnp.ndarray


def _gmres_while_householder(
    *, A, b, x0, M, Ml, Mr, Ml_A_Mr, inner, residual_norm, Ml_r0, M_Ml_r0,
    norm0, tol, atol, maxiter, callback,
):
    """Compiled Householder-Arnoldi GMRES.

    The reference offers householder orthogonalization as a first-class
    GMRES mode (reference: src/krylov/gmres.py:147-162); here it runs
    fully under ``lax.while_loop``: reflectors are stored as full-length
    padded vectors (:func:`krylov_tpu.arnoldi.padded_reflector_at`), so
    the projection sweep and the basis reconstruction are ``fori_loop``
    chains of whole-vector updates with no suffix slicing.
    """
    K = maxiter
    N = b.shape[0]
    tail = jnp.shape(norm0)
    dtype = M_Ml_r0.dtype
    idxN = jnp.arange(N).reshape((N,) + (1,) * len(tail))
    idxK = jnp.arange(K + 1).reshape((K + 1,) + (1,) * len(tail))

    def reflect(u, beta, w):
        return w - beta * u * jnp.sum(jnp.conj(u) * w, axis=0)

    u0, b0, a0, _ = padded_reflector_at(Ml_r0.astype(dtype), 0)
    safe0 = jnp.where(norm0 != 0.0, norm0, 1.0)
    V0 = jnp.zeros((K + 1,) + b.shape, dtype).at[0].set(
        Ml_r0.astype(dtype) / safe0
    )
    U0 = jnp.zeros((K + 2,) + b.shape, dtype).at[0].set(u0)
    betas0 = jnp.zeros((K + 2,) + tail, dtype).at[0].set(b0.astype(dtype))
    alphas0 = jnp.zeros((K + 2,) + tail, dtype).at[0].set(a0.astype(dtype))
    R0 = jnp.zeros((K + 1, K) + tail, dtype)
    G0 = _eye2_rotations(K, tail, dtype)
    y0 = jnp.zeros((K + 1,) + tail, dtype).at[0].set(norm0)

    state0 = _WhileHouseState(
        k=jnp.asarray(0, jnp.int32), V=V0, U=U0, betas=betas0,
        alphas=alphas0, R=R0, G=G0, y=y0, resnorm=norm0,
    )

    def step(s: _WhileHouseState, criterion) -> _WhileHouseState:
        k = s.k
        w = jnp.asarray(Ml_A_Mr @ s.V[k]).astype(dtype)

        # forward projection: reflectors 0..k, fixing the phase of entry j
        def proj_body(j, w):
            w = reflect(s.U[j], s.betas[j], w)
            return jnp.where(idxN == j, w * jnp.conj(s.alphas[j]), w)

        w = lax.fori_loop(0, k + 1, proj_body, w)

        # new reflector annihilating w below position k+1
        u, beta, alpha, xnorm = padded_reflector_at(w, k + 1)
        U = s.U.at[k + 1].set(u)
        betas = s.betas.at[k + 1].set(beta.astype(dtype))
        alphas = s.alphas.at[k + 1].set(alpha.astype(dtype))
        w = reflect(u, beta.astype(dtype), w)
        w = jnp.where(idxN == k + 1, w * jnp.conj(alpha), w)

        # Hessenberg column: entries 0..k, then |w[k+1]| = xnorm
        wk = w if N >= K + 1 else jnp.concatenate(
            [w, jnp.zeros((K + 1 - N,) + w.shape[1:], dtype)], axis=0
        )
        h = jnp.where(idxK <= k, wk[: K + 1], 0)
        h = jnp.where(idxK == k + 1, xnorm.astype(dtype), h)

        # basis vector k+1: reflectors k+1..0 applied to e_{k+1} in
        # reverse, scaled by the newest phase
        e = jnp.where(idxN == k + 1, jnp.ones((), dtype), jnp.zeros((), dtype))
        e = jnp.broadcast_to(e, b.shape).astype(dtype)

        def recon_body(i, e):
            j = k + 1 - i
            return reflect(U[j], betas[j], e)

        e = lax.fori_loop(0, k + 2, recon_body, e)
        V = s.V.at[k + 1].set(e * alphas[k + 1])

        G, R, y, resnorm = _givens_qr_update(s.G, s.R, s.y, h, k, dtype)
        return _WhileHouseState(
            k=k + 1, V=V, U=U, betas=betas, alphas=alphas, R=R, G=G, y=y,
            resnorm=resnorm,
        )

    def xk_of(s: _WhileHouseState):
        kk = s.k
        idx = jnp.arange(K)
        active = idx < kk
        diag_fix = jnp.where(active, 0.0, 1.0).astype(dtype)
        Rsq = s.R[:K] + jnp.diag(diag_fix).reshape((K, K) + (1,) * len(tail))
        yv = jnp.where(
            active.reshape((K,) + (1,) * len(tail)),
            s.y[:K],
            jnp.zeros_like(s.y[:K]),
        )
        yy = multi_solve_triangular(Rsq, yv)
        yk = prec.einsum("k...,kn...->n...", yy, s.V[:K])
        return x0 + Mr @ yk

    method = Method(
        step=step, xk=xk_of, explicit_resnorm=residual_norm,
        # xk_of per iteration costs a triangular solve + basis
        # combination; the driver only evaluates it when a callback is
        # actually installed
        callback_args=lambda s: (xk_of(s), s.resnorm),
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=WHILE_LOOP,
    )

    xk = xk_of(state)
    kk = int(k) if not isinstance(k, jax.core.Tracer) else k
    info = Info(success, xk, kk, resnorms, _num_operations(kk))
    if isinstance(success, (bool, np.bool_)):
        return xk if success else None, info
    return xk, info
