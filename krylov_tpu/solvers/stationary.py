"""Stationary iterative methods: Richardson, Jacobi, Gauss–Seidel, SOR, SSOR.

Capability parity with the reference (reference: src/krylov/stationary.py):
a shared driver iterates ``x += update(r); r = b - A x`` with no explicit
residual re-check (reference: src/krylov/stationary.py:138-140 — the
recurrence *is* the explicit residual here).

Triangular sweeps, by operator type:

* dense matrices — jax's triangular solve reads only the requested triangle,
  exactly like the scipy call the reference makes (reference:
  src/krylov/stationary.py:29-30);
* :class:`~krylov_tpu.ops.stencil.GridStencilOperator` — scalable scan
  sweeps (ops/triangular.py: ``lax.scan`` over grid rows, within-row
  first-order recurrence via ``associative_scan``), no dense
  materialization at any size — the data-parallel substitute for scipy's sequential
  ``spsolve_triangular``;
* other sparse operators — materialized densely below ``_DENSE_SWEEP_MAX``
  rows (small-problem parity path); above that, the level-scheduled sweep
  (:class:`~krylov_tpu.ops.triangular.LevelScheduledTriangularSolve`)
  executes one data-parallel stage per dependency level — exact at any
  size for factors whose level count is bounded (unstructured FEM/graph
  matrices); deep chains should use the grid scan sweeps or the smoother
  form.
"""

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from .._driver import EAGER, Method, run
from .._info import Info
from .._inner import ensure_real
from .._operators import MatrixOperator, as_operator
from ._common import setup

_DENSE_SWEEP_MAX = 8192


class StationaryState(NamedTuple):
    x: jnp.ndarray
    r: jnp.ndarray
    resnorm: jnp.ndarray


def _stationary(
    update,
    A,
    b,
    x0=None,
    inner: Optional[Callable] = None,
    tol: float = 1e-5,
    atol: float = 1.0e-15,
    maxiter: Optional[int] = None,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    A, b, x0_arr, N, inner, maxiter = setup(A, b, x0=x0, inner=inner, maxiter=maxiter)

    def _norm(x):
        return jnp.sqrt(ensure_real(inner(x, x), "<x, x>"))

    x_init = x0_arr
    r0 = jnp.asarray(b) if x0 is None else b - A @ x_init

    if callback is not None:
        callback(x_init, r0)

    state0 = StationaryState(x=x_init.astype(r0.dtype), r=r0, resnorm=_norm(r0))

    def step(s: StationaryState, criterion) -> StationaryState:
        x = s.x + update(s.r)
        r = b - A @ x
        return StationaryState(x=x, r=r, resnorm=_norm(r))

    method = Method(
        step=step,
        xk=lambda s: s.x,
        explicit_resnorm=None,  # stationary methods skip the double-check
        callback_args=lambda s: (s.x, s.r),
    )
    state, success, k, resnorms = run(
        state0, method, tol=tol, atol=atol, maxiter=maxiter,
        callback=callback, backend=backend,
    )
    info = Info(success, state.x, k, resnorms)
    if isinstance(success, (bool, np.bool_)):
        return state.x if success else None, info
    return state.x, info


def _dense_matrix(A):
    """Materialize a dense device matrix for small triangular sweeps."""
    if hasattr(A, "toarray") and not hasattr(A, "matvec"):  # scipy sparse
        return jnp.asarray(A.toarray())
    op = as_operator(A)
    if isinstance(op, MatrixOperator):
        return op.a
    if hasattr(op, "todense"):
        if op.shape[0] > _DENSE_SWEEP_MAX:
            raise NotImplementedError(
                f"triangular sweeps above {_DENSE_SWEEP_MAX} rows are not "
                "materialized densely for this operator type; pass the "
                "scipy matrix (level-scheduled path) or use the "
                "grid-stencil/smoother forms"
            )
        return jnp.asarray(op.todense())
    raise ValueError("Gauss-Seidel/SOR/SSOR need a matrix (not a bare operator)")


def _sparse_for_levels(A):
    """Return a host scipy CSR when A is sparse and too large to densify.

    Checked on the ORIGINAL input, before ``as_operator`` routing (which
    may turn a block-structured matrix into a BSROperator, with no CSR
    arrays to extract a triangle from)."""
    import scipy.sparse

    if hasattr(A, "tocsr") and not hasattr(A, "matvec"):  # scipy sparse
        sp = A.tocsr()
        return sp if sp.shape[0] > _DENSE_SWEEP_MAX else None
    from ..ops.sparse import CSROperator

    if isinstance(A, CSROperator) and A.shape[0] > _DENSE_SWEEP_MAX:
        return scipy.sparse.csr_matrix(
            (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
            shape=A.shape,
        )
    return None


def _level_solve(sp_csr, lower, diag_scale=None):
    """Level-scheduled solve of the (diag-rescaled) triangle of ``sp_csr``
    (unrolled stages for shallow factors, one ``lax.scan`` for deep ones —
    see :func:`~krylov_tpu.ops.triangular.make_triangular_solve`)."""
    import scipy.sparse

    from ..ops.triangular import make_triangular_solve

    tri = (scipy.sparse.tril if lower else scipy.sparse.triu)(sp_csr).tocsr()
    if diag_scale is not None:
        tri = tri.copy()
        tri.setdiag(tri.diagonal() / diag_scale)
    return make_triangular_solve(tri, lower=lower, max_levels=1024)


def _diagonal(A):
    op = as_operator(A)
    if hasattr(op, "diagonal"):
        return jnp.asarray(op.diagonal())
    raise ValueError("operator does not expose a diagonal()")


def _bcast(d, r):
    if d.size == r.size:
        # operator-native vector shapes (e.g. grid-shaped (M, ny)): the
        # diagonal aligns elementwise with the residual
        return d.reshape(r.shape)
    # flat multi-RHS: diagonal broadcasts over trailing RHS columns
    return d.reshape((-1,) + (1,) * (r.ndim - 1))


def richardson(*args, omega: float = 1.0, **kwargs):
    """x_{k+1} = x_k + omega * r  (reference: src/krylov/stationary.py:11-12)."""
    return _stationary(lambda r: omega * r, *args, **kwargs)


def jacobi(A, *args, omega: float = 1.0, **kwargs):
    """x_{k+1} = x_k + omega * D^{-1} r (reference: src/krylov/stationary.py:15-23)."""
    D = _diagonal(A)

    def _update(r):
        return omega * r / _bcast(D, r)

    return _stationary(_update, A, *args, **kwargs)


def _is_grid_stencil(A):
    from ..ops.stencil import GridStencilOperator

    if isinstance(A, GridStencilOperator):
        return True
    # row-partitioned shard (parallel.ShardedGridStencilOperator): sweeps
    # run per-shard with block-Jacobi boundaries — the hybrid smoother
    # semantics of SURVEY.md §7 (cross-shard lower coupling is dropped,
    # unlike the exact single-chip sweep)
    return isinstance(getattr(A, "_local", None), GridStencilOperator)


def _grid_sweep_update(A, omega_diag, lower):
    """Triangular-sweep update for GridStencilOperator at any scale.

    Uses the scan/associative-scan sweeps (ops/triangular.py) — the
    data-parallel substitute for scipy's sequential spsolve_triangular; works on flat,
    grid-shaped, and multi-RHS vectors.  For a row-partitioned shard the
    sweep is local (block-Jacobi boundaries between shards).
    """
    from ..ops.triangular import grid_lower_sweep, grid_upper_sweep

    A = getattr(A, "_local", A)
    sweep = grid_lower_sweep if lower else grid_upper_sweep
    M, ny = A.grid

    def update_one(r2):
        return sweep(
            A.coeffs2d, A.row_offsets, A.col_offsets, r2, omega=omega_diag
        )

    def update(r):
        if r.ndim == 2 and r.shape == (M, ny):
            return update_one(r)
        if r.ndim == 2:  # multi-RHS (N, k)
            rb = r.T.reshape(r.shape[1], M, ny)
            yb = jnp.stack([update_one(rb[i]) for i in range(r.shape[1])])
            return yb.reshape(r.shape[1], M * ny).T
        return update_one(r.reshape(M, ny)).reshape(r.shape)

    return update


def gauss_seidel(A, *args, omega: float = 1.0, lower: bool = True, **kwargs):
    """x_{k+1} = x_k + omega * tri(A)^{-1} r

    (reference: src/krylov/stationary.py:26-40)
    """
    if _is_grid_stencil(A):
        base = _grid_sweep_update(A, 1.0, lower)
        return _stationary(
            lambda r: omega * base(r), A, *args, **kwargs
        )
    sp = _sparse_for_levels(A)
    if sp is not None:
        solve = _level_solve(sp, lower)
        return _stationary(lambda r: omega * solve(r), A, *args, **kwargs)
    Ad = _dense_matrix(A)

    def tri_solve(y):
        return omega * jsl.solve_triangular(Ad, y, lower=lower)

    return _stationary(tri_solve, A, *args, **kwargs)


def sor(A, *args, omega: float = 1.0, lower: bool = True, **kwargs):
    """x_{k+1} = x_k + (D/omega + L)^{-1} r (reference: src/krylov/stationary.py:43-61)."""
    if _is_grid_stencil(A):
        return _stationary(
            _grid_sweep_update(A, omega, lower), A, *args, **kwargs
        )
    sp = _sparse_for_levels(A)
    if sp is not None:
        solve = _level_solve(sp, lower, diag_scale=omega)
        return _stationary(solve, A, *args, **kwargs)
    Ad = _dense_matrix(A)
    d_ = jnp.diagonal(Ad) / omega
    A_ = Ad.at[jnp.arange(Ad.shape[0]), jnp.arange(Ad.shape[0])].set(d_)

    def tri_solve(y):
        return jsl.solve_triangular(A_, y, lower=lower)

    return _stationary(tri_solve, A, *args, **kwargs)


def ssor(A, *args, omega: float = 1.0, **kwargs):
    """Symmetric SOR: forward sweep, diagonal scale, backward sweep.

    P = omega/(2-omega) * (D/omega + L) D^{-1} (D/omega + U)
    (reference: src/krylov/stationary.py:64-94)
    """
    if _is_grid_stencil(A):
        fwd = _grid_sweep_update(A, omega, True)
        bwd = _grid_sweep_update(A, omega, False)
        D = _diagonal(A)

        def solve(y):
            y = fwd(y)
            y = y * _bcast(D, y)
            y = bwd(y)
            return (2 - omega) / omega * y

        return _stationary(solve, A, *args, **kwargs)
    sp = _sparse_for_levels(A)
    if sp is not None:
        fwd = _level_solve(sp, True, diag_scale=omega)
        bwd = _level_solve(sp, False, diag_scale=omega)
        D = jnp.asarray(sp.diagonal())

        def solve(y):
            y = fwd(y)
            y = y * _bcast(D, y)
            y = bwd(y)
            return (2 - omega) / omega * y

        return _stationary(solve, A, *args, **kwargs)
    Ad = _dense_matrix(A)
    d = jnp.diagonal(Ad)
    idx = jnp.arange(Ad.shape[0])
    A_ = Ad.at[idx, idx].set(d / omega)

    def solve(y):
        y = jsl.solve_triangular(A_, y, lower=True)
        y = y * _bcast(d, y)
        y = jsl.solve_triangular(A_, y, lower=False)
        return (2 - omega) / omega * y

    return _stationary(solve, A, *args, **kwargs)


class SSORSmoother:
    """One SSOR application as a preconditioner operator ``M r ~= P^{-1} r``.

    ``P = omega/(2-omega) * (D/omega + L) D^{-1} (D/omega + U)`` — SPD for
    SPD ``A``, so a valid CG/MINRES ``M`` and a left preconditioner for
    the transpose-free two-sided family (BiCGSTAB/CGS).  Reuses the sweep
    backends of :func:`ssor` (reference capability:
    src/krylov/stationary.py:64-94 used as a solver; the smoother form is
    the scalable preconditioner the reference leaves to the user):

    * (possibly sharded) grid stencils -> scan sweeps; on a
      row-partitioned shard the sweep is local, i.e. block-Jacobi
      boundaries between shards — pair with
      ``sharded_solve(..., M_factory=lambda A_l: SSORSmoother(A_l))``;
    * large scipy/CSR matrices -> level-scheduled sweeps;
    * small matrices -> dense triangular solves.

    ``rmatvec`` assumes a Hermitian ``A`` (then ``P`` is Hermitian); QMR
    with a non-Hermitian ``A`` should use a Jacobi/diagonal ``Ml``
    instead.
    """

    def __init__(self, A, omega: float = 1.0):
        self.omega = float(omega)
        omega = self.omega
        if _is_grid_stencil(A):
            fwd = _grid_sweep_update(A, omega, True)
            bwd = _grid_sweep_update(A, omega, False)
            D = _diagonal(A)
        else:
            sp = _sparse_for_levels(A)
            if sp is not None:
                fwd = _level_solve(sp, True, diag_scale=omega)
                bwd = _level_solve(sp, False, diag_scale=omega)
                D = jnp.asarray(sp.diagonal())
            else:
                Ad = _dense_matrix(A)
                d = jnp.diagonal(Ad)
                idx = jnp.arange(Ad.shape[0])
                A_ = Ad.at[idx, idx].set(d / omega)
                fwd = lambda y: jsl.solve_triangular(A_, y, lower=True)
                bwd = lambda y: jsl.solve_triangular(A_, y, lower=False)
                D = d
        self._fwd, self._bwd, self._D = fwd, bwd, D
        self.dtype = np.dtype(getattr(D, "dtype", np.float64))

    def __matmul__(self, r):
        y = self._fwd(r)
        y = y * _bcast(self._D, y)
        y = self._bwd(y)
        return (2 - self.omega) / self.omega * y

    matvec = __matmul__

    def rmatvec(self, r):
        return self @ r
