"""Grid-stencil triangular sweeps: GS/SOR/SSOR at any scale without dense
materialization (the data-parallel substitute for scipy's spsolve_triangular —
SURVEY.md §2.2 native-crossing table)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg

import krylov_tpu
from krylov_tpu.ops import stencil
from krylov_tpu.ops.triangular import grid_lower_sweep, grid_upper_sweep


def _scipy_csr(A):
    c = A.tocsr()
    return scipy.sparse.csr_matrix(
        (np.asarray(c.data), np.asarray(c.indices), np.asarray(c.indptr)),
        shape=c.shape,
    )


@pytest.mark.parametrize("shape", [(8, 16), (6, 4, 8)])
def test_lower_sweep_matches_scipy(shape):
    A = (stencil.poisson_2d if len(shape) == 2 else stencil.poisson_3d)(*shape)
    N = int(np.prod(shape))
    sp = _scipy_csr(A)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(N)
    L = scipy.sparse.tril(sp, 0).tocsr()
    want = scipy.sparse.linalg.spsolve_triangular(L, b, lower=True)
    M, ny = A.grid
    got = grid_lower_sweep(
        A.coeffs2d, A.row_offsets, A.col_offsets, jnp.asarray(b).reshape(M, ny)
    )
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want, atol=1e-13)


def test_upper_sweep_matches_scipy():
    A = stencil.poisson_2d(8, 16)
    sp = _scipy_csr(A)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(128)
    U = scipy.sparse.triu(sp, 0).tocsr()
    want = scipy.sparse.linalg.spsolve_triangular(U, b, lower=False)
    got = grid_upper_sweep(
        A.coeffs2d, A.row_offsets, A.col_offsets, jnp.asarray(b).reshape(8, 16)
    )
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want, atol=1e-13)


@pytest.mark.parametrize(
    "solver,kw",
    [
        (krylov_tpu.gauss_seidel, {}),
        (krylov_tpu.gauss_seidel, {"lower": False}),
        (krylov_tpu.sor, {"omega": 1.4}),
        (krylov_tpu.ssor, {"omega": 1.2}),
    ],
)
def test_grid_sweep_solvers_match_dense_path(solver, kw):
    A = stencil.poisson_2d(8, 16)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(128))

    # dense reference path on the same matrix
    Ad = np.asarray(A.todense())
    sol_ref, info_ref = solver(Ad, b, maxiter=20, tol=1e-30, **kw)
    sol, info = solver(A, b, maxiter=20, tol=1e-30, **kw)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-10, atol=1e-12
    )


def test_grid_gs_converges_and_multi_rhs():
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(64))
    sol, info = krylov_tpu.gauss_seidel(A, b, tol=1e-8, maxiter=2000)
    assert info.success
    B = jnp.asarray(rng.standard_normal((64, 2)))
    sol2, info2 = krylov_tpu.gauss_seidel(A, B, tol=1e-8, maxiter=2000)
    assert info2.success


def test_level_scheduled_gs_matches_scipy_100k():
    """GS on a 100k-row unstructured sparse system matches a scipy
    spsolve_triangular reference trajectory (SURVEY hard part #2; the
    8192-row dense cutoff no longer bounds general-sparse sweeps)."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(77)
    n = 100_000
    k = 4  # strict-lower neighbors per row, drawn from all earlier rows
    rows = np.repeat(np.arange(1, n), k)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    vals = 0.2 * rng.standard_normal(rows.shape[0])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()

    b = rng.standard_normal(n)

    sol, info = krylov_tpu.gauss_seidel(
        A, jnp.asarray(b), tol=1e-6, maxiter=12, backend="while_loop"
    )
    assert info.success

    # reference trajectory via scipy's sequential solver
    L = scipy.sparse.tril(A).tocsr()
    x = np.zeros(n)
    r = b.copy()
    ref = [np.linalg.norm(r)]
    for _ in range(info.numsteps):
        x = x + spla.spsolve_triangular(L, r, lower=True)
        r = b - A @ x
        ref.append(np.linalg.norm(r))
    np.testing.assert_allclose(
        np.asarray(info.resnorms), np.asarray(ref), rtol=1e-9, atol=1e-12
    )


def test_level_scheduled_sor_ssor_large_sparse():
    import scipy.sparse

    rng = np.random.default_rng(78)
    n = 9_000
    rows = np.repeat(np.arange(1, n), 3)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    vals = 0.15 * rng.standard_normal(rows.shape[0])
    A = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T).tocsr()
    A.setdiag(3.0 + rng.random(n))
    A.sum_duplicates()
    b = rng.standard_normal(n)

    for solver, kw in [
        (krylov_tpu.sor, dict(omega=1.2)),
        (krylov_tpu.ssor, dict(omega=1.2)),
    ]:
        sol, info = solver(
            A, jnp.asarray(b), tol=1e-6, maxiter=40, backend="while_loop", **kw
        )
        assert info.success, solver.__name__
        r = b - A @ np.asarray(sol)
        assert np.linalg.norm(r) <= 1e-5 * (1 + np.linalg.norm(b))


def test_make_triangular_solve_deep_factor_uses_scan():
    """A deep dependency chain (tridiagonal: one level per row) routes to
    the O(1)-program StackedTriangularSweep and still matches scipy; a
    shallow factor keeps the unrolled engine."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    from krylov_tpu.ops.triangular import (
        LevelScheduledTriangularSolve,
        StackedTriangularSweep,
        make_triangular_solve,
    )

    rng = np.random.default_rng(5)
    n = 300
    L = scipy.sparse.diags(
        [2.0 + rng.random(n), 0.3 * rng.standard_normal(n - 1)],
        [0, -1],
    ).tocsr()
    solve = make_triangular_solve(L, lower=True)
    assert isinstance(solve, StackedTriangularSweep)
    b = rng.standard_normal((n, 2))
    want = spla.spsolve_triangular(L, b, lower=True)
    np.testing.assert_allclose(
        np.asarray(solve(jnp.asarray(b))), want, rtol=1e-12, atol=1e-13
    )

    shallow = scipy.sparse.diags([2.0 + rng.random(16)], [0]).tocsr()
    assert isinstance(
        make_triangular_solve(shallow, lower=True),
        LevelScheduledTriangularSolve,
    )


def test_gauss_seidel_deep_banded_sparse_matches_scipy():
    """GS on a sparse tridiagonal system (dependency depth == n, far past
    the unroll threshold) runs through the scan sweep and reproduces the
    scipy spsolve_triangular trajectory."""
    import scipy.sparse
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(6)
    n = 500
    off = 0.45 * rng.standard_normal(n - 1)
    A = scipy.sparse.diags(
        [off, 2.0 + rng.random(n), 0.45 * rng.standard_normal(n - 1)],
        [-1, 0, 1],
    ).tocsr()
    b = rng.standard_normal(n)

    sol, info = krylov_tpu.gauss_seidel(
        A, jnp.asarray(b), tol=1e-8, maxiter=60, backend="while_loop"
    )
    assert info.success

    L = scipy.sparse.tril(A).tocsr()
    x = np.zeros(n)
    r = b.copy()
    ref = [np.linalg.norm(r)]
    for _ in range(info.numsteps):
        x = x + spla.spsolve_triangular(L, r, lower=True)
        r = b - A @ x
        ref.append(np.linalg.norm(r))
    np.testing.assert_allclose(
        np.asarray(info.resnorms), np.asarray(ref), rtol=1e-9, atol=1e-12
    )
