"""Geometric multigrid V-cycle preconditioner (extension beyond the
reference, which never supplies its own preconditioners —
reference: src/krylov/cg.py:33-36 takes M from the user)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu as krylov
from krylov_tpu import MultigridPreconditioner
from krylov_tpu.ops import stencil

INNER = lambda u, v: jnp.sum(jnp.conj(u) * v)  # noqa: E731
RNG = np.random.default_rng(3)


def test_mg_cg_2d_iteration_collapse():
    """O(n) plain-CG iterations drop to O(10) with one V-cycle as M."""
    A = stencil.poisson_2d_const(128, 128, dtype=np.float64)
    b = jnp.asarray(RNG.standard_normal((128, 128)))
    _, info0 = krylov.cg(A, b, inner=INNER, tol=1e-8, maxiter=2000)
    M = MultigridPreconditioner(A)
    assert M.n_levels >= 5
    sol, info1 = krylov.cg(A, b, M=M, inner=INNER, tol=1e-8, maxiter=2000)
    assert info1.success
    assert info1.numsteps <= 25
    assert info1.numsteps * 10 <= info0.numsteps
    r = np.asarray(b) - np.asarray(A @ sol)
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))


def test_mg_mesh_independence_ladder():
    """The V(2,2) iteration count is mesh-INDEPENDENT: the order-2
    (bilinear) transfer pair satisfies m_P + m_R = 4 > 2m = 2, so the
    two-grid rate is bounded away from 1 uniformly in h.  (The former
    piecewise-constant transfer, order 1 + 1 = 2, failed this bound and
    grew 15 -> 20+ iterations over this same ladder, stalling at the
    4096^2 bench scale.)"""
    rng = np.random.default_rng(11)
    iters = {}
    for n in (128, 256, 512, 1024):
        A = stencil.poisson_2d_const(n, n, dtype=np.float64)
        M = MultigridPreconditioner(A)
        b = jnp.asarray(rng.standard_normal((n, n)))
        _, info = krylov.cg(A, b, M=M, inner=INNER, tol=1e-8, maxiter=40)
        assert info.success, f"n={n} did not converge"
        iters[n] = int(info.numsteps)
    assert max(iters.values()) <= 12, iters
    assert max(iters.values()) - min(iters.values()) <= 2, iters


def test_mg_galerkin_mesh_independence_ladder():
    """Same mesh-independence property on the variable-coefficient
    bilinear-Galerkin hierarchy."""
    rng = np.random.default_rng(12)
    iters = {}
    for n in (64, 128, 256):
        X, Y = np.meshgrid(
            np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij"
        )
        a = 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
        A = stencil.diffusion_2d(np.broadcast_to(a, (n, n)))
        M = MultigridPreconditioner(A)
        b = jnp.asarray(rng.standard_normal((n, n)))
        _, info = krylov.cg(A, b, M=M, inner=INNER, tol=1e-8, maxiter=40)
        assert info.success, f"n={n} did not converge"
        iters[n] = int(info.numsteps)
    assert max(iters.values()) <= 10, iters
    assert max(iters.values()) - min(iters.values()) <= 2, iters


def test_mg_cg_3d():
    A = stencil.poisson_3d_const(32, 32, 16, dtype=np.float64)
    b = jnp.asarray(RNG.standard_normal((32 * 32, 16)))
    M = MultigridPreconditioner(A)
    _, info0 = krylov.cg(A, b, inner=INNER, tol=1e-8, maxiter=3000)
    sol, info = krylov.cg(A, b, M=M, inner=INNER, tol=1e-8, maxiter=3000)
    assert info.success and info.numsteps <= 25
    assert info.numsteps * 4 <= info0.numsteps


def test_mg_compiled_backend_and_jit():
    """The static-level V-cycle inlines into the compiled while_loop and
    crosses the jit boundary as an (all-aux) pytree."""
    A = stencil.poisson_2d_const(64, 64, dtype=np.float64)
    M = MultigridPreconditioner(A)
    b = jnp.asarray(RNG.standard_normal((64, 64)))

    @jax.jit
    def run(M, b):
        _, info = krylov.cg(
            A, b, M=M, inner=INNER, tol=1e-8, maxiter=100,
            backend="while_loop",
        )
        return info.xk, jnp.asarray(info.numsteps)

    x, k = run(M, b)
    r = np.asarray(b) - np.asarray(A @ x)
    assert int(k) <= 25
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    # eager and compiled agree
    _, info_e = krylov.cg(
        A, b, M=M, inner=INNER, tol=1e-8, maxiter=100
    )
    assert info_e.numsteps == int(k)


def test_mg_vector_shapes_and_blocking():
    A = stencil.poisson_2d_const(64, 64, dtype=np.float64)
    M = MultigridPreconditioner(A)
    bg = jnp.asarray(RNG.standard_normal((64, 64)))
    # flat and grid-shaped agree
    zf = M @ bg.reshape(-1)
    zg = M @ bg
    np.testing.assert_allclose(
        np.asarray(zf), np.asarray(zg).reshape(-1), rtol=1e-13, atol=1e-14
    )
    # blocked RHS columns are independent
    bk = jnp.asarray(RNG.standard_normal((64, 64, 3)))
    zk = M @ bk
    z0 = M @ bk[:, :, 1]
    np.testing.assert_allclose(
        np.asarray(zk[:, :, 1]), np.asarray(z0), rtol=1e-13, atol=1e-14
    )


def test_mg_symmetric_enough_for_cg():
    """<u, M v> ~= <M u, v>: the equal-pre/post-smoothing cycle with
    P = R^T transfers keeps the cycle symmetric (up to rediscretization
    error), which is what CG needs from an SPD M."""
    A = stencil.poisson_2d_const(32, 32, dtype=np.float64)
    M = MultigridPreconditioner(A)
    u = jnp.asarray(RNG.standard_normal((32, 32)))
    v = jnp.asarray(RNG.standard_normal((32, 32)))
    a = float(INNER(u, M @ v))
    c = float(INNER(M @ u, v))
    assert abs(a - c) <= 1e-8 * max(abs(a), abs(c))
    # and positive
    assert float(INNER(u, M @ u)) > 0


def _var_diffusion(nx, ny, a):
    """SPD -div(a grad u) via the library constructor (Dirichlet walls:
    the center includes the boundary-face links, so the matrix is
    honestly positive definite, not a shifted Neumann operator)."""
    return stencil.diffusion_2d(np.broadcast_to(a, (nx, ny)))


def test_mg_galerkin_variable_coefficients():
    """Variable-coefficient 2-D stencils coarsen by the exact Galerkin
    triple product P^T A P (block-repeat transfer): a 5-point fine
    stencil becomes 9-point coarse stencils, the coarsest level is a
    precomputed dense inverse."""
    nx = ny = 128
    X, Y = np.meshgrid(
        np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij"
    )
    a = 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    A = _var_diffusion(nx, ny, a)
    b = jnp.asarray(RNG.standard_normal((nx, ny)))
    M = MultigridPreconditioner(A)
    assert M.n_levels >= 5
    _, i0 = krylov.cg(A, b, inner=INNER, tol=1e-8, maxiter=2000)
    sol, i1 = krylov.cg(A, b, M=M, inner=INNER, tol=1e-8, maxiter=2000)
    assert i1.success and i1.numsteps <= 45
    assert i1.numsteps * 10 <= i0.numsteps
    r = np.asarray(b) - np.asarray(A @ sol)
    # CG converges in the M-norm (reference semantics); the Euclidean
    # residual is looser when the coefficient field varies
    assert np.linalg.norm(r) <= 1e-4 * (1 + np.linalg.norm(np.asarray(b)))


def test_mg_galerkin_compiled_and_consistency():
    """Galerkin coarse matrices are exactly P^T A P; the compiled
    backend matches eager, and rough coefficient fields still converge
    (where plain CG stalls for thousands of iterations)."""
    nx = ny = 32
    a = np.exp(1.5 * RNG.standard_normal((nx, ny)))
    A = _var_diffusion(nx, ny, a)

    # exact Galerkin check at the first level against dense algebra
    # (P is the cell-centered bilinear prolongation, R = P^T)
    import scipy.sparse

    from krylov_tpu.multigrid import _bilinear_P_1d

    M = MultigridPreconditioner(A)
    Ad = np.asarray(A.todense())
    P = scipy.sparse.kron(
        _bilinear_P_1d(nx // 2), _bilinear_P_1d(ny // 2)
    ).toarray()
    Ac_ref = P.T @ Ad @ P
    Ac = np.asarray(M._ops[1].todense())
    np.testing.assert_allclose(Ac, Ac_ref, rtol=1e-12, atol=1e-12)

    # and the device-side transfer functions ARE that P / P^T
    from krylov_tpu.multigrid import _lin_prolong, _lin_restrict

    rng = np.random.default_rng(5)
    c = rng.standard_normal((nx // 2, ny // 2))
    f = rng.standard_normal((nx, ny))
    np.testing.assert_allclose(
        np.asarray(_lin_prolong(jnp.asarray(c), 2)).reshape(-1),
        P @ c.reshape(-1), rtol=1e-12, atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(_lin_restrict(jnp.asarray(f), 2, 1.0)).reshape(-1),
        P.T @ f.reshape(-1), rtol=1e-12, atol=1e-13,
    )

    b = jnp.asarray(RNG.standard_normal((nx, ny)))
    _, ie = krylov.cg(A, b, M=M, inner=INNER, tol=1e-9, maxiter=300)
    _, iw = krylov.cg(
        A, b, M=M, inner=INNER, tol=1e-9, maxiter=300,
        backend="while_loop",
    )
    assert ie.success and ie.numsteps == iw.numsteps


def test_mg_rejects_general_sparsity():
    """Non-nearest-neighbor / non-grid operators are out of scope for
    the geometric cycle (AMG covers them)."""
    import scipy.sparse

    sp = scipy.sparse.random(64, 64, density=0.1, format="csr")
    with pytest.raises(TypeError, match="ConstStencilOperator"):
        MultigridPreconditioner(krylov.as_operator(sp + sp.T))


def test_mg_odd_dims_stop_coarsening():
    A = stencil.poisson_2d_const(24, 18, dtype=np.float64)  # 24,18 -> 12,9 stop
    M = MultigridPreconditioner(A)
    assert M.n_levels == 2
    b = jnp.asarray(RNG.standard_normal((24, 18)))
    sol, info = krylov.cg(A, b, M=M, inner=INNER, tol=1e-9, maxiter=300)
    assert info.success


def _mg_case(kind):
    if kind == "const":
        A = stencil.poisson_2d_const(16, 8, dtype=np.float64)
    else:  # Galerkin hierarchy on a variable-coefficient operator
        a = 0.5 + np.random.default_rng(3).random((16, 8))
        A = stencil.diffusion_2d(a, dtype=np.float64)
    return A, MultigridPreconditioner(A)


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("kind", ["const", "galerkin"])
def test_mg_smoothing_matches_explicit_composition(kind, iters):
    """Level-0 smoothing is ``iters`` damped-Jacobi sweeps
    ``z <- z + w (r - A z)`` with the operator applied as the scipy matrix;
    the weight is omega/diag (a scalar on constant-coefficient levels, a
    per-point field on Galerkin levels)."""
    A, M = _mg_case(kind)
    sp = A.toscipy()
    rng = np.random.default_rng(5)
    shape = M._nd_shapes[0]
    z0 = rng.standard_normal(shape)
    r = rng.standard_normal(shape)
    w = (M.omega / sp.diagonal()).reshape(shape)

    z = z0.copy()
    for _ in range(iters):
        z = z + w * (r - (sp @ z.ravel()).reshape(shape))
    got = M._smooth(0, jnp.asarray(z0), jnp.asarray(r), iters)
    np.testing.assert_allclose(np.asarray(got), z, rtol=1e-12, atol=1e-12)
