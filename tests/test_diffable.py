"""Differentiable solves: implicit-function-theorem gradients checked
against finite differences and analytic results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu
from krylov_tpu import diffable
from krylov_tpu.ops import stencil


def test_grad_wrt_rhs_matches_adjoint_solve():
    rng = np.random.default_rng(0)
    n = 24
    Q = rng.standard_normal((n, n))
    Ad = Q @ Q.T + n * np.eye(n)
    b = jnp.asarray(rng.standard_normal(n))
    g_out = jnp.asarray(rng.standard_normal(n))

    def loss(b):
        from krylov_tpu._operators import MatrixOperator

        x = diffable.solve(MatrixOperator(jnp.asarray(Ad)), b,
                           tol=1e-12, maxiter=200)
        return jnp.dot(g_out, x)

    g = jax.grad(loss)(b)
    # dL/db = A^{-H} g_out (A symmetric here)
    want = np.linalg.solve(Ad.T, np.asarray(g_out))
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-7, atol=1e-9)


def test_grad_wrt_stencil_coefficients_fd():
    A0 = stencil.poisson_2d(4, 8)
    offsets, ny = A0.offsets, A0.ny
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(32))
    c0 = A0.coeffs2d

    def loss(c2):
        x = diffable.solve(
            stencil.GridStencilOperator(c2, offsets, ny, hermitian=True),
            b,
            params=(c2,),
            make_op=lambda c: stencil.GridStencilOperator(
                c, offsets, ny, hermitian=True
            ),
            tol=1e-13,
            maxiter=400,
        )
        return jnp.sum(x**3)

    g = jax.grad(loss)(c0)

    # finite differences on a few coefficient entries
    eps = 1e-6
    for d, i, j in [(2, 1, 3), (0, 2, 5), (4, 0, 0)]:
        cp = c0.at[d, i, j].add(eps)
        cm = c0.at[d, i, j].add(-eps)
        fd = (loss(cp) - loss(cm)) / (2 * eps)
        np.testing.assert_allclose(
            float(g[d, i, j]), float(fd), rtol=2e-4, atol=1e-7
        )


def test_grad_nonsymmetric_uses_adjoint():
    rng = np.random.default_rng(2)
    n = 16
    Ad = np.diag(np.linspace(2.0, 10.0, n)) + 0.3 * rng.standard_normal((n, n))
    b = jnp.asarray(rng.standard_normal(n))

    from krylov_tpu._operators import MatrixOperator

    def loss(b):
        x = diffable.solve(
            MatrixOperator(jnp.asarray(Ad)), b,
            solver=krylov_tpu.gmres, tol=1e-12, maxiter=64,
        )
        return jnp.sum(jnp.sin(x))

    g = jax.grad(loss)(b)
    # FD check
    eps = 1e-6
    for i in [0, 7, 15]:
        bp = b.at[i].add(eps)
        bm = b.at[i].add(-eps)
        fd = (loss(bp) - loss(bm)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=5e-5, atol=1e-8)


def test_diffable_inside_jit():
    A0 = stencil.poisson_2d(4, 8)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(32))

    @jax.jit
    def loss_and_grad(b):
        def loss(b):
            x = diffable.solve(A0, b, tol=1e-12, maxiter=200)
            return jnp.sum(x**2)

        return jax.value_and_grad(loss)(b)

    v, g = loss_and_grad(b)
    assert np.isfinite(float(v)) and np.all(np.isfinite(np.asarray(g)))


def test_grad_through_nonsymmetric_csr_operator():
    """diffable.solve on a NON-symmetric CSR operator: the backward pass
    solves with the adjoint through ``rmatvec`` on the operator rebuilt
    from its pytree leaves (integer index leaves get float0 cotangents)."""
    import scipy.sparse

    from krylov_tpu.ops.sparse import CSROperator

    n = 96
    sp = scipy.sparse.diags(
        [-1.0, 3.0, -0.5], [-1, 0, 1], shape=(n, n), format="csr"
    ).astype(np.float32)  # NON-symmetric: the adjoint really differs
    A = CSROperator.from_scipy(sp)
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n), jnp.float32)
    g_out = jnp.asarray(
        np.random.default_rng(6).standard_normal(n), jnp.float32
    )

    def loss(b):
        x = diffable.solve(
            A, b, solver=krylov_tpu.gmres, tol=1e-6, maxiter=n,
            adjoint_solver=krylov_tpu.gmres,
        )
        return jnp.dot(g_out, x)

    g = jax.grad(loss)(b)
    # dL/db = A^{-H} g_out
    want = np.linalg.solve(sp.toarray().T, np.asarray(g_out))
    np.testing.assert_allclose(np.asarray(g), want, atol=2e-3)
