"""GridStencilOperator: 2-D/3-D grid stencils vs dense/CSR ground truth.

These tests cover the XLA grid formulation (the one matvec path on every
backend) against scipy, including the shard-halo entry points the
distributed operators use, the grid-offset decomposition, and solver
integration.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu
from krylov_tpu.ops import stencil


@pytest.mark.parametrize(
    "make,n",
    [
        (lambda: stencil.poisson_2d(8, 16), 128),
        (lambda: stencil.poisson_2d(16, 8), 128),
        (lambda: stencil.poisson_3d(4, 5, 8), 160),
    ],
)
def test_grid_matvec_matches_csr(make, n):
    A = make()
    assert isinstance(A, stencil.GridStencilOperator)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n))
    want = A.tocsr() @ x
    got = A @ x
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_grid_offset_decomposition():
    A = stencil.poisson_2d(4, 8)
    assert A.offsets == (-8, -1, 0, 1, 8)
    assert A.row_offsets == (-1, 0, 0, 0, 1)
    assert A.col_offsets == (0, -1, 0, 1, 0)

    B = stencil.poisson_3d(3, 4, 8)
    # strides: ny*nz = 32, nz = 8, 1
    assert B.ny == 8
    assert set(zip(B.row_offsets, B.col_offsets)) == {
        (-4, 0), (-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (4, 0),
    }


def test_grid_rmatvec_hermitian():
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(64))
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(x)), np.asarray(A @ x), atol=1e-13
    )


def test_cg_on_grid_operator():
    A = stencil.poisson_2d(8, 16)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(128))
    sol, info = krylov_tpu.cg(A, b, tol=1e-12, maxiter=400)
    assert info.success
    r = np.asarray(b) - np.asarray(A @ sol)
    assert np.linalg.norm(r) <= 1e-11 * (1 + np.linalg.norm(np.asarray(b)))


def test_grid_multi_rhs_falls_back():
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((64, 3)))
    want = np.stack([np.asarray(A @ X[:, k]) for k in range(3)], axis=1)
    got = np.asarray(A @ X)
    np.testing.assert_allclose(got, want, atol=1e-13)


def _random_grid_operator(shape, dtype, seed=0):
    """Laplacian band pattern with random positive coefficients (zeros kept
    wherever a neighbor leaves the grid, as the operator contract says)."""
    coeffs, offsets = stencil._laplacian_coeffs(shape, np.dtype(np.float64))
    rng = np.random.default_rng(seed)
    coeffs = coeffs * (0.5 + rng.random(coeffs.shape))
    return stencil.GridStencilOperator(
        jnp.asarray(coeffs, dtype), offsets, shape[-1]
    )


def _const_operator(shape, dtype):
    offs, _ = stencil._laplace_offsets(len(shape))
    # distinct weights per band, so a wrong band/shift cannot cancel out
    ws = tuple(4.0 + 0.5 * k if k == 0 else -0.3 - 0.1 * k
               for k in range(len(offs)))
    return stencil.ConstStencilOperator(shape, offs, ws, dtype=dtype)


_MAKERS = {"grid": _random_grid_operator, "const": _const_operator}

# (grid shape, dtype, tolerance relative to max|y|): row-halo widths 1
# (2-D) and ny-stride (3-D, row offsets +-4 / +-3), last dims that are not
# multiples of 8 or 128, and bf16 storage (8 mantissa bits)
_STENCIL_CASES = [
    ((16, 8), np.float32, 1e-6),
    ((9, 7), np.float32, 1e-6),
    ((5, 13), np.float64, 1e-14),
    ((3, 4, 8), np.float32, 1e-6),
    ((2, 3, 5), np.float64, 1e-14),
    ((16, 8), jnp.bfloat16, 3e-2),
]


@pytest.mark.parametrize("kind", sorted(_MAKERS))
@pytest.mark.parametrize("shape,dtype,tol", _STENCIL_CASES)
def test_xla_stencil_matches_scipy(kind, shape, dtype, tol):
    A = _MAKERS[kind](shape, dtype)
    M, ny = A.grid
    rng = np.random.default_rng(7)
    x2 = jnp.asarray(rng.standard_normal((M, ny)), dtype)
    got = np.asarray(A @ x2, np.float64)
    ref = A
    if kind == "grid":  # scipy has no bf16: widen the stored coefficients
        ref = stencil.GridStencilOperator(
            A.coeffs2d.astype(jnp.float64), A.offsets, ny
        )
    want = ref.toscipy() @ np.asarray(x2, np.float64).ravel()
    np.testing.assert_allclose(
        got.ravel(), want, atol=tol * (1 + np.abs(want).max())
    )


def _halo_width(row_offsets):
    return max(max(0, -min(row_offsets)), max(0, max(row_offsets)), 1)


@pytest.mark.parametrize("kind", sorted(_MAKERS))
@pytest.mark.parametrize(
    "shape,rows",
    [((12, 8), (4, 8)), ((12, 8), (0, 6)), ((3, 4, 8), (4, 8))],
)
def test_xla_stencil_shard_halos_match_global(kind, shape, rows):
    """The row-slab entry point the sharded operators call: a slab plus
    its neighbors' boundary rows as halos reproduces the global matvec's
    rows (zero halos at the grid edge)."""
    A = _MAKERS[kind](shape, np.float64)
    M, ny = A.grid
    r0, r1 = rows
    rng = np.random.default_rng(11)
    x2 = jnp.asarray(rng.standard_normal((M, ny)))
    if kind == "grid":
        row_offsets = A.row_offsets
    else:
        row_offsets = tuple(b[0] for b in A.bands)
    h = _halo_width(row_offsets)
    xp = jnp.pad(x2, ((h, h), (0, 0)))
    top, bot = xp[r0:r0 + h], xp[r1 + h:r1 + 2 * h]
    if kind == "grid":
        local = stencil.GridStencilOperator(
            A.coeffs2d[:, r0:r1], A.offsets, ny
        )
        got = local._apply_grid(x2[r0:r1], top_halo=top, bot_halo=bot)
    else:
        got = A._apply_grid(x2[r0:r1], row0=r0, top_halo=top, bot_halo=bot)
    want = np.asarray(A @ x2)[r0:r1]
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


# ---------------------------------------------------------------------------
# ConstStencilOperator (constant-coefficient, in-kernel boundary masks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "make_const,make_var,n",
    [
        (
            lambda: stencil.poisson_2d_const(8, 16, dtype=np.float64),
            lambda: stencil.poisson_2d(8, 16),
            128,
        ),
        (
            lambda: stencil.poisson_3d_const(4, 5, 8, dtype=np.float64),
            lambda: stencil.poisson_3d(4, 5, 8),
            160,
        ),
    ],
)
def test_const_stencil_matches_variable(make_const, make_var, n):
    A, Av = make_const(), make_var()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(A @ x), np.asarray(Av @ x), atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(A @ x), np.asarray(A.tocsr() @ x), atol=1e-13
    )


def test_const_stencil_structural_nnz():
    A = stencil.poisson_2d_const(8, 16)
    # N + 2*(8*15) + 2*(7*16) interior couplings
    assert A.nnz == 128 + 2 * 8 * 15 + 2 * 7 * 16


def test_const_stencil_grid_vectors_and_rmatvec():
    A = stencil.poisson_2d_const(8, 16, dtype=np.float64)
    rng = np.random.default_rng(1)
    xg = jnp.asarray(rng.standard_normal((8, 16)))
    flat = (A @ xg.reshape(-1)).reshape(8, 16)
    np.testing.assert_allclose(np.asarray(A @ xg), np.asarray(flat), atol=1e-14)
    assert A.hermitian
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(xg)), np.asarray(A @ xg), atol=1e-14
    )


def test_const_stencil_nonsymmetric_rmatvec():
    # convection-like: asymmetric weights
    A = stencil.ConstStencilOperator(
        (6, 8),
        ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)),
        (4.0, -1.5, -0.5, -2.0, -0.25),
        dtype=np.float64,
    )
    assert not A.hermitian
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(48))
    dense = np.asarray(A.tocsr().todense())
    np.testing.assert_allclose(np.asarray(A @ x), dense @ np.asarray(x), atol=1e-13)
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(x)), dense.T @ np.asarray(x), atol=1e-13
    )


def test_cg_on_const_stencil():
    A = stencil.poisson_2d_const(8, 16, dtype=np.float64)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(128))
    sol, info = krylov_tpu.cg(A, b, tol=1e-12, maxiter=400)
    assert info.success
    r = np.asarray(b) - np.asarray(A @ sol)
    assert np.linalg.norm(r) <= 1e-10 * (1 + np.linalg.norm(np.asarray(b)))


def test_const_stencil_multi_rhs():
    A = stencil.poisson_2d_const(8, 8, dtype=np.float64)
    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.standard_normal((64, 3)))
    want = np.stack([np.asarray(A @ X[:, k]) for k in range(3)], axis=1)
    np.testing.assert_allclose(np.asarray(A @ X), want, atol=1e-13)


def test_cg_stencil_matches_generic_cg():
    A = stencil.poisson_2d_const(8, 16, dtype=np.float64)
    rng = np.random.default_rng(20)
    b = jnp.asarray(rng.standard_normal(128))
    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-12, maxiter=400)
    sol, info = krylov_tpu.cg_stencil(A, b, tol=1e-12, maxiter=400)
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-10)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-9, atol=1e-13
    )


def test_cg_stencil_grid_rhs_and_unconverged():
    A = stencil.poisson_2d_const(8, 16, dtype=np.float64)
    rng = np.random.default_rng(21)
    b2 = jnp.asarray(rng.standard_normal((8, 16)))
    sol, info = krylov_tpu.cg_stencil(A, b2, tol=1e-12, maxiter=400)
    assert info.success and sol.shape == (8, 16)
    soln, infon = krylov_tpu.cg_stencil(A, b2, tol=1e-30, atol=0.0, maxiter=3)
    assert soln is None and not infon.success


def test_cg_stencil_jacobi_matches_generic_preconditioned_cg():
    """cg_stencil(M='jacobi') reproduces krylov_tpu.cg with a diagonal M
    (same resnorm convention sqrt(<r, M r>), same trajectory)."""
    from krylov_tpu._operators import DiagonalOperator

    rng = np.random.default_rng(26)
    a = jnp.asarray(0.5 + rng.random((8, 16)))
    A = stencil.diffusion_2d(a, dtype=np.float64)
    b = jnp.asarray(rng.standard_normal(128))
    dinv = 1.0 / jnp.asarray(A.diagonal())
    sol_ref, info_ref = krylov_tpu.cg(
        A, b, M=DiagonalOperator(dinv), tol=1e-12, maxiter=400
    )
    sol, info = krylov_tpu.cg_stencil(A, b, M="jacobi", tol=1e-12, maxiter=400)
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-10)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-9, atol=1e-13
    )
    # rejected combinations
    Ac = stencil.poisson_2d_const(8, 16, dtype=np.float64)
    with pytest.raises(ValueError):
        krylov_tpu.cg_stencil(Ac, b, M="jacobi")
    with pytest.raises(ValueError):
        krylov_tpu.cg_stencil(A, b, M="ilu")


def test_cg_stencil_grid_variable_coefficient_matches_generic_cg():
    """cg_stencil accepts GridStencilOperator and reproduces the generic
    CG trajectory on it."""
    rng = np.random.default_rng(24)
    a = 0.5 + rng.random((8, 16))
    A = stencil.diffusion_2d(a, dtype=np.float64)
    b = jnp.asarray(rng.standard_normal(128))
    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-12, maxiter=400)
    sol, info = krylov_tpu.cg_stencil(A, b, tol=1e-12, maxiter=400)
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-10)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-9, atol=1e-13
    )
