"""Device CSR operator and the scipy routing of ``as_operator``.

The reference consumes scipy CSR implicitly (reference:
tests/test_solvers.py:199-209); here every scipy matrix that is not block
structured becomes a :class:`~krylov_tpu.ops.CSROperator` (gather +
``segment_sum``).  Ground truth is scipy's own matvec.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

import krylov_tpu
from krylov_tpu import _operators
from krylov_tpu.ops.bsr import BSROperator
from krylov_tpu.ops.sparse import CSROperator

RNG = np.random.default_rng(42)


def _irregular(n, span, dmax, seed=0):
    rng = np.random.default_rng(seed)
    row_nnz = rng.integers(0, dmax, n)  # includes empty rows
    nnz = int(row_nnz.sum())
    indptr = np.r_[0, np.cumsum(row_nnz)]
    r = np.repeat(np.arange(n), row_nnz)
    c = np.clip(r + rng.integers(-span, span, nnz), 0, n - 1).astype(np.int32)
    d = rng.standard_normal(nnz)
    return scipy.sparse.csr_matrix((d, c, indptr), shape=(n, n))


CASES = {
    "tridiag": scipy.sparse.diags(
        [-1.0, 2.5, -1.0], [-1, 0, 1], shape=(300, 300), format="csr"
    ),
    "rect": scipy.sparse.random(257, 391, density=0.05, random_state=1,
                                format="csr"),
    "irregular": _irregular(1000, 200, 30),
    "wide-span": scipy.sparse.random(500, 70000, density=0.001,
                                     random_state=2, format="csr"),
    "two-band": scipy.sparse.diags(
        [1.0, 2.0, 3.0], [-40000, 0, 40000], shape=(50000, 50000),
        format="csr"
    ),
    "empty": scipy.sparse.csr_matrix((130, 130)),
}

# f32: the gather + segment-sum accumulates in f32 (about sqrt(nnz/row)
# rounding steps of eps); f64 is exact up to summation order
TOL = {np.float32: 2e-6, np.float64: 1e-13}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(CASES))
def test_csr_matvec_matches_scipy(name, dtype):
    sp = CASES[name].astype(dtype)
    A = CSROperator.from_scipy(sp)
    x = RNG.standard_normal(sp.shape[1]).astype(dtype)
    got = np.asarray(A @ jnp.asarray(x))
    assert got.dtype == dtype
    want = sp.astype(np.float64) @ x.astype(np.float64)
    scale = 1 + (np.abs(want).max() if want.size else 0)
    np.testing.assert_allclose(got, want, atol=TOL[dtype] * 30 * scale)


@pytest.mark.parametrize("name", ["tridiag", "rect", "irregular"])
def test_csr_rmatvec_matches_scipy(name):
    sp = CASES[name].astype(np.float32)
    A = CSROperator.from_scipy(sp)
    x = RNG.standard_normal(sp.shape[0]).astype(np.float32)
    got = np.asarray(A.rmatvec(jnp.asarray(x)))
    want = sp.T.conj() @ x
    scale = 1 + np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)


def test_csr_multi_rhs():
    sp = CASES["irregular"].astype(np.float32)
    A = CSROperator.from_scipy(sp)
    X = RNG.standard_normal((sp.shape[1], 3)).astype(np.float32)
    got = np.asarray(A @ jnp.asarray(X))
    want = sp @ X
    np.testing.assert_allclose(got, want, atol=2e-5 * (1 + np.abs(want).max()))


def test_csr_reports_nnz_and_diagonal():
    sp = CASES["tridiag"].astype(np.float32)
    A = CSROperator.from_scipy(sp)
    assert A.nnz == sp.nnz
    assert A.shape == sp.shape
    np.testing.assert_allclose(np.asarray(A.diagonal()), sp.diagonal())


def test_csr_operator_in_cg_solver():
    """CSROperator plugs into the solver layer as a first-class operator."""
    n = 400
    sp = scipy.sparse.diags(
        [-1.0, 2.8, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    ).astype(np.float32)
    A = CSROperator.from_scipy(sp)
    b = jnp.asarray(RNG.standard_normal(n), jnp.float32)
    sol, info = krylov_tpu.cg(A, b, tol=1e-5, maxiter=400)
    assert info.success
    r = np.asarray(b) - sp @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-4 * (1 + np.linalg.norm(np.asarray(b)))


def test_csr_pytree_roundtrip():
    sp = CASES["tridiag"].astype(np.float32)
    A = CSROperator.from_scipy(sp)
    leaves, treedef = jax.tree_util.tree_flatten(A)
    A2 = jax.tree_util.tree_unflatten(treedef, leaves)
    x = RNG.standard_normal(sp.shape[1]).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(A2 @ jnp.asarray(x)), np.asarray(A @ jnp.asarray(x))
    )


def test_csr_operator_usable_under_jit():
    """The operator's pytree aux must be hashable, so jit/vmap can take
    the operator as an argument."""
    sp = CASES["irregular"].astype(np.float32)
    A = CSROperator.from_scipy(sp)

    @jax.jit
    def mv(op, v):
        return op @ v

    x = jnp.asarray(RNG.standard_normal(sp.shape[1]).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(mv(A, x)), np.asarray(A @ x), rtol=1e-6
    )


def _block_structured(n=2048, R=32, seed=3):
    rng = np.random.default_rng(seed)
    nb = n // R
    dense = np.zeros((n, n), np.float32)
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            dense[i*R:(i+1)*R, j*R:(j+1)*R] = rng.standard_normal((R, R))
    return scipy.sparse.csr_matrix(dense)


@pytest.mark.parametrize(
    "make,want_type",
    [
        (lambda: scipy.sparse.random(2048, 2048, density=0.02,
                                     random_state=0, format="csr"),
         CSROperator),
        (lambda: (scipy.sparse.random(512, 512, density=0.05, random_state=3)
                  * (1 + 1j)).tocsr(), CSROperator),
        (_block_structured, BSROperator),
    ],
    ids=["scattered", "complex", "block"],
)
def test_scipy_routing_picks_format(make, want_type):
    """as_operator routes scattered (real or complex) matrices to CSR and
    block-structured ones to BSR, on every backend and dtype."""
    sp = make()
    op = _operators.as_operator(sp)
    assert type(op) is want_type
    x = RNG.standard_normal(sp.shape[1])
    want = sp @ x
    np.testing.assert_allclose(
        np.asarray(op @ jnp.asarray(x)), want,
        atol=1e-5 * (1 + np.abs(want).max()),
    )


def test_route_cache_mutation_and_eviction():
    """The as_operator route cache must (a) invalidate on ANY in-place
    value edit — the fingerprint hashes the full buffers, sampling missed
    single-element edits — and (b) self-evict when the scipy matrix is
    garbage collected, so per-time-step matrices don't leak device
    buffers."""
    sp = scipy.sparse.random(
        256, 256, density=0.05, random_state=5, format="csr"
    ).astype(np.float32)

    calls = []

    def build(A):
        calls.append(1)
        return ("op", A.nnz)

    op1 = _operators._route_cached(sp, build)
    op2 = _operators._route_cached(sp, build)
    assert op1 is op2 and len(calls) == 1  # cache hit

    sp.data[1] *= 100.0  # single-element in-place edit
    op3 = _operators._route_cached(sp, build)
    assert len(calls) == 2, "mutated matrix must rebuild"
    assert op3 is not op1

    key = id(sp)
    assert key in _operators._ROUTE_CACHE
    del sp, op1, op2, op3
    gc.collect()
    assert key not in _operators._ROUTE_CACHE, "dead entry must evict"


@pytest.mark.parametrize(
    "make",
    [
        lambda: scipy.sparse.random(300, 300, density=0.05, random_state=9,
                                    format="csr").astype(np.float32),
        _block_structured,
    ],
    ids=["csr", "bsr"],
)
def test_route_cache_serves_and_evicts_routed_operator(make):
    """A routed operator (CSR or BSR) is served from the cache on the
    next solve of the same matrix, does not keep the matrix alive, and
    its entry evicts with the matrix; the operator itself keeps working."""
    sp = make()
    op = _operators.as_operator(sp)
    assert _operators.as_operator(sp) is op  # second solve: cache hit
    x = RNG.standard_normal(sp.shape[1])
    want = sp @ x
    key = id(sp)
    assert key in _operators._ROUTE_CACHE
    del sp
    gc.collect()
    assert key not in _operators._ROUTE_CACHE, (
        "routed operator kept the matrix alive through the cache"
    )
    np.testing.assert_allclose(
        np.asarray(op @ jnp.asarray(x)), want,
        atol=1e-5 * (1 + np.abs(want).max()),
    )
