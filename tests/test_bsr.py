"""BSR operator: ELL-padded block-sparse SpMM (gather + batched einsum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

import krylov_tpu
from krylov_tpu.ops.bsr import BSROperator


def _random_bsr(nbrows=6, nbcols=6, R=4, C=4, density=0.3, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    n, m = nbrows * R, nbcols * C
    dense = np.zeros((n, m))
    for i in range(nbrows):
        for j in range(nbcols):
            if rng.random() < density or (spd and i == j):
                dense[i * R : (i + 1) * R, j * C : (j + 1) * C] = (
                    rng.standard_normal((R, C))
                )
    if spd:
        dense = dense @ dense.T + n * np.eye(n)
    return dense


def test_bsr_spmm_matches_dense():
    dense = _random_bsr()
    A = BSROperator.from_scipy(
        scipy.sparse.csr_matrix(dense), blocksize=(4, 4)
    )
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((24, 3)))
    np.testing.assert_allclose(
        np.asarray(A @ X), dense @ np.asarray(X), atol=1e-12
    )
    x = jnp.asarray(rng.standard_normal(24))
    np.testing.assert_allclose(
        np.asarray(A @ x), dense @ np.asarray(x), atol=1e-12
    )


def test_bsr_rmatvec_matches_dense():
    dense = _random_bsr(seed=2)
    A = BSROperator.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(4, 4))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(24))
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(x)), dense.T @ np.asarray(x), atol=1e-12
    )
    X = jnp.asarray(rng.standard_normal((24, 2)))
    np.testing.assert_allclose(
        np.asarray(A.rmatvec(X)), dense.T @ np.asarray(X), atol=1e-12
    )


def test_bsr_diagonal_and_todense():
    dense = _random_bsr(seed=4)
    A = BSROperator.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(4, 4))
    np.testing.assert_allclose(np.asarray(A.todense()), dense, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(A.diagonal()), np.diag(dense), atol=1e-14
    )


def test_cg_on_bsr_multi_rhs():
    dense = _random_bsr(spd=True, seed=5)
    A = BSROperator.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(4, 4))
    rng = np.random.default_rng(6)
    B = jnp.asarray(rng.standard_normal((24, 3)))
    sol, info = krylov_tpu.cg(A, B, tol=1e-12, maxiter=200)
    assert info.success
    x_ref = np.linalg.solve(dense, np.asarray(B))
    np.testing.assert_allclose(np.asarray(sol), x_ref, atol=1e-8)


@pytest.mark.parametrize(
    "R,C,k", [(8, 8, 4), (16, 16, 1), (4, 8, 3), (32, 32, 16)]
)
def test_bsr_spmm_f32_block_shapes_match_dense(R, C, k):
    """The gather + batched-einsum SpMM in f32 over square, rectangular
    and single-column shapes, against the dense f64 product (full f32
    precision: no reduced-precision contraction)."""
    dense = _random_bsr(nbrows=4, nbcols=4, R=R, C=C, seed=7)
    A = BSROperator.from_scipy(
        scipy.sparse.csr_matrix(dense.astype(np.float32)), blocksize=(R, C)
    )
    rng = np.random.default_rng(8)
    X = rng.standard_normal((4 * C, k)).astype(np.float32)
    got = np.asarray(A @ jnp.asarray(X))
    assert got.dtype == np.float32
    want = dense.astype(np.float32).astype(np.float64) @ X
    np.testing.assert_allclose(got, want, atol=1e-5 * (1 + np.abs(want).max()))


def test_as_operator_routes_block_structured_to_bsr():
    """Block-structured scipy matrices auto-route to the BSR path."""
    import scipy.sparse

    from krylov_tpu._operators import as_operator
    from krylov_tpu.ops.bsr import BSROperator, detect_blocksize
    from krylov_tpu.ops.sparse import CSROperator

    rng = np.random.default_rng(3)
    n, R = 2048, 32
    nb = n // R
    dense = np.zeros((n, n), np.float64)
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            dense[i*R:(i+1)*R, j*R:(j+1)*R] = rng.standard_normal((R, R))
    sp = scipy.sparse.csr_matrix(dense)
    assert detect_blocksize(sp) == (32, 32)
    op = as_operator(sp)
    assert isinstance(op, BSROperator)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(op @ jnp.asarray(x)), dense @ x, rtol=1e-12, atol=1e-9
    )

    # scattered sparsity stays on the CSR path
    sp2 = scipy.sparse.random(2048, 2048, density=0.02, random_state=0,
                              format="csr")
    assert detect_blocksize(sp2) is None
    assert isinstance(as_operator(sp2), CSROperator)


def test_bsr_solver_via_as_operator():
    """A solver fed a block-structured scipy matrix uses BSR transparently."""
    import scipy.sparse

    import krylov_tpu

    rng = np.random.default_rng(4)
    n, R = 1024, 32
    nb = n // R
    dense = np.zeros((n, n))
    for i in range(nb):
        blk = rng.standard_normal((R, R))
        dense[i*R:(i+1)*R, i*R:(i+1)*R] = blk @ blk.T + (R + 2) * np.eye(R)
        if i + 1 < nb:
            c = 0.1 * rng.standard_normal((R, R))
            dense[i*R:(i+1)*R, (i+1)*R:(i+2)*R] = c
            dense[(i+1)*R:(i+2)*R, i*R:(i+1)*R] = c.T
    sp = scipy.sparse.csr_matrix(dense)
    b = rng.standard_normal(n)
    sol, info = krylov_tpu.cg(sp, jnp.asarray(b), tol=1e-10, maxiter=600)
    assert info.success
    r = b - dense @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(b))


def test_detect_blocksize_rejects_ell_padding_blowup():
    """An arrow matrix (one dense block row) can pass the per-block fill
    test while ELL padding to max_blocks would allocate near-dense memory;
    detect_blocksize must reject it (ADVICE r2: bound the ELL expansion)."""
    import scipy.sparse

    from krylov_tpu.ops.bsr import detect_blocksize

    rng = np.random.default_rng(7)
    n, R = 4096, 32
    nb = n // R
    blocks = []
    # dense first block row (arrow head) + diagonal
    for j in range(nb):
        blocks.append((0, j))
    for i in range(1, nb):
        blocks.append((i, i))
    rows, cols, vals = [], [], []
    for (bi, bj) in blocks:
        r0, c0 = bi * R, bj * R
        rr, cc = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
        rows.append((r0 + rr).ravel())
        cols.append((c0 + cc).ravel())
        vals.append(rng.standard_normal(R * R))
    sp = scipy.sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    # every stored block is fully dense -> fill = 1.0 passes min_fill,
    # but ELL padding would store nb * nb blocks ~ the dense matrix
    assert detect_blocksize(sp) is None


def test_route_cache_invalidates_on_inplace_mutation():
    """as_operator caches sparse conversions per scipy object, but an
    in-place mutation (A.data *= ...) must invalidate the cache (ADVICE r2:
    the id()-keyed cache previously served stale operators)."""
    import scipy.sparse

    from krylov_tpu._operators import as_operator

    rng = np.random.default_rng(11)
    sp = scipy.sparse.random(300, 300, density=0.05, random_state=5,
                             format="csr")
    x = rng.standard_normal(300)

    op1 = as_operator(sp)
    y1 = np.asarray(op1 @ jnp.asarray(x))
    # unmutated re-route hits the cache (no rebuild)
    assert as_operator(sp) is op1

    sp.data *= 2.0  # in-place value edit, same object / same structure
    op2 = as_operator(sp)
    assert op2 is not op1
    y2 = np.asarray(op2 @ jnp.asarray(x))
    np.testing.assert_allclose(y2, 2.0 * y1, rtol=1e-12)
    np.testing.assert_allclose(y2, sp @ x, rtol=1e-12)
