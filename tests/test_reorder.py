"""Symmetric RCM reordering helpers (``krylov_tpu.ops.reorder``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

import krylov_tpu
from krylov_tpu.ops.reorder import (
    invert_permutation, rcm_permutation, resolve_reorder,
)


def _scrambled_banded(n=2048, half_bw=8, seed=11):
    rng = np.random.default_rng(seed)
    offs = list(range(-half_bw, half_bw + 1))
    diags = [np.full(n - abs(o), -0.3) for o in offs]
    diags[half_bw] = np.full(n, 8.0)
    base = scipy.sparse.diags(diags, offs, format="csr")
    p = rng.permutation(n)
    return base[p][:, p].tocsr().astype(np.float32)


def _bandwidth(sp):
    coo = sp.tocoo()
    return int(np.abs(coo.row - coo.col).max())


def test_rcm_permutation_is_a_permutation_and_shrinks_bandwidth():
    sp = _scrambled_banded()
    perm = rcm_permutation(sp)
    assert perm.dtype == np.int64
    assert np.array_equal(np.sort(perm), np.arange(sp.shape[0]))
    bw0 = _bandwidth(sp)
    bw1 = _bandwidth(sp[perm][:, perm])
    assert bw1 * 10 < bw0, (bw0, bw1)


def test_rcm_symmetrizes_nonsymmetric_patterns():
    """A strictly lower-triangular pattern still gets a bandwidth-reducing
    ordering (the pattern is symmetrized first)."""
    sp = scipy.sparse.tril(_scrambled_banded(seed=3), k=-1).tocsr()
    perm = rcm_permutation(sp)
    assert np.array_equal(np.sort(perm), np.arange(sp.shape[0]))
    assert _bandwidth(sp[perm][:, perm]) * 10 < _bandwidth(sp)


def test_invert_permutation_roundtrip():
    perm = np.random.default_rng(0).permutation(97)
    inv = invert_permutation(perm)
    assert np.array_equal(inv[perm], np.arange(97))
    assert np.array_equal(perm[inv], np.arange(97))


def test_resolve_reorder_auto_and_explicit_perm():
    """"auto" reorders scrambled matrices and leaves well-ordered ones
    alone; an explicit index array is honored; None keeps order."""
    sp_bad = _scrambled_banded(seed=12)
    perm = resolve_reorder(sp_bad, "auto")
    assert perm is not None
    assert _bandwidth(sp_bad[perm][:, perm]) * 2 <= _bandwidth(sp_bad)

    sp_good = scipy.sparse.diags(
        [-1.0, 2.5, -1.0], [-1, 0, 1], shape=(300, 300), format="csr"
    )
    assert resolve_reorder(sp_good, "auto") is None
    assert resolve_reorder(sp_good, None) is None
    assert resolve_reorder(scipy.sparse.csr_matrix((50, 50)), "auto") is None

    explicit = np.arange(300)[::-1]
    got = resolve_reorder(sp_good, explicit)
    assert np.array_equal(got, explicit) and got.dtype == np.int64
    assert np.array_equal(resolve_reorder(sp_bad, "rcm"),
                          rcm_permutation(sp_bad))
    with pytest.raises(ValueError, match="unknown reorder"):
        resolve_reorder(sp_good, "metis")


@pytest.mark.parametrize("spec", ["rcm", "auto", np.arange(391)])
def test_reorder_rejects_rectangular_up_front(spec):
    """A symmetric permutation needs a square matrix: the targeted message
    comes before any permutation is computed (scipy's 'inconsistent
    shapes' must not leak out of rcm_permutation)."""
    sp = scipy.sparse.random(257, 391, density=0.05, random_state=1,
                             format="csr")
    with pytest.raises(ValueError, match="square matrix"):
        resolve_reorder(sp, spec)


def test_reordered_solve_matches_user_order():
    """Solving B = A[perm][:, perm] and mapping back with the inverse
    permutation gives the user-order solution of A."""
    sp = _scrambled_banded(n=1024, seed=5).astype(np.float64)
    perm = rcm_permutation(sp)
    inv = invert_permutation(perm)
    b = np.random.default_rng(1).standard_normal(sp.shape[0])
    _, info = krylov_tpu.cg(sp[perm][:, perm].tocsr(), jnp.asarray(b[perm]),
                            tol=1e-12, maxiter=500)
    assert info.success
    x = np.asarray(info.xk)[inv]
    assert np.linalg.norm(b - sp @ x) <= 1e-10 * np.linalg.norm(b)
