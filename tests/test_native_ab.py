"""Native-vs-numpy A/B parity for the C++ setup helpers.

Every native helper in ``krylov_tpu/csrc`` ships with its numpy
implementation as fallback AND ground truth (ops/_native.py docstring);
these tests pin that contract by running both paths on the same inputs:

* ILU(0) numeric phase (csrc/ilu0.cpp) — f64 closeness + the complex
  bypass (round-3 verdict item 7);
* AMG pairwise aggregation (csrc/amg_agg.cpp) — exact label equality.
"""

import os

import numpy as np
import pytest
import scipy.sparse

import krylov_tpu.ops._native as _native
from krylov_tpu import amg as amgmod
from krylov_tpu import ilu as ilumod


def _reset_native_state():
    _native._ilu_tried = False
    _native._ilu_lib = None
    _native._agg_tried = False
    _native._agg_lib = None
    _native._rap_tried = False
    _native._rap_lib = None


@pytest.fixture
def numpy_only(monkeypatch):
    """Force the numpy fallbacks, restoring native state afterwards."""
    monkeypatch.setenv("KRYLOV_TPU_NO_NATIVE", "1")
    _reset_native_state()
    yield
    monkeypatch.delenv("KRYLOV_TPU_NO_NATIVE", raising=False)
    _reset_native_state()


def _test_matrices():
    rng = np.random.default_rng(7)
    n_side = 40
    n = n_side * n_side
    lap = scipy.sparse.diags(
        [-1.0, -1.0, 4.0, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
        shape=(n, n), format="csr",
    )
    R = scipy.sparse.random(500, 500, density=0.02, format="csr",
                            random_state=rng)
    unsym = (R + 8.0 * scipy.sparse.eye(500, format="csr")).tocsr()
    unsym.sort_indices()
    return {"poisson": lap, "unsym": unsym}


def test_ilu0_native_matches_numpy():
    """csrc/ilu0.cpp numeric phase vs the numpy IKJ pass: same factored
    data at f64 tightness on the same canonical CSR (round-3 verdict 7)."""
    for name, A in _test_matrices().items():
        A = A.tocsr().astype(np.float64)
        A.sort_indices()
        native = _native.ilu0_factor_native(A)
        if native is None:
            pytest.skip("native ilu0 unavailable on this host")
        ref = ilumod._ilu0_numeric_numpy(A)
        np.testing.assert_allclose(
            native, ref, rtol=1e-14, atol=1e-14,
            err_msg=f"ilu0 native/numpy mismatch on {name}",
        )


def test_ilu0_complex_takes_numpy_route():
    """The C kernel is real-f64; complex matrices must return None from
    the native wrapper (silent bypass) and still factor correctly."""
    rng = np.random.default_rng(3)
    n = 64
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = scipy.sparse.csr_matrix(
        np.eye(n) * (8.0 + 0j) + 0.25 * C
    )
    H.sort_indices()
    assert _native.ilu0_factor_native(H) is None
    L, U = ilumod._ilu0_factor(H)[:2]
    # defining property: (L U) matches A on A's own sparsity pattern
    prod = (L @ U).tocsr()
    mask = H.copy()
    mask.data = np.ones_like(mask.data)
    diff = (prod.multiply(mask) - H)
    assert abs(diff).max() <= 1e-10


def test_ilu0_factor_same_through_public_path(numpy_only):
    """_ilu0_factor with natives disabled reproduces the native-route
    factors (public dispatcher level, not just the kernel)."""
    A = _test_matrices()["poisson"].astype(np.float64)
    Ln, Un = ilumod._ilu0_factor(A)[:2]
    # numpy_only fixture has natives off for THIS call
    Lp, Up = ilumod._ilu0_factor(A)[:2]
    assert abs(Ln - Lp).max() <= 1e-14
    assert abs(Un - Up).max() <= 1e-14


def test_amg_aggregation_native_matches_numpy(numpy_only, monkeypatch):
    """csrc/amg_agg.cpp produces EXACTLY the numpy labels (same strength
    values, jitter, stable sort — the sort key is reproduced with the
    identical IEEE op sequence)."""
    mats = _test_matrices()
    # numpy labels first (natives disabled by the fixture)
    ref = {
        name: amgmod._pairwise_labels(A.tocsr().astype(np.float64), 0.08)
        for name, A in mats.items()
    }
    ref32 = {
        name: amgmod._pairwise_labels(A.tocsr().astype(np.float32), 0.08)
        for name, A in mats.items()
    }
    # re-enable natives
    monkeypatch.delenv("KRYLOV_TPU_NO_NATIVE", raising=False)
    _reset_native_state()
    for name, A in mats.items():
        A64 = A.tocsr().astype(np.float64)
        A64.sort_indices()
        got = _native.amg_pairwise_labels_native(A64, 0.08)
        if got is None:
            pytest.skip("native amg_agg unavailable on this host")
        labels, n_agg = got
        assert n_agg == ref[name][1], name
        np.testing.assert_array_equal(labels, ref[name][0], err_msg=name)
        A32 = A.tocsr().astype(np.float32)
        A32.sort_indices()
        labels32, n32 = _native.amg_pairwise_labels_native(A32, 0.08)
        assert n32 == ref32[name][1], name
        np.testing.assert_array_equal(
            labels32, ref32[name][0], err_msg=f"{name} (f32)"
        )


def test_amg_full_setup_native_off_equivalent(numpy_only):
    """AMGPreconditioner built with natives disabled has the same level
    structure (the hierarchies are label-identical by the test above;
    here we pin the end-to-end dispatcher)."""
    A = _test_matrices()["poisson"].astype(np.float64)
    M = amgmod.AMGPreconditioner.from_scipy(A)
    assert M.n_levels >= 2
    sizes_off = M.level_sizes
    os.environ.pop("KRYLOV_TPU_NO_NATIVE", None)
    _reset_native_state()
    M2 = amgmod.AMGPreconditioner.from_scipy(A)
    assert M2.level_sizes == sizes_off


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_rap_native_matches_scipy(dtype):
    """csrc/amg_rap.cpp (marker-accumulator Galerkin P^H A P) vs the
    scipy triple product: identical sparsity pattern, values at the
    dtype's precision (double accumulation vs scipy's same-dtype
    csr_matmat order), for both the smoothed-SA and the tentative
    (relabel-sum) prolongator."""
    for name, A in _test_matrices().items():
        Al = A.astype(dtype).tocsr()
        Al.sort_indices()
        labels, n_agg = amgmod._aggregate(Al, 0.08)
        lmax = amgmod._lmax_estimate(Al, "power")
        d = Al.diagonal()
        d = np.where(d != 0, d, 1.0)
        scale = (4.0 / (3.0 * lmax)) / d
        got = _native.amg_rap_native(Al, labels, n_agg, scale)
        if got is None:
            pytest.skip("native amg_rap unavailable on this host")
        # scipy ground truth (the need_P=True route of
        # amg._smoothed_prolongator)
        P = scipy.sparse.csr_matrix(
            (np.ones(Al.shape[0], dtype),
             (np.arange(Al.shape[0]), labels)),
            shape=(Al.shape[0], n_agg),
        )
        AP = (Al @ P).tocsr()
        AP.data *= np.repeat(scale.astype(dtype), np.diff(AP.indptr))
        P2 = (P - AP).tocsr()
        ref = (P2.T @ Al @ P2).tocsr()
        ref.sort_indices()
        rtol = 1e-5 if dtype == np.float32 else 1e-13
        np.testing.assert_array_equal(got.indptr, ref.indptr, err_msg=name)
        np.testing.assert_array_equal(got.indices, ref.indices,
                                      err_msg=name)
        np.testing.assert_allclose(
            got.data, ref.data, rtol=rtol,
            atol=rtol * abs(ref.data).max(), err_msg=name,
        )
        assert got.dtype == dtype
        # tentative (scale=None): pure relabel-and-sum, exact equality
        got0 = _native.amg_rap_native(Al, labels, n_agg, None)
        C = Al.tocoo()
        ref0 = scipy.sparse.csr_matrix(
            (C.data, (labels[C.row], labels[C.col])), shape=(n_agg, n_agg)
        )
        ref0.sort_indices()
        assert abs(got0 - ref0).max() == 0.0


def test_amg_rap_complex_takes_scipy_route():
    """The RAP kernel is real-only; complex hierarchies must bypass it
    (amg_rap_native returns None) and the full setup still builds."""
    rng = np.random.default_rng(5)
    n = 128
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = scipy.sparse.csr_matrix(np.eye(n) * 12.0 + 0.5 * (C + C.conj().T))
    H.sort_indices()
    assert _native.amg_rap_native(H, np.zeros(n, np.int64), 1, None) is None
    M = amgmod.AMGPreconditioner.from_scipy(H, coarse_size=16)
    assert M.n_levels >= 1
