"""Auxiliary subsystems per SURVEY.md §5: profiling model, checkpoint/resume,
debug-mode numerical guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu
from krylov_tpu import profiling
from krylov_tpu.ops import stencil


def test_traffic_model_by_operator_type():
    Ac = stencil.poisson_2d_const(8, 16, dtype=np.float32)
    Av = stencil.poisson_2d(8, 16, dtype=np.float32)
    n = 128
    assert profiling.spmv_traffic_model(Ac) == 2 * n * 4
    assert profiling.spmv_traffic_model(Av) == 7 * n * 4
    csr = Av.tocsr()
    assert profiling.spmv_traffic_model(csr) > 2 * n * 4
    dense = np.eye(4)
    from krylov_tpu import as_operator

    assert profiling.spmv_traffic_model(as_operator(dense)) == (16 + 8) * 8


def test_timed_solve_and_roofline_report():
    A = stencil.poisson_2d(8, 8)
    b = jnp.ones(64)
    (sol, info), secs = profiling.timed_solve(
        krylov_tpu.cg, A, b, tol=1e-10, maxiter=200
    )
    assert info.success and secs > 0
    rep = profiling.roofline_report(A, 1e-3, device="NVIDIA H100 80GB HBM3")
    assert rep["bytes_ideal"] == 7 * 64 * 8
    assert rep["peak_gbps"] == 3350.0
    assert rep["fraction_of_roofline"] == rep["achieved_gbps"] / 3350.0
    assert rep["nnz_per_s"] > 0


def test_peak_table_h100_row():
    """The one peak table: NVIDIA's published H100 SXM figures, keyed by
    the ``device_kind`` JAX reports, with their source."""
    row = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert row["hbm_gbps"] == 3350.0
    assert row["bf16_tflops"] == 989.0
    assert row["tf32_tflops"] == 495.0
    assert row["f32_tflops"] == 67.0
    assert "NVIDIA" in row["source"]
    assert profiling.peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "Tesla V100-SXM2-16GB", "NVIDIA H100"])
def test_peak_table_unknown_device_raises(kind):
    """A device without a sourced row is an error, never a default — the
    CPU included (its kind is what the default device reports here)."""
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(kind)
    with pytest.raises(KeyError):
        profiling.roofline_report(stencil.poisson_2d(4, 4), 1e-3, device=kind)
    with pytest.raises(KeyError):
        profiling.peak_gbps()  # the CPU device this suite runs on


def test_checkpoint_resume_via_x0():
    """Checkpoint/resume semantics (SURVEY.md §5): solver state is the
    iterate; resuming from ``info.xk`` continues the solve, and the resumed
    residual picks up where the checkpoint left off."""
    rng = np.random.default_rng(0)
    A = np.diag(np.linspace(1.0, 100.0, 80))
    b = rng.standard_normal(80)

    # run 10 iterations, "checkpoint" xk
    _, info1 = krylov_tpu.cg(A, b, tol=1e-30, atol=0.0, maxiter=10)
    ckpt = np.asarray(info1.xk)  # serializable state

    # resume: the first residual of the resumed solve equals the explicit
    # residual of the checkpoint
    _, info2 = krylov_tpu.cg(A, b, x0=jnp.asarray(ckpt), tol=1e-10, maxiter=200)
    r_ckpt = np.linalg.norm(b - A @ ckpt)
    np.testing.assert_allclose(float(info2.resnorms[0]), r_ckpt, rtol=1e-12)
    assert info2.success

    # combined work converges to the same solution as an uninterrupted solve
    sol_full, _ = krylov_tpu.cg(A, b, tol=1e-10, maxiter=200)
    np.testing.assert_allclose(
        np.asarray(info2.xk), np.asarray(sol_full), atol=1e-8
    )


def test_imaginary_part_guard():
    """Debug-mode numerical guard (reference: src/krylov/cg.py:91-93):
    an inner product that should be real but is not raises."""
    A = np.diag([2.0, 3.0, 4.0]).astype(complex)
    b = np.array([1.0 + 0j, 1.0, 1.0])

    def bad_inner(x, y):
        return jnp.sum(x * y) + 0.5j  # injects a spurious imaginary part

    with pytest.raises(ValueError, match="imaginary"):
        krylov_tpu.cg(A, b, inner=bad_inner)


def test_nan_debug_mode():
    """jax_debug_nans support: solver internals are compatible with the
    debug flag on a well-posed solve."""
    A = np.diag(np.linspace(1.0, 10.0, 12))
    b = np.ones(12)
    with jax.debug_nans(True):
        sol, info = krylov_tpu.cg(A, b, tol=1e-10)
    assert info.success


def test_chebyshev_polynomial_preconditioner():
    """Fixed-degree Chebyshev polynomial preconditioner: reduction-free M
    applications (matvecs only) that substantially cut outer iterations."""
    import krylov_tpu
    from krylov_tpu.ops import stencil

    A = stencil.poisson_2d(32, 32)
    lo, hi = krylov_tpu.utils.estimate_spectrum(A, iters=40)
    M = krylov_tpu.ChebyshevPreconditioner(A, (lo, hi), degree=6)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(1024))

    sol_p, info_p = krylov_tpu.cg(A, b, M=M, tol=1e-9, maxiter=400)
    sol_n, info_n = krylov_tpu.cg(A, b, tol=1e-9, maxiter=400)
    assert info_p.success
    assert info_p.numsteps * 2 < info_n.numsteps
    r = np.linalg.norm(np.asarray(b) - np.asarray(A @ sol_p))
    assert r <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    # compiled backend and minres compatibility
    sol_w, info_w = krylov_tpu.cg(
        A, b, M=M, tol=1e-9, maxiter=400, backend="while_loop"
    )
    assert info_w.numsteps == info_p.numsteps
    sol_m, info_m = krylov_tpu.minres(A, b, M=M, tol=1e-8, maxiter=400)
    assert info_m.success
