"""Mixed-precision iterative refinement: working-precision accuracy from
low-precision inner solves."""

import jax.numpy as jnp
import numpy as np

import krylov_tpu
from krylov_tpu.ops import stencil


def test_refine_plain_restarts_to_tolerance():
    A = stencil.poisson_2d(8, 16)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(128))
    sol, info = krylov_tpu.refine(
        A, b, inner_tol=1e-1, inner_maxiter=20, tol=1e-10, maxiter=60
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ sol)
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b)))
    # outer history is monotone-ish and reached the criterion
    assert info.resnorms[-1] <= 1e-10 * info.resnorms[0] + 1e-15


def test_refine_low_precision_inner_reaches_f32_accuracy():
    # f32 working precision, bf16 inner operator: accuracy beyond what a
    # pure-bf16 solve can reach
    A32 = stencil.poisson_2d_const(16, 16, dtype=np.float32)
    A16 = stencil.ConstStencilOperator(
        (16, 16), A32.offsets_nd, A32.weights, jnp.bfloat16
    )
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(256), jnp.float32)

    sol, info = krylov_tpu.refine(
        A32, b, A_low=A16, inner_tol=5e-2, inner_maxiter=60,
        tol=1e-5, maxiter=60,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A32 @ sol)
    rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
    assert rel <= 2e-5

    # pure bf16 CG stalls far above that
    b16 = b.astype(jnp.bfloat16)
    _, info16 = krylov_tpu.cg(
        A16, b16, inner=lambda u, v: jnp.sum(u * v),
        tol=1e-5, maxiter=1000, backend="while_loop",
    )
    r16 = np.asarray(b, np.float32) - np.asarray(
        A32 @ jnp.asarray(np.asarray(info16.xk, np.float32))
    )
    rel16 = np.linalg.norm(r16) / np.linalg.norm(np.asarray(b))
    assert rel16 > rel  # refinement beats the pure low-precision solve


def test_refine_accepts_backend_kwarg():
    """backend= is documented for every solver; refine must forward it
    without a duplicate-keyword TypeError (round-1 advisor finding)."""
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.standard_normal(64))
    sol, info = krylov_tpu.refine(
        A, b, inner_tol=1e-1, inner_maxiter=20, tol=1e-10, maxiter=40,
        backend="eager",
    )
    assert info.success


def test_refine_with_bf16_csr_inner_operator():
    """The intended production pairing: f32 residuals against the exact
    operator, inner solves through a CSR operator whose values are stored
    in bf16 (half the value stream; products promote to f32); the defect
    correction recovers f32-level accuracy."""
    import scipy.sparse

    from krylov_tpu.ops.sparse import CSROperator

    n_side = 40
    n = n_side * n_side
    sp = scipy.sparse.diags(
        [-1.0, -1.0, 4.5, -1.0, -1.0], [-n_side, -1, 0, 1, n_side],
        shape=(n, n), format="csr",
    ).astype(np.float32)
    A = CSROperator.from_scipy(sp)
    A16 = CSROperator(
        A.data.astype(jnp.bfloat16), A.indices, A.indptr, A.shape,
        row_ids=A.row_ids,
    )
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    sol, info = krylov_tpu.refine(
        A, b, A_low=A16, inner_tol=1e-2, inner_maxiter=100,
        tol=1e-5, maxiter=20, backend="while_loop",
    )
    assert info.success
    assert info.numsteps <= 6  # bf16 inner still contracts fast
    r = b - sp @ np.asarray(info.xk)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-5
