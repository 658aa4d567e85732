"""Distributed-path tests on 8 virtual CPU devices.

The fake-backend mechanism the reference never needed (SURVEY.md §4): the
conftest forces ``xla_force_host_platform_device_count=8``, so the
row-partitioned SpMV / halo-exchange / psum paths run as a real 8-way SPMD
program without accelerator hardware.  Numerical ground truth is the single-device
solver on the same system.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

import krylov_tpu
from krylov_tpu import parallel
from krylov_tpu.ops import stencil

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def _mesh(n_rows=8, n_rhs=1):
    return parallel.make_mesh(n_rows=n_rows, n_rhs=n_rhs)


def test_banded_spmv_matches_dense():
    A = stencil.poisson_2d(8, 16)  # N=128, offsets (-16,-1,0,1,16)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(128))
    want = A @ x

    mesh = _mesh()
    fn = jax.shard_map(
        lambda c, v: parallel.ShardedBandedOperator(c, A.offsets, hermitian=True)
        @ v,
        mesh=mesh,
        in_specs=(
            jax.sharding.PartitionSpec(None, "rows"),
            jax.sharding.PartitionSpec("rows"),
        ),
        out_specs=jax.sharding.PartitionSpec("rows"),
    )
    got = fn(A.coeffs, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_banded_rmatvec_nonsymmetric():
    # non-symmetric banded operator: convection-diffusion-ish
    n = 64
    rng = np.random.default_rng(1)
    coeffs = np.zeros((3, n))
    offsets = (-1, 0, 1)
    coeffs[1] = 2.0 + rng.random(n)
    coeffs[0, 1:] = -1.3  # sub
    coeffs[2, : n - 1] = -0.7  # super
    A = stencil.BandedOperator(jnp.asarray(coeffs), offsets, hermitian=False)
    x = jnp.asarray(rng.standard_normal(n))
    want = A.rmatvec(x)

    mesh = _mesh()
    fn = jax.shard_map(
        lambda c, v: parallel.ShardedBandedOperator(c, offsets).rmatvec(v),
        mesh=mesh,
        in_specs=(
            jax.sharding.PartitionSpec(None, "rows"),
            jax.sharding.PartitionSpec("rows"),
        ),
        out_specs=jax.sharding.PartitionSpec("rows"),
    )
    got = fn(A.coeffs, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0), (0, 1, 2), (-2, -1, 0)])
def test_banded_rmatvec_one_sided_offsets(offsets):
    """Adjoint halo widths are the mirror of the matvec's — a one-sided
    offset range (e.g. upper-bidiagonal) exercises the swap (round-1
    advisor finding: the unswapped halo silently corrupted every row)."""
    n = 64
    rng = np.random.default_rng(21)
    coeffs = np.zeros((len(offsets), n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), n - max(0, off)
        coeffs[d, lo:hi] = rng.standard_normal(hi - lo)
    A = stencil.BandedOperator(jnp.asarray(coeffs), offsets, hermitian=False)
    x = jnp.asarray(rng.standard_normal(n))
    want = A.rmatvec(x)
    # also pin against the dense adjoint
    dense = np.zeros((n, n))
    for d, off in enumerate(offsets):
        for i in range(max(0, -off), n - max(0, off)):
            dense[i, i + off] = coeffs[d, i]
    np.testing.assert_allclose(np.asarray(want), dense.T @ np.asarray(x), atol=1e-13)

    mesh = _mesh()
    fn = jax.shard_map(
        lambda c, v: parallel.ShardedBandedOperator(c, offsets).rmatvec(v),
        mesh=mesh,
        in_specs=(
            jax.sharding.PartitionSpec(None, "rows"),
            jax.sharding.PartitionSpec("rows"),
        ),
        out_specs=jax.sharding.PartitionSpec("rows"),
    )
    got = fn(A.coeffs, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


@pytest.mark.parametrize("solver", [krylov_tpu.cg, krylov_tpu.minres])
def test_sharded_solve_banded_matches_single_device(solver):
    A = stencil.poisson_2d(8, 16)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(128))

    sol_ref, info_ref = solver(A, b, tol=1e-10, maxiter=200)
    sol, info = parallel.sharded_solve(
        solver, A, b, mesh=_mesh(), tol=1e-10, maxiter=200
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    # residual trajectories agree to tight tolerance (same arithmetic modulo
    # reduction order)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )


def test_sharded_solve_gmres_banded():
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(64))
    sol, info = parallel.sharded_solve(
        krylov_tpu.gmres, A, b, mesh=_mesh(), tol=1e-10, maxiter=60
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-10 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_gmres_cgs_single_psum_ortho():
    """ortho='cgs': whole CGS sweep travels in one psum (batch_inner
    injection); trajectory matches the single-device compiled solve."""
    n = 512
    main = 2.0 + np.arange(n) / n
    A = scipy.sparse.diags(
        [-0.5 * np.ones(n - 1), main, -0.6 * np.ones(n - 1)],
        [-1, 0, 1], format="csr",
    )
    b = np.sin(np.arange(n) * 0.1)

    sol_ref, info_ref = krylov_tpu.gmres(
        A.toarray(), b, ortho="cgs", tol=1e-10, maxiter=60,
        backend="while_loop",
    )
    sol, info = parallel.sharded_solve(
        krylov_tpu.gmres, A, b, mesh=_mesh(), ortho="cgs", tol=1e-10,
        maxiter=60,
    )
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(
        np.asarray(sol), np.asarray(sol_ref), atol=1e-12
    )
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-10, atol=1e-13
    )


def test_sharded_gmres_cgs_grid_path():
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.standard_normal(256))
    dense = np.asarray(A @ np.eye(256))
    sol_ref, _ = krylov_tpu.gmres(
        dense, np.asarray(b), ortho="cgs", tol=1e-10, maxiter=80,
        backend="while_loop",
    )
    sol, info = parallel.sharded_solve(
        krylov_tpu.gmres, A, b, mesh=_mesh(), ortho="cgs", tol=1e-10,
        maxiter=80,
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-9)


def test_sharded_solve_csr_halo_mode():
    sp = scipy.sparse.diags(
        [-1.0, 2.5, -1.0], [-1, 0, 1], shape=(64, 64), format="csr"
    )
    part = parallel.partition_csr(sp, 8)
    assert part["mode"] == "halo"
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal(64))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-12, maxiter=200
    )
    assert info.success
    x_ref = scipy.sparse.linalg.spsolve(sp.tocsc(), np.asarray(b))
    np.testing.assert_allclose(np.asarray(sol), x_ref, atol=1e-9)


def test_sharded_solve_csr_gather_mode():
    # dense-ish random SPD pattern -> columns far from the diagonal
    rng = np.random.default_rng(5)
    n = 64
    Q = rng.standard_normal((n, n))
    dense = Q @ Q.T + n * np.eye(n)
    dense[np.abs(dense) < 1.0] = 0.0
    dense = (dense + dense.T) / 2
    sp = scipy.sparse.csr_matrix(dense)
    part = parallel.partition_csr(sp, 8)
    assert part["mode"] == "gather"
    b = jnp.asarray(rng.standard_normal(n))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-12, maxiter=300
    )
    assert info.success
    x_ref = np.linalg.solve(dense, np.asarray(b))
    np.testing.assert_allclose(np.asarray(sol), x_ref, atol=1e-8)


def test_sharded_csr_rmatvec_both_modes():
    rng = np.random.default_rng(6)
    for pattern in ["banded", "random"]:
        if pattern == "banded":
            sp = scipy.sparse.diags(
                [rng.random(63), 2 + rng.random(64), rng.random(63)],
                [-1, 0, 1],
                format="csr",
            )
        else:
            sp = scipy.sparse.random(
                64, 64, density=0.2, random_state=7, format="csr"
            )
        part = parallel.partition_csr(sp, 8)
        x = jnp.asarray(rng.standard_normal(64))
        want = sp.T.conj() @ np.asarray(x)

        mesh = _mesh()
        P = jax.sharding.PartitionSpec
        fn = jax.shard_map(
            lambda d, c, r, v: parallel.ShardedCSROperator(
                d[0], c[0], r[0], part["n_local"], part["halo"], part["mode"]
            ).rmatvec(v),
            mesh=mesh,
            in_specs=(P("rows", None), P("rows", None), P("rows", None), P("rows")),
            out_specs=P("rows"),
            check_vma=False,
        )
        got = fn(
            jnp.asarray(part["data"]),
            jnp.asarray(part["col"]),
            jnp.asarray(part["row"]),
            x,
        )
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_sharded_solve_multi_rhs_over_rhs_axis():
    A = stencil.poisson_2d(8, 8)
    rng = np.random.default_rng(8)
    b = jnp.asarray(rng.standard_normal((64, 2)))
    mesh = parallel.make_mesh(n_rows=4, n_rhs=2)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=mesh, shard_rhs=True, tol=1e-10, maxiter=200
    )
    assert info.success
    sol_ref, _ = krylov_tpu.cg(A, b, tol=1e-10, maxiter=200)
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    assert info.resnorms.shape[1:] == (2,)


def test_sharded_grid_stencil_matvec_matches_single_device():
    A = stencil.poisson_2d(16, 16)  # grid (16, 16), N=256
    rng = np.random.default_rng(10)
    x2 = jnp.asarray(rng.standard_normal((16, 16)))
    want = A @ x2  # single-device grid matvec

    mesh = _mesh()
    P = jax.sharding.PartitionSpec
    fn = jax.shard_map(
        lambda c, v: parallel.ShardedGridStencilOperator(
            c, A.offsets, A.ny, hermitian=True
        )
        @ v,
        mesh=mesh,
        in_specs=(P(None, "rows", None), P("rows", None)),
        out_specs=P("rows", None),
        check_vma=False,
    )
    got = fn(A.coeffs2d, x2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)


def test_sharded_solve_uses_grid_path_and_matches():
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(11)
    b = jnp.asarray(rng.standard_normal(256))

    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-10, maxiter=300)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=300
    )
    assert info.success
    assert sol.shape == (256,)  # flat in, flat out
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )


def test_sharded_solve_grid_shaped_rhs():
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(12)
    b2 = jnp.asarray(rng.standard_normal((16, 16)))
    sol, info = parallel.sharded_solve(
        krylov_tpu.gmres, A, b2, mesh=_mesh(), tol=1e-10, maxiter=120
    )
    assert info.success
    assert sol.shape == (16, 16)  # grid in, grid out
    r = np.asarray(b2) - np.asarray(A @ sol)
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b2)))


def test_sharded_solve_jacobi_preconditioned():
    """Distributed Jacobi-preconditioned CG matches single-device."""
    rng = np.random.default_rng(13)
    # variable-coefficient SPD banded system with a rough diagonal
    n = 128
    d = 1.0 + 10.0 * rng.random(n)
    coeffs = np.zeros((3, n))
    coeffs[1] = d
    coeffs[0, 1:] = -0.4
    coeffs[2, : n - 1] = -0.4
    A = stencil.BandedOperator(jnp.asarray(coeffs), (-1, 0, 1), hermitian=True)
    b = jnp.asarray(rng.standard_normal(n))
    M_diag = 1.0 / d

    sol_ref, info_ref = krylov_tpu.cg(
        A, b, M=krylov_tpu.DiagonalOperator(jnp.asarray(M_diag)),
        tol=1e-10, maxiter=300,
    )
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), M_diag=M_diag,
        tol=1e-10, maxiter=300,
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    # preconditioning must actually help vs unpreconditioned
    _, info_np = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=300
    )
    assert info.numsteps <= info_np.numsteps


def test_sharded_solve_grid_jacobi_preconditioned():
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(14)
    b = jnp.asarray(rng.standard_normal(256))
    M_diag = 1.0 / np.asarray(A.diagonal())
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), M_diag=M_diag,
        tol=1e-10, maxiter=300,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_const_stencil_matvec_and_solve():
    A = stencil.poisson_2d_const(16, 16, dtype=np.float64)
    rng = np.random.default_rng(30)
    x2 = jnp.asarray(rng.standard_normal((16, 16)))
    want = A @ x2

    mesh = _mesh()
    P = jax.sharding.PartitionSpec
    fn = jax.shard_map(
        lambda v: parallel.ShardedConstStencilOperator(A, 2) @ v,
        mesh=mesh,
        in_specs=(P("rows", None),),
        out_specs=P("rows", None),
        check_vma=False,
    )
    got = fn(x2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)

    b = jnp.asarray(rng.standard_normal(256))
    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-10, maxiter=300)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=mesh, tol=1e-10, maxiter=300
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)


def test_sharded_const_stencil_3d():
    A = stencil.poisson_3d_const(8, 4, 16, dtype=np.float64)  # M=32, ny=16
    rng = np.random.default_rng(31)
    b = jnp.asarray(rng.standard_normal(512))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=600
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_gmres_restarted():
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(32)
    b = jnp.asarray(rng.standard_normal(256))
    sol, info = parallel.sharded_solve(
        krylov_tpu.gmres, A, b, mesh=_mesh(), restart=20, tol=1e-8,
        maxiter=400,
    )
    assert info.success
    assert info.numsteps > 20  # actually restarted
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))
    assert info.resnorms.shape == (info.numsteps + 1,)


def test_sharded_chebyshev_and_jacobi():
    # solver-specific kwargs flow through sharded_solve
    A = stencil.poisson_2d(8, 16)
    rng = np.random.default_rng(33)
    b = jnp.asarray(rng.standard_normal(128))
    # eigenvalues of the 2-D Dirichlet Laplacian lie in (0, 8)
    sol, info = parallel.sharded_solve(
        krylov_tpu.chebyshev, A, b, mesh=_mesh(),
        eigenvalue_estimates=(0.05, 7.95), tol=1e-6, maxiter=2000,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-5 * (1 + np.linalg.norm(np.asarray(b)))

    sol_j, info_j = parallel.sharded_solve(
        krylov_tpu.jacobi, A, b, mesh=_mesh(), omega=0.9, tol=1e-6,
        maxiter=3000,
    )
    assert info_j.success


def test_sharded_gauss_seidel_hybrid_smoother():
    """Sharded GS: per-shard sweeps with block-Jacobi boundaries (the
    hybrid smoother of SURVEY.md §7) — converges on the SPD grid system,
    though along a different trajectory than exact single-chip GS."""
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(40)
    b = jnp.asarray(rng.standard_normal(256))
    sol, info = parallel.sharded_solve(
        krylov_tpu.gauss_seidel, A, b, mesh=_mesh(), tol=1e-6, maxiter=5000
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-5 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_grid_overlap_path_matches():
    """Thick shards exercise the overlapped matvec (zero-halo full kernel +
    boundary-strip fixes); thin shards use the dependent path."""
    A = stencil.poisson_2d(32, 16)  # grid (32, 16): m_local=8 > 2h over 4 shards
    rng = np.random.default_rng(41)
    x2 = jnp.asarray(rng.standard_normal((32, 16)))
    want = A @ x2

    mesh = parallel.make_mesh(n_rows=4)
    P = jax.sharding.PartitionSpec
    fn = jax.shard_map(
        lambda c, v: parallel.ShardedGridStencilOperator(
            c, A.offsets, A.ny, hermitian=True
        )
        @ v,
        mesh=mesh,
        in_specs=(P(None, "rows", None), P("rows", None)),
        out_specs=P("rows", None),
        check_vma=False,
    )
    got = fn(A.coeffs2d, x2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-13)

    # full sharded solve down the overlapped path
    b = jnp.asarray(rng.standard_normal(512))
    sol_ref, _ = krylov_tpu.cg(A, b, tol=1e-10, maxiter=400)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=mesh, tol=1e-10, maxiter=400
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)


def test_sharded_grid_multi_rhs_matches_single_device():
    """Blocked multi-RHS on the grid fast path (reference selling point #4 on
    the distributed path): sharded CG with (N, 3) RHS matches single-device
    trajectories column-for-column."""
    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(50)
    B = jnp.asarray(rng.standard_normal((256, 3)))

    sol_ref, info_ref = krylov_tpu.cg(A, B, tol=1e-10, maxiter=300)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, B, mesh=_mesh(), tol=1e-10, maxiter=300
    )
    assert info.success
    assert sol.shape == (256, 3)
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    assert info.resnorms.shape[1:] == (3,)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )

    # grid-shaped multi-RHS and Jacobi preconditioning ride the same path
    B3 = jnp.asarray(rng.standard_normal((16, 16, 2)))
    M_diag = 1.0 / np.asarray(A.diagonal())
    sol3, info3 = parallel.sharded_solve(
        krylov_tpu.cg, A, B3, mesh=_mesh(), M_diag=M_diag,
        tol=1e-10, maxiter=300,
    )
    assert info3.success
    assert sol3.shape == (16, 16, 2)
    r = np.asarray(B3) - np.asarray(A @ sol3)
    assert np.linalg.norm(r) <= 1e-8 * (1 + np.linalg.norm(np.asarray(B3)))


def test_sharded_bsr_solve_and_rmatvec():
    """Block-structured operator sharded over the mesh (all-gather mode):
    CG matches single-device; rmatvec matches the dense adjoint."""
    import scipy.sparse

    from krylov_tpu.ops.bsr import BSROperator

    rng = np.random.default_rng(60)
    n, R = 512, 32
    nb = n // R
    dense = np.zeros((n, n))
    for i in range(nb):
        blk = rng.standard_normal((R, R))
        dense[i*R:(i+1)*R, i*R:(i+1)*R] = blk @ blk.T + (R + 2) * np.eye(R)
        j = int(rng.integers(0, nb))  # a scattered off-diagonal block pair
        c = 0.05 * rng.standard_normal((R, R))
        dense[i*R:(i+1)*R, j*R:(j+1)*R] += c
        dense[j*R:(j+1)*R, i*R:(i+1)*R] += c.T
    A = BSROperator.from_scipy(scipy.sparse.csr_matrix(dense), blocksize=(R, R))
    b = jnp.asarray(rng.standard_normal(n))

    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-10, maxiter=400)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert info.success
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )

    # sharded rmatvec against the dense adjoint
    mesh = _mesh()
    P = jax.sharding.PartitionSpec
    x = jnp.asarray(rng.standard_normal(n))
    fn = jax.shard_map(
        lambda d, c, v: parallel.ShardedBSROperator(d, c, n).rmatvec(v),
        mesh=mesh,
        in_specs=(P("rows", None, None), P("rows", None), P("rows")),
        out_specs=P("rows"),
        check_vma=False,
    )
    got = fn(A.data, A.cols, x)
    np.testing.assert_allclose(
        np.asarray(got), dense.T @ np.asarray(x), atol=1e-10
    )


def test_sharded_f32_csr_solve_matches_single_device():
    """General-sparsity f32 CSR sharded over the mesh (all-gather mode for
    this scattered pattern): CG matches the single-device iteration count;
    the sharded rmatvec matches the scipy adjoint."""
    rng = np.random.default_rng(70)
    n = 1024
    rows = np.repeat(np.arange(1, n), 3)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix(
        (0.2 * rng.standard_normal(rows.shape[0]), (rows, cols)),
        shape=(n, n),
    )
    A = (A + A.T).tocsr()
    A.setdiag(4.0 + rng.random(n))
    A.sum_duplicates()
    A = A.astype(np.float32)
    part = parallel.partition_csr(A, 8)
    assert part["mode"] == "gather"

    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    sol_ref, info_ref = krylov_tpu.cg(A.astype(np.float64), b.astype(jnp.float64),
                                      tol=1e-4, maxiter=200)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-4, maxiter=200
    )
    assert info.success
    assert np.asarray(sol).dtype == np.float32
    r = np.asarray(b) - A @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(np.asarray(b)))
    assert info.numsteps == info_ref.numsteps

    # sharded rmatvec against the scipy adjoint
    P = jax.sharding.PartitionSpec
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    fn = jax.shard_map(
        lambda d, c, r, v: parallel.ShardedCSROperator(
            d[0], c[0], r[0], part["n_local"], part["halo"], part["mode"]
        ).rmatvec(v),
        mesh=_mesh(),
        in_specs=(P("rows", None),) * 3 + (P("rows"),),
        out_specs=P("rows"),
        check_vma=False,
    )
    got = fn(
        jnp.asarray(part["data"]), jnp.asarray(part["col"]),
        jnp.asarray(part["row"]), x,
    )
    want = A.T.conj() @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4)


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_f32_csr_multi_rhs(k):
    """Blocked RHS through the sharded CSR operator: every column
    converges and keeps its own residual."""
    rng = np.random.default_rng(71)
    n = 512
    sp = scipy.sparse.diags(
        [-1.0, 3.1, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    ).astype(np.float32)
    B = jnp.asarray(rng.standard_normal((n, k)), jnp.float32)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, sp, B, mesh=_mesh(), tol=1e-4, maxiter=300
    )
    assert info.success
    R = np.asarray(B) - sp @ np.asarray(sol)
    assert np.max(np.linalg.norm(R, axis=0)) <= 1e-3 * (
        1 + np.max(np.linalg.norm(np.asarray(B), axis=0))
    )


def test_sharded_chebyshev_polynomial_preconditioner():
    """M_factory builds a matvec-based preconditioner on the shard-local
    operator: the polynomial preconditioner's matvecs become the sharded
    halo-exchanging matvecs, so a degree-m M application costs m halo
    exchanges and ZERO allreduces."""
    from krylov_tpu import ChebyshevPreconditioner

    A = stencil.poisson_2d(16, 16)
    rng = np.random.default_rng(80)
    b = jnp.asarray(rng.standard_normal(256))
    lo, hi = krylov_tpu.utils.estimate_spectrum(A, iters=40)

    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=lambda A_l: ChebyshevPreconditioner(A_l, (lo, hi), degree=6),
        tol=1e-9, maxiter=300,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-8 * (1 + np.linalg.norm(np.asarray(b)))

    # must actually cut iterations vs unpreconditioned sharded CG
    _, info_n = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-9, maxiter=300
    )
    assert info.numsteps * 2 < info_n.numsteps


def test_sharded_multigrid_full_coupling_matches_single_device():
    """The fully distributed V-cycle (halo-exchanging smoothers, local
    grid transfer, redundant gathered coarse solve) reproduces the
    single-device multigrid iteration count independent of shard count."""
    from krylov_tpu import MultigridPreconditioner, multigrid_factory

    A = stencil.poisson_2d_const(128, 128, dtype=np.float64)
    rng = np.random.default_rng(91)
    b = jnp.asarray(rng.standard_normal((128, 128)))

    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=multigrid_factory(coupling="full"),
        tol=1e-8, maxiter=200,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    _, info1 = krylov_tpu.cg(
        A, b, M=MultigridPreconditioner(A),
        inner=lambda u, v: jnp.sum(u * v), tol=1e-8, maxiter=200,
    )
    assert abs(info.numsteps - info1.numsteps) <= 2  # ~15 on Poisson


def test_sharded_multigrid_local_coupling_and_3d():
    """coupling="local" is additive Schwarz with MG subdomain solves:
    zero cross-device traffic per application, more (but still O(10²))
    iterations; the 3-D collapsed layout shards whole x-planes."""
    from krylov_tpu import multigrid_factory

    rng = np.random.default_rng(92)
    A = stencil.poisson_2d_const(128, 128, dtype=np.float64)
    b = jnp.asarray(rng.standard_normal((128, 128)))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=multigrid_factory(coupling="local"),
        tol=1e-8, maxiter=400,
    )
    assert info.success and info.numsteps <= 120
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    # 3-D: (32,16,16) grid collapses to (512, 16); 64 rows/shard = 4
    # x-planes, multi-RHS tail rides along
    A3 = stencil.poisson_3d_const(32, 16, 16, dtype=np.float64)
    B3 = jnp.asarray(rng.standard_normal((32 * 16, 16, 2)))
    sol3, info3 = parallel.sharded_solve(
        krylov_tpu.cg, A3, B3, mesh=_mesh(),
        M_factory=multigrid_factory(),  # auto -> full
        tol=1e-8, maxiter=200,
    )
    assert info3.success and info3.numsteps <= 25
    R3 = np.asarray(B3) - np.asarray(A3 @ jnp.asarray(sol3))
    assert np.linalg.norm(R3) <= 1e-7 * (1 + np.linalg.norm(np.asarray(B3)))


def _var_diffusion(nx, ny, a):
    """SPD -div(a grad u) via the library constructor (Dirichlet walls)."""
    return stencil.diffusion_2d(np.broadcast_to(a, (nx, ny)))


def test_sharded_galerkin_multigrid_variable_coefficients():
    """Variable-coefficient grids get the distributed Galerkin cycle:
    coarse coefficients are computed SHARD-LOCALLY by parity
    sub-sampling (exact P^T A P — even local row counts keep global and
    local parities equal), smoothers halo-exchange at every level, and
    the coarsest gathered problem keeps coarsening redundantly down to
    a dense inverse."""
    rng = np.random.default_rng(95)
    nx = ny = 128
    X, Y = np.meshgrid(
        np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij"
    )
    a = 1.0 + 0.9 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    A = _var_diffusion(nx, ny, a)
    b = jnp.asarray(rng.standard_normal((nx, ny)))

    from krylov_tpu import multigrid_factory

    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=multigrid_factory(), tol=1e-9, maxiter=400,
    )
    assert info.success and info.numsteps <= 40
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    _, info_n = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-9, maxiter=4000,
    )
    assert info.numsteps * 10 <= info_n.numsteps


def test_sharded_galerkin_multigrid_padded_and_multirhs():
    """Prime grid-row counts ride the unit-diagonal padding (identity
    rows mix into coarse cells but the padded system is block-diagonal,
    so the cycle stays SPD); blocked RHS columns ride the same cycle."""
    rng = np.random.default_rng(96)
    A = _var_diffusion(
        67, 32,
        1.0 + 0.5 * np.abs(np.sin(3 * np.linspace(0, 1, 67)))[:, None]
        * np.ones(32),
    )
    B = jnp.asarray(rng.standard_normal((67, 32, 2)))

    from krylov_tpu import multigrid_factory

    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, B, mesh=_mesh(),
        M_factory=multigrid_factory(), tol=1e-9, maxiter=400,
    )
    assert info.success
    R = np.asarray(B) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(R) <= 1e-7 * (1 + np.linalg.norm(np.asarray(B)))

    with pytest.raises(ValueError, match="local"):
        parallel.sharded_solve(
            krylov_tpu.cg, A, B[:, :, 0], mesh=_mesh(),
            M_factory=multigrid_factory(coupling="local"),
            tol=1e-9, maxiter=10,
        )


def test_sharded_multigrid_padded_falls_back_to_local():
    """Prime grid-row count: zero-padding breaks cross-shard coarsening,
    so auto coupling degrades to the shard-local cycle (masked at padded
    rows so trajectories stay equivalent to the unpadded problem);
    explicit coupling="full" refuses loudly."""
    from krylov_tpu import multigrid_factory

    rng = np.random.default_rng(93)
    A = stencil.poisson_2d_const(67, 16, dtype=np.float64)
    b = jnp.asarray(rng.standard_normal(67 * 16))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=multigrid_factory(), tol=1e-9, maxiter=600,
    )
    assert info.success
    assert np.isfinite(np.asarray(sol)).all()
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-8 * (1 + np.linalg.norm(np.asarray(b)))

    with pytest.raises(ValueError, match="padded grids"):
        parallel.sharded_solve(
            krylov_tpu.cg, A, b, mesh=_mesh(),
            M_factory=multigrid_factory(coupling="full"),
            tol=1e-9, maxiter=10,
        )


def test_sharded_csr_prime_n_pads_to_shards():
    """N=509 (prime) on 8 devices: partition_csr zero-pads rows/cols to
    the shard multiple; trajectories match the single-device solve
    exactly (VERDICT r2 item 7: lift the N % n_rows == 0 restriction)."""
    rng = np.random.default_rng(90)
    n = 509
    sp = scipy.sparse.diags(
        [-1.0, 3.2, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    )
    sp = sp + scipy.sparse.diags(0.5 * rng.random(n))
    b = jnp.asarray(rng.standard_normal(n))

    sol_ref, info_ref = krylov_tpu.cg(sp, b, tol=1e-10, maxiter=400)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert info.success
    assert sol.shape == (n,)
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )

    # Jacobi-preconditioned, multi-RHS through the same padded path
    B = jnp.asarray(rng.standard_normal((n, 2)))
    M_diag = 1.0 / np.asarray(sp.diagonal())
    solB, infoB = parallel.sharded_solve(
        krylov_tpu.cg, sp, B, mesh=_mesh(), M_diag=M_diag,
        tol=1e-10, maxiter=400,
    )
    assert infoB.success
    R = np.asarray(B) - sp @ np.asarray(solB)
    assert np.linalg.norm(R) <= 1e-8 * (1 + np.linalg.norm(np.asarray(B)))


def test_sharded_grid_prime_rows_pads_to_shards():
    """Grid with a prime row count (67) over 8 devices, both the
    variable-coefficient and the const-stencil fast paths."""
    rng = np.random.default_rng(91)

    # variable-coefficient path: zero coefficient rows pad the grid
    A = stencil.poisson_2d(67, 16)
    b = jnp.asarray(rng.standard_normal(67 * 16))
    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-10, maxiter=600)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=600
    )
    assert info.success
    assert sol.shape == (67 * 16,)
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref), atol=1e-8)

    # const-stencil path: masked rows >= Mg in the local matvec
    Ac = stencil.poisson_2d_const(67, 16, dtype=np.float64)
    bc = jnp.asarray(rng.standard_normal((67, 16)))
    sol_refc, info_refc = krylov_tpu.cg(
        Ac, bc, inner=lambda u, v: jnp.sum(jnp.conj(u) * v),
        tol=1e-10, maxiter=600,
    )
    solc, infoc = parallel.sharded_solve(
        krylov_tpu.cg, Ac, bc, mesh=_mesh(), tol=1e-10, maxiter=600
    )
    assert infoc.success
    assert solc.shape == (67, 16)
    assert infoc.numsteps == info_refc.numsteps
    np.testing.assert_allclose(
        np.asarray(solc), np.asarray(sol_refc), atol=1e-8
    )


def test_sharded_padded_rows_unit_diagonal_no_nan():
    """Padded shards carry a UNIT diagonal, so diagonal-dividing solvers
    (jacobi) and M_factory smoothers (SSOR sweeps) see a 1 at padded
    rows instead of 0/0 = NaN, while Krylov trajectories stay identical
    to the unpadded problem (r3 review finding: zero-diagonal padding
    NaN-contaminated every diagonal-dividing path)."""
    from krylov_tpu import SSORSmoother

    rng = np.random.default_rng(101)

    # grid path, prime row count (67 % 8 != 0) + SSOR-smoother M_factory:
    # the smoother's sweeps divide by the padded rows' diagonal
    A = stencil.poisson_2d(67, 16)
    b = jnp.asarray(rng.standard_normal(67 * 16))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=lambda A_l: SSORSmoother(A_l),
        tol=1e-10, maxiter=600,
    )
    assert info.success
    assert np.isfinite(np.asarray(sol)).all()
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-8 * (1 + np.linalg.norm(np.asarray(b)))

    # grid path + jacobi as the SOLVER (update = omega * r / diag)
    sol_j, info_j = parallel.sharded_solve(
        krylov_tpu.jacobi, A, b, mesh=_mesh(), omega=0.9, tol=1e-6,
        maxiter=4000,
    )
    assert info_j.success
    assert np.isfinite(np.asarray(sol_j)).all()

    # CSR path, prime N + jacobi solver through the padded partition
    n = 509
    sp = scipy.sparse.diags(
        [-1.0, 3.2, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    )
    bj = jnp.asarray(rng.standard_normal(n))
    sol_c, info_c = parallel.sharded_solve(
        krylov_tpu.jacobi, sp, bj, mesh=_mesh(), tol=1e-8, maxiter=500,
    )
    assert info_c.success
    assert np.isfinite(np.asarray(sol_c)).all()
    rj = np.asarray(bj) - sp @ np.asarray(sol_c)
    assert np.linalg.norm(rj) <= 1e-7 * (1 + np.linalg.norm(np.asarray(bj)))


def _spd_csr(n, rng, density=0.004):
    sp = scipy.sparse.random(n, n, density=density, random_state=42,
                             format="csr")
    sp = sp + sp.T
    sp.setdiag(4.0 + rng.random(n))
    sp.sum_duplicates()
    return sp.tocsr()


def test_sharded_bicgstab_jacobi_matches_single_device():
    """BASELINE config-4 family end-to-end: Jacobi-preconditioned
    BiCGSTAB over a row-partitioned CSR operator (8 virtual devices)
    matches the single-device solve (VERDICT r2 item 2)."""
    rng = np.random.default_rng(95)
    n = 512
    sp = _spd_csr(n, rng)
    # mildly nonsymmetric so the two-sided family is exercised honestly
    sp = (sp + scipy.sparse.diags(0.3 * rng.random(n - 1), 1)).tocsr()
    b = jnp.asarray(rng.standard_normal(n))
    M_diag = 1.0 / np.asarray(sp.diagonal())

    sol_ref, info_ref = krylov_tpu.bicgstab(
        sp, b, Ml=krylov_tpu.DiagonalOperator(jnp.asarray(M_diag)),
        tol=1e-9, maxiter=300,
    )
    sol, info = parallel.sharded_solve(
        krylov_tpu.bicgstab, sp, b, mesh=_mesh(), M_diag=M_diag,
        tol=1e-9, maxiter=300,
    )
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref),
                               atol=1e-7)
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-7, atol=1e-10
    )


def test_sharded_qmr_jacobi_matches_single_device():
    """QMR (split-preconditioned, needs the sharded rmatvec) over
    row-partitioned CSR with a Jacobi left preconditioner."""
    rng = np.random.default_rng(96)
    n = 512
    sp = _spd_csr(n, rng)
    sp = (sp + scipy.sparse.diags(0.2 * rng.random(n - 1), -1)).tocsr()
    b = jnp.asarray(rng.standard_normal(n))
    M_diag = 1.0 / np.asarray(sp.diagonal())

    sol_ref, info_ref = krylov_tpu.qmr(
        sp, b, Ml=krylov_tpu.DiagonalOperator(jnp.asarray(M_diag)),
        tol=1e-9, maxiter=300,
    )
    sol, info = parallel.sharded_solve(
        krylov_tpu.qmr, sp, b, mesh=_mesh(), M_diag=M_diag,
        tol=1e-9, maxiter=300,
    )
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(np.asarray(sol), np.asarray(sol_ref),
                               atol=1e-7)


def test_sharded_bicgstab_over_f32_csr():
    """BiCGSTAB over the general-sparsity sharded f32 CSR operator."""
    rng = np.random.default_rng(97)
    n = 512
    sp = _spd_csr(n, rng, density=0.01).astype(np.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    sol, info = parallel.sharded_solve(
        krylov_tpu.bicgstab, sp, b, mesh=_mesh(), tol=1e-4, maxiter=300
    )
    assert info.success
    r = np.asarray(b) - sp @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_bicgstab_grid_ssor_smoother():
    """BiCGSTAB on the grid fast path with an SSOR-smoother LEFT
    preconditioner built per shard (block-Jacobi boundaries)."""
    from krylov_tpu import SSORSmoother

    A = stencil.poisson_2d(32, 16)
    rng = np.random.default_rng(98)
    b = jnp.asarray(rng.standard_normal(32 * 16))

    sol, info = parallel.sharded_solve(
        krylov_tpu.bicgstab, A, b, mesh=_mesh(),
        M_factory=lambda A_l: SSORSmoother(A_l),
        tol=1e-9, maxiter=400,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-8 * (1 + np.linalg.norm(np.asarray(b)))

    # the smoother must actually accelerate vs unpreconditioned
    _, info_np = parallel.sharded_solve(
        krylov_tpu.bicgstab, A, b, mesh=_mesh(), tol=1e-9, maxiter=400
    )
    assert info.numsteps < info_np.numsteps


def test_sharded_cg_ssor_smoother_spd():
    """CG with the SSOR smoother as SPD M on the sharded grid path."""
    from krylov_tpu import SSORSmoother

    A = stencil.poisson_2d(32, 32)
    rng = np.random.default_rng(99)
    b = jnp.asarray(rng.standard_normal(32 * 32))
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(),
        M_factory=lambda A_l: SSORSmoother(A_l),
        tol=1e-10, maxiter=400,
    )
    assert info.success
    r = np.asarray(b) - np.asarray(A @ jnp.asarray(sol))
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b)))
    _, info_np = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert info.numsteps < info_np.numsteps


def test_sharded_f32_csr_prime_n_pads_to_shards():
    """Prime-sized N through the f32 CSR partition: partition_csr pads
    with unit-diagonal rows to the shard multiple and sharded_solve pads
    the vectors, so general sparsity needs no divisibility either."""
    rng = np.random.default_rng(101)
    n = 509
    sp = scipy.sparse.diags(
        [-1.0, 3.3, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    ).astype(np.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-4, maxiter=300
    )
    assert info.success
    assert sol.shape == (n,)
    r = np.asarray(b) - sp @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_f32_csr_rcm_reorder_matches_user_order():
    """sharded_solve(reorder="rcm") on a scrambled f32 CSR matrix solves in
    the bandwidth-reduced order and returns the iterate in USER order;
    the trajectory matches the unreordered sharded solve step-for-step
    (permutation-invariant inner products), and a Jacobi ``M_diag`` given
    in user order is permuted with ``b``."""
    rng = np.random.default_rng(113)
    n = 4096
    base = scipy.sparse.diags(
        [-1.0, -0.5, 3.6, -0.5, -1.0], [-64, -1, 0, 1, 64],
        shape=(n, n), format="csr",
    )
    base = base + scipy.sparse.diags(0.3 * rng.random(n))
    p = rng.permutation(n)
    sp = base[p][:, p].tocsr().astype(np.float32)  # scrambled SPD
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    sol0, info0 = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-4, maxiter=300
    )
    sol1, info1 = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-4, maxiter=300,
        reorder="rcm",
    )
    assert info1.success
    assert info1.numsteps == info0.numsteps
    r = np.asarray(b) - sp @ np.asarray(sol1)
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(np.asarray(b)))
    np.testing.assert_allclose(
        np.asarray(sol1), np.asarray(sol0), atol=5e-4
    )
    m = min(len(info0.resnorms), len(info1.resnorms))
    np.testing.assert_allclose(
        info1.resnorms[:m], info0.resnorms[:m], rtol=2e-3
    )

    Md = 1.0 / np.asarray(sp.diagonal())
    solm, infom = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), M_diag=Md,
        tol=1e-4, maxiter=300, reorder="rcm",
    )
    assert infom.success
    rm = np.asarray(b) - sp @ np.asarray(solm)
    assert np.linalg.norm(rm) <= 1e-3 * (1 + np.linalg.norm(np.asarray(b)))


def test_sharded_csr_reorder_flips_gather_to_halo():
    """sharded_solve(reorder=) on a scrambled CSR matrix: RCM shrinks the
    bandwidth so the partition flips from all-gather to halo mode, and
    the solve matches the user-order solve step-for-step."""
    rng = np.random.default_rng(117)
    n = 1024
    base = scipy.sparse.diags(
        [-1.0, 3.1, -1.0], [-1, 0, 1], shape=(n, n), format="csr"
    )
    base = base + scipy.sparse.diags(0.2 * rng.random(n))
    p = rng.permutation(n)
    sp = base[p][:, p].tocsr()
    b = jnp.asarray(rng.standard_normal(n))

    # scrambled: columns land far from the diagonal -> gather mode
    part_scr = parallel.partition_csr(sp, 8)
    assert part_scr["mode"] == "gather"
    from krylov_tpu.ops.reorder import rcm_permutation

    perm = rcm_permutation(sp)
    part_rcm = parallel.partition_csr(sp[perm][:, perm].tocsr(), 8)
    assert part_rcm["mode"] == "halo"

    sol0, info0 = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-10, maxiter=200
    )
    sol1, info1 = parallel.sharded_solve(
        krylov_tpu.cg, sp, b, mesh=_mesh(), tol=1e-10, maxiter=200,
        reorder="auto",
    )
    assert info1.success
    assert info1.numsteps == info0.numsteps
    np.testing.assert_allclose(np.asarray(sol1), np.asarray(sol0), atol=1e-8)
    m = min(len(info0.resnorms), len(info1.resnorms))
    np.testing.assert_allclose(
        info1.resnorms[:m], info0.resnorms[:m], rtol=1e-8, atol=1e-12
    )
    r = np.asarray(b) - sp @ np.asarray(sol1)
    assert np.linalg.norm(r) <= 1e-9 * (1 + np.linalg.norm(np.asarray(b)))

    # restarted GMRES rides the same wrapper
    solg, infog = parallel.sharded_solve(
        krylov_tpu.gmres, sp, b, mesh=_mesh(), tol=1e-8, maxiter=120,
        restart=30, reorder="rcm",
    )
    assert infog.success
    rg = np.asarray(b) - sp @ np.asarray(solg)
    assert np.linalg.norm(rg) <= 1e-7 * (1 + np.linalg.norm(np.asarray(b)))

    # already-ordered matrices keep user order under "auto"
    part = parallel.partition_csr(base.tocsr(), 8)
    assert part["mode"] == "halo"
    sol2, info2 = parallel.sharded_solve(
        krylov_tpu.cg, base.tocsr(), b, mesh=_mesh(), tol=1e-10,
        maxiter=200, reorder="auto",
    )
    assert info2.success


def test_sharded_solve_complex_hpd_cg():
    """Complex HPD system row-partitioned: psum inners conjugate, the
    halo matvec carries complex data, trajectories match single-device
    (capability parity: the reference zoo's hpd problem,
    reference: tests/linear_problems.py)."""
    n = 64
    rng = np.random.default_rng(9)
    T = scipy.sparse.diags(
        [(-1 + 0.4j) * np.ones(n - 1), 3.0 * np.ones(n),
         (-1 - 0.4j) * np.ones(n - 1)],
        [-1, 0, 1], format="csr",
    )
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    sol_ref, info_ref = krylov_tpu.cg(T, b, tol=1e-12, maxiter=200)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, T, b, mesh=_mesh(), tol=1e-12, maxiter=200
    )
    assert info.success
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(
        np.asarray(sol), np.asarray(sol_ref), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(info.resnorms), np.asarray(info_ref.resnorms),
        rtol=1e-8, atol=1e-12,
    )


def test_sharded_solve_complex_unsymmetric_gmres_and_bicgstab():
    """Complex non-hermitian system through sharded GMRES (psum MGS) and
    BiCGSTAB (sharded rmatvec-capable route)."""
    n = 64
    rng = np.random.default_rng(10)
    T = scipy.sparse.diags(
        [(-1 + 0.7j) * np.ones(n - 1), (3.0 + 0.3j) * np.ones(n),
         (-0.5 - 0.2j) * np.ones(n - 1)],
        [-1, 0, 1], format="csr",
    )
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x_ref = scipy.sparse.linalg.spsolve(T.tocsc(), np.asarray(b))
    for solver in (krylov_tpu.gmres, krylov_tpu.bicgstab):
        sol, info = parallel.sharded_solve(
            solver, T, b, mesh=_mesh(), tol=1e-10, maxiter=200
        )
        assert info.success, solver.__name__
        np.testing.assert_allclose(np.asarray(sol), x_ref, atol=1e-7)


def test_sharded_banded_prime_n_pads_to_shards():
    """N=509 (prime) BANDED operator on 8 devices: unit-diagonal row
    padding (round-3 verdict item 6 — the reference accepts any N,
    reference: src/krylov/cg.py:96-113); trajectories match the
    single-device solve exactly."""
    rng = np.random.default_rng(92)
    n = 509
    coeffs = np.zeros((3, n))
    coeffs[0, 1:] = -1.0
    coeffs[1] = 3.2 + 0.5 * rng.random(n)
    coeffs[2, :-1] = -1.0
    A = stencil.BandedOperator(
        jnp.asarray(coeffs), (-1, 0, 1), hermitian=False
    )
    b = jnp.asarray(rng.standard_normal(n))

    sol_ref, info_ref = krylov_tpu.cg(A, b, tol=1e-10, maxiter=400)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert info.success
    assert sol.shape == (n,)
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(
        np.asarray(sol), np.asarray(sol_ref), atol=1e-8
    )
    m = min(len(info.resnorms), len(info_ref.resnorms))
    np.testing.assert_allclose(
        info.resnorms[:m], info_ref.resnorms[:m], rtol=1e-8, atol=1e-12
    )

    # no diagonal band at all: the pad path must ADD a unit diagonal —
    # pin the padded operator against dense block-diag(A, I) algebra
    from krylov_tpu.parallel.solve import _pad_banded

    n2 = 10
    c2 = np.zeros((2, n2))
    c2[0, 1:] = -1.0
    c2[1, :-1] = -1.0
    A2 = stencil.BandedOperator(
        jnp.asarray(c2), (-1, 1), hermitian=True
    )
    A2p = _pad_banded(A2, 6)
    assert 0 in A2p.offsets
    dense = np.zeros((n2 + 6, n2 + 6))
    dense[:n2, :n2] = np.asarray(A2.todense())
    dense[n2:, n2:] = np.eye(6)
    np.testing.assert_allclose(np.asarray(A2p.todense()), dense)


def test_sharded_bsr_prime_block_rows_pads_to_shards():
    """61 (prime) block rows of 3x3 blocks over 8 devices: identity
    block padding (round-3 verdict item 6); trajectories match the
    single-device solve."""
    rng = np.random.default_rng(93)
    nb, R = 61, 3
    n = nb * R
    blocks = scipy.sparse.diags(
        [-1.0, 2.6, -1.0], [-1, 0, 1], shape=(nb, nb), format="csr"
    )
    dense = scipy.sparse.kron(
        blocks, np.eye(R) + 0.1 * rng.random((R, R))
    ).tocsr()
    dense = (dense + dense.T).tocsr()  # SPD-ish, definitely blocked
    from krylov_tpu.ops.bsr import BSROperator

    A = BSROperator.from_scipy(dense, blocksize=(R, R))
    b = jnp.asarray(rng.standard_normal(n))

    sol_ref, info_ref = krylov_tpu.cg(dense, b, tol=1e-10, maxiter=400)
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert info.success
    assert sol.shape == (n,)
    assert info.numsteps == info_ref.numsteps
    np.testing.assert_allclose(
        np.asarray(sol), np.asarray(sol_ref), atol=1e-8
    )
    # multi-RHS through the same identity-padded path
    B = jnp.asarray(rng.standard_normal((n, 2)))
    solB, infoB = parallel.sharded_solve(
        krylov_tpu.cg, A, B, mesh=_mesh(), tol=1e-10, maxiter=400
    )
    assert infoB.success
    Rres = np.asarray(B) - dense @ np.asarray(solB)
    assert np.linalg.norm(Rres) <= 1e-8 * (1 + np.linalg.norm(np.asarray(B)))


def test_sharded_callback_monitor_grid_path():
    """sharded_solve(callback=) fires ``(k, global resnorm)`` from inside
    the SPMD while_loop, numsteps+1 times — the reference's count
    (reference: src/krylov/cg.py:119-120, 202-204), with the rank-0
    gating of the ShardMonitor contract (round-4 verdict item 6)."""
    A = stencil.poisson_2d(16, 16)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(256))
    calls = []
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=_mesh(), tol=1e-8, maxiter=300,
        callback=lambda k, rn: calls.append((int(k), float(rn))),
    )
    assert info.success
    assert len(calls) == info.numsteps + 1  # fired once per iteration + x0
    calls.sort()  # unordered delivery: k identifies the iteration
    assert [k for k, _ in calls] == list(range(info.numsteps + 1))
    rn = np.array([r for _, r in calls])
    ref = np.asarray(info.resnorms).reshape(-1)
    # the hook sees recurrence values; the explicit-residual double-check
    # may overwrite the final history entry (reference semantics)
    np.testing.assert_allclose(rn[:-1], ref[:-1], rtol=1e-12)
    assert rn[-1] <= ref[0]  # final recurrence value is sane


def test_sharded_callback_monitor_csr_path():
    """The monitor on the general (CSR shard_map) route, with a
    preconditioner in play."""
    N = 256
    sp = scipy.sparse.diags(
        [-1.0, 3.0, -1.0], [-1, 0, 1], shape=(N, N), format="csr"
    )
    b = jnp.asarray(np.random.default_rng(1).standard_normal(N))
    calls = []
    sol, info = parallel.sharded_solve(
        krylov_tpu.bicgstab, sp, b, mesh=_mesh(),
        M_diag=1.0 / np.asarray(sp.diagonal()),
        tol=1e-9, maxiter=300,
        callback=lambda k, rn: calls.append((int(k), float(rn))),
    )
    assert info.success
    assert len(calls) == info.numsteps + 1
    calls.sort()
    assert [k for k, _ in calls] == list(range(info.numsteps + 1))


def test_make_sharded_solver_matches_sharded_solve():
    """Build-once/solve-many API: trajectories are bit-identical to a
    fresh ``sharded_solve`` per call, across the grid, CSR (prime-N
    padding + M_diag) and multi-RHS routes, and the returned ``run``
    serves multiple right-hand sides."""
    rng = np.random.default_rng(0)
    mesh = _mesh()

    # grid operator, two successive RHS through one built solver
    A = stencil.poisson_2d(32, 32)
    run = parallel.make_sharded_solver(
        krylov_tpu.cg, A, mesh=mesh, tol=1e-10, maxiter=300
    )
    for seed in (1, 2):
        b = jnp.asarray(np.random.default_rng(seed).standard_normal(1024))
        sol, info = run(b)
        sol_ref, info_ref = parallel.sharded_solve(
            krylov_tpu.cg, A, b, mesh=mesh, tol=1e-10, maxiter=300
        )
        assert info.success and info.numsteps == info_ref.numsteps
        np.testing.assert_array_equal(
            np.asarray(info.resnorms), np.asarray(info_ref.resnorms)
        )
        np.testing.assert_array_equal(np.asarray(sol), np.asarray(sol_ref))

    # CSR route: prime N (unit-diagonal padding) + Jacobi M_diag
    N = 509
    sp = scipy.sparse.diags(
        [-1.0, 3.0, -1.0], [-1, 0, 1], shape=(N, N), format="csr"
    )
    dinv = 1.0 / np.asarray(sp.diagonal())
    b = jnp.asarray(rng.standard_normal(N))
    run2 = parallel.make_sharded_solver(
        krylov_tpu.bicgstab, sp, mesh=mesh, M_diag=dinv,
        tol=1e-9, maxiter=300,
    )
    sol2, info2 = run2(b)
    sol2r, info2r = parallel.sharded_solve(
        krylov_tpu.bicgstab, sp, b, mesh=mesh, M_diag=dinv,
        tol=1e-9, maxiter=300,
    )
    assert info2.numsteps == info2r.numsteps
    np.testing.assert_array_equal(
        np.asarray(info2.resnorms), np.asarray(info2r.resnorms)
    )

    # blocked RHS on the grid route (n_rhs fixes the layout at build)
    B = jnp.asarray(rng.standard_normal((1024, 2)))
    run3 = parallel.make_sharded_solver(
        krylov_tpu.cg, A, mesh=mesh, tol=1e-10, maxiter=300, n_rhs=2
    )
    sol3, info3 = run3(B)
    sol3r, info3r = parallel.sharded_solve(
        krylov_tpu.cg, A, B, mesh=mesh, tol=1e-10, maxiter=300
    )
    assert info3.numsteps == info3r.numsteps
    np.testing.assert_array_equal(
        np.asarray(info3.resnorms), np.asarray(info3r.resnorms)
    )

    # shape mismatch is rejected, restart= refused at build
    with pytest.raises(ValueError):
        run(jnp.zeros((1024, 2)))
    with pytest.raises(ValueError):
        parallel.make_sharded_solver(
            krylov_tpu.gmres, A, mesh=mesh, restart=10
        )
