"""Distributed AMG (parallel/amg.py) over 8 virtual devices.

No reference counterpart (the reference ships neither preconditioners nor a
distribution layer — reference: src/krylov/cg.py:33-36, SURVEY.md §2.3).
Correctness is pinned three ways: against a direct solve, against the
collective-free single-device twin (trajectory parity), and against the
unpreconditioned iteration count."""

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg

import krylov_tpu
from krylov_tpu.parallel import make_mesh, partition_amg, sharded_solve
from krylov_tpu.parallel.csr import pad_unit_diagonal


def _poisson2d(n, dtype=np.float64):
    I = scipy.sparse.identity(n, dtype=dtype)
    T = scipy.sparse.diags(
        [-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), dtype=dtype
    )
    return (scipy.sparse.kron(I, T) + scipy.sparse.kron(T, I)).tocsr()


# 31*31 = 961: prime to 8, so the fine level zero-pads to 968
N_SIDE = 31
A = _poisson2d(N_SIDE)
N = A.shape[0]
RNG = np.random.default_rng(7)
B1 = RNG.standard_normal(N)
X_DIRECT = scipy.sparse.linalg.spsolve(A.tocsc(), B1)


def test_amg_cg_converges_fast_and_matches_direct():
    part = partition_amg(A, 8)
    assert part.n_pad == N + ((-N) % 8)
    sol, info = sharded_solve(
        krylov_tpu.cg, A, B1, mesh=make_mesh(8), tol=1e-9,
        M_partition=part,
    )
    assert info.success
    # plain CG needs ~100 iterations on this problem (see
    # test_sharded_solve_csr_* in test_parallel.py); the V-cycle
    # collapses that by an order of magnitude
    assert info.numsteps <= 20
    assert np.max(np.abs(np.asarray(sol) - X_DIRECT)) < 1e-6


def test_amg_trajectory_matches_global_twin():
    """The distributed cycle IS the single-device cycle: psum / psum_scatter
    / all_gather only change the reduction order."""
    part = partition_amg(A, 8)
    _, info_sh = sharded_solve(
        krylov_tpu.cg, A, B1, mesh=make_mesh(8), tol=1e-9,
        M_partition=part,
    )
    pad = part.n_pad - N
    A_pad = pad_unit_diagonal(A, pad)
    b_pad = np.concatenate([B1, np.zeros(pad)])
    _, info_tw = krylov_tpu.cg(
        A_pad, b_pad, tol=1e-9, M=part.as_global(), backend="while_loop"
    )
    assert info_tw.numsteps == info_sh.numsteps
    r_sh = np.asarray(info_sh.resnorms)
    r_tw = np.asarray(info_tw.resnorms)
    np.testing.assert_allclose(r_sh, r_tw, rtol=1e-7)


def test_amg_two_sharded_levels_chebyshev_multirhs():
    """psum_scatter/all_gather crossing between two sharded levels, the
    Chebyshev smoother, and blocked (N, k) right-hand sides together."""
    part = partition_amg(
        A, 8, n_sharded_levels=2, coarse_size=60, smoother="chebyshev"
    )
    assert part.n_sharded_levels == 2
    Bk = RNG.standard_normal((N, 3))
    sol, info = sharded_solve(
        krylov_tpu.cg, A, Bk, mesh=make_mesh(8), tol=1e-9,
        M_partition=part,
    )
    assert info.success
    assert info.numsteps <= 20
    X_ref = scipy.sparse.linalg.spsolve(A.tocsc(), Bk)
    assert np.max(np.abs(np.asarray(sol) - X_ref)) < 1e-6


def test_amg_left_preconditions_bicgstab():
    """Two-sided solvers take the cycle through their Ml slot (the
    sharded_solve prec_param fallback)."""
    part = partition_amg(A, 8)
    sol, info = sharded_solve(
        krylov_tpu.bicgstab, A, B1, mesh=make_mesh(8), tol=1e-9,
        M_partition=part,
    )
    assert info.success
    assert info.numsteps <= 15
    assert np.max(np.abs(np.asarray(sol) - X_DIRECT)) < 1e-5


def test_amg_partition_validation():
    part = partition_amg(A, 8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sharded_solve(
            krylov_tpu.cg, A, B1, M_partition=part, M_diag=np.ones(N)
        )
    with pytest.raises(ValueError, match="reorder"):
        sharded_solve(
            krylov_tpu.cg, A, B1, M_partition=part, reorder="rcm"
        )
    with pytest.raises(ValueError, match="shards"):
        sharded_solve(
            krylov_tpu.cg, A, B1, mesh=make_mesh(4), M_partition=part
        )
    with pytest.raises(ValueError, match="smoother"):
        partition_amg(A, 8, smoother="sor")


def test_amg_over_f32_csr_operator_fine_level():
    """The cycle's fine-level smoother is whatever operator the solve
    shards — here a device CSR operator in f32, partitioned by the solve
    itself; both paddings keep padded entries at exactly zero, so the
    combination is consistent."""
    from krylov_tpu.ops.sparse import CSROperator

    A32 = A.astype(np.float32)
    op = CSROperator.from_scipy(A32)
    part = partition_amg(A32, 8)
    b32 = B1.astype(np.float32)
    sol, info = sharded_solve(
        krylov_tpu.cg, op, b32, mesh=make_mesh(8), tol=1e-4,
        M_partition=part,
    )
    assert info.success
    assert info.numsteps <= 20
    r = np.asarray(b32) - A @ np.asarray(sol)
    assert np.linalg.norm(r) <= 1e-3 * (1 + np.linalg.norm(B1))


def test_amg_stalled_coarsening_degenerates_to_smoothing():
    """A diagonal matrix has an empty strength graph: the partition
    degenerates to sharded Jacobi smoothing, which solves it outright."""
    D = scipy.sparse.diags(np.linspace(1.0, 3.0, N)).tocsr()
    part = partition_amg(D, 8)
    sol, info = sharded_solve(
        krylov_tpu.cg, D, B1, mesh=make_mesh(8), tol=1e-10,
        M_partition=part,
    )
    assert info.success
    assert info.numsteps <= 12
    assert np.max(np.abs(np.asarray(sol) - B1 / D.diagonal())) < 1e-8


def test_amg_with_rhs_axis_data_parallelism():
    """M_partition composes with shard_rhs: a (rows=4, rhs=2) mesh splits
    RHS columns over the rhs axis while the cycle's psum stays on rows."""
    part = partition_amg(A, 4)
    Bk = RNG.standard_normal((N, 4))
    sol, info = sharded_solve(
        krylov_tpu.cg, A, Bk, mesh=make_mesh(4, 2), shard_rhs=True,
        tol=1e-9, M_partition=part,
    )
    assert info.success
    assert info.numsteps <= 25
    X_ref = scipy.sparse.linalg.spsolve(A.tocsc(), Bk)
    assert np.max(np.abs(np.asarray(sol) - X_ref)) < 1e-6
