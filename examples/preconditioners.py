"""Tour of the preconditioner suite on one hard-ish problem each.

    python examples/preconditioners.py            # single device
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/preconditioners.py        # + the sharded section

The reference ships no preconditioners (``M`` is always user-supplied,
reference: src/krylov/cg.py:33-36); everything here is an extension.  Rough guidance printed at the end of each section:

* pointwise Jacobi — free, helps only diagonal scaling;
* block Jacobi — one batched matmul; line blocks kill anisotropy;
* Chebyshev polynomial — zero reductions, great when sharded;
* ILU(0) — the classic for nonsymmetric (gmres/bicgstab/qmr);
* geometric multigrid / AMG — mesh-independent iteration counts;
* sharded: M_diag / M_factory / M_partition (block-Jacobi, ILU-Schwarz,
  distributed AMG) plug into the same sharded_solve call.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import jax
import numpy as np
import scipy.sparse

import krylov_tpu as krylov


def poisson2d(n, eps=1.0, pe=0.0, dtype=np.float64):
    """-eps*u_xx - u_yy (+ pe*u_x): anisotropic / convective 2-D grid."""
    h = 1.0 / (n + 1)
    Tx = scipy.sparse.diags(
        [-eps - pe * h / 2, 2 * eps, -eps + pe * h / 2], [-1, 0, 1],
        shape=(n, n),
    )
    Ty = scipy.sparse.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = scipy.sparse.identity(n)
    return (
        scipy.sparse.kron(I, Tx) + scipy.sparse.kron(Ty, I)
    ).tocsr().astype(dtype)


def main():
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)  # f64 parity on the CPU
    rng = np.random.default_rng(0)
    n = 48
    N = n * n

    # ---- SPD, anisotropic: point vs block (line) Jacobi vs AMG --------
    A = poisson2d(n, eps=100.0)
    b = rng.standard_normal(N)
    _, plain = krylov.cg(A, b, tol=1e-8, maxiter=2000,
                         backend="while_loop")
    _, ptj = krylov.cg(
        A, b, tol=1e-8, M=krylov.jacobi_preconditioner(A), maxiter=2000,
        backend="while_loop",
    )
    Mbj = krylov.BlockJacobiPreconditioner.from_scipy(A, block=n)
    _, bj = krylov.cg(A, b, tol=1e-8, M=Mbj, backend="while_loop")
    Mamg = krylov.AMGPreconditioner.from_scipy(A)
    _, amg = krylov.cg(A, b, tol=1e-8, M=Mamg, backend="while_loop")
    print(
        f"100:1 anisotropic Poisson {n}x{n}  CG iterations — "
        f"plain: {plain.numsteps}, jacobi: {ptj.numsteps}, "
        f"line-block-jacobi: {bj.numsteps}, amg: {amg.numsteps}"
    )

    # ---- nonsymmetric convection-diffusion: ILU(0) --------------------
    C = poisson2d(n, pe=30.0)
    _, g0 = krylov.gmres(C, b, tol=1e-8, maxiter=400,
                         backend="while_loop")
    Milu = krylov.ILUPreconditioner.from_scipy(C)
    _, g1 = krylov.gmres(C, b, tol=1e-8, Ml=Milu, backend="while_loop",
                         maxiter=200)
    _, b1 = krylov.bicgstab(C, b, tol=1e-8, Ml=Milu, backend="while_loop",
                            maxiter=200)
    print(
        f"convection-diffusion  GMRES plain: {g0.numsteps}, "
        f"GMRES+ILU(0): {g1.numsteps}, BiCGSTAB+ILU(0): {b1.numsteps}"
    )

    # ---- sharded: the same matrix over a row-partitioned mesh ---------
    if jax.device_count() >= 8:
        from krylov_tpu import parallel

        mesh = parallel.make_mesh(8)
        part_amg = parallel.partition_amg(A, 8)
        _, samg = parallel.sharded_solve(
            krylov.cg, A, b, mesh=mesh, tol=1e-8, M_partition=part_amg
        )
        part_ilu = parallel.partition_ilu0(C, 8)
        _, silu = parallel.sharded_solve(
            krylov.bicgstab, C, b, mesh=mesh, tol=1e-8,
            M_partition=part_ilu, maxiter=200,
        )
        print(
            f"sharded (8 devices)  CG+distributed-AMG: {samg.numsteps}, "
            f"BiCGSTAB+ILU-Schwarz: {silu.numsteps}"
        )
    else:
        print("(sharded section skipped: fewer than 8 devices)")


if __name__ == "__main__":
    main()
