"""General-sparsity solves: scipy CSR in, device CSR underneath.

Demonstrates the three ways a user reaches the general-sparsity path:

1. implicitly — pass a scipy sparse matrix to any solver; it is converted
   to a device :class:`CSROperator` (cached per matrix),
2. explicitly — build a :class:`CSROperator` once and reuse it,
3. distributed — ``sharded_solve`` partitions the same matrix into row
   slabs over a device mesh (halo or all-gather exchange).

Run: ``python examples/sparse_csr_solve.py`` (any backend).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

import krylov_tpu as krylov
from krylov_tpu.ops import CSROperator


def irregular_spd(n, seed=0):
    """Unstructured SPD test matrix: random couplings, dominant diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(1, n), 4)
    cols = (rng.random(rows.shape[0]) * rows).astype(np.int64)
    A = scipy.sparse.coo_matrix(
        (0.3 * rng.standard_normal(rows.shape[0]), (rows, cols)),
        shape=(n, n),
    )
    A = (A + A.T).tocsr()
    A.setdiag(5.0 + rng.random(n))
    A.sum_duplicates()
    return A.astype(np.float32)


def main():
    n = 1 << 15
    A = irregular_spd(n)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    # 1. implicit: solvers accept the scipy matrix directly
    sol, info = krylov.cg(A, b, tol=1e-4, maxiter=200)
    r = np.linalg.norm(A @ np.asarray(info.xk) - np.asarray(b))
    print(f"cg(scipy csr): success={info.success} steps={info.numsteps} "
          f"|r|={r:.2e}")

    # 2. explicit CSR operator: one host->device conversion, then reuse
    op = CSROperator.from_scipy(A)
    print(f"CSR nnz={op.nnz}")
    for solver in (krylov.cg, krylov.bicgstab):
        sol, info = solver(op, b, tol=1e-4, maxiter=300)
        print(f"{solver.__name__}(CSROperator): success={info.success} "
              f"steps={info.numsteps}")

    # GS/SOR smoothers also run on large general sparsity
    # (level-scheduled triangular sweeps)
    sol, info = krylov.gauss_seidel(A, b, tol=1e-3, maxiter=30,
                                    backend="while_loop")
    print(f"gauss_seidel: success={info.success} steps={info.numsteps}")

    # 3. distributed: row slabs over the device mesh
    if jax.device_count() > 1:
        from krylov_tpu import parallel

        sol, info = parallel.sharded_solve(
            krylov.cg, A, b, mesh=parallel.make_mesh(),
            tol=1e-4, maxiter=200,
        )
        print(f"sharded cg(CSR row slabs, {jax.device_count()} devices): "
              f"success={info.success} steps={info.numsteps}")


if __name__ == "__main__":
    main()
