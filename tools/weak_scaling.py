"""Weak-scaling harness: nnz/s for sharded CG on 2-D Poisson.

Per BASELINE.md: weak-scaling efficiency (nnz/s per chip vs 1-chip) measured
at 1 chip / 1 host / N hosts, target >= 75% at 2+ hosts.  Run on every host
of the job::

    python tools/weak_scaling.py --rows-per-device 4194304 --iters 50

Prints one JSON line on process 0.  Problem size scales with the device
count (weak scaling): each device owns ``rows_per_device`` rows of the grid.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
import json

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-device", type=int, default=1 << 22)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--ny", type=int, default=4096)
    p.add_argument(
        "--solver", default="cg",
        choices=["cg", "cg_pipelined", "cg_block"],
        help="cg_pipelined fuses each iteration's scalars into ONE psum; "
        "cg_block amortizes reductions over a block of RHS columns",
    )
    p.add_argument(
        "--block-rhs", type=int, default=4,
        help="RHS columns for --solver cg_block",
    )
    p.add_argument(
        "--operator", default="grid",
        choices=["grid", "csr", "bsr"],
        help="sharded operator format under test: the grid-stencil fast "
        "path (default), the general-sparsity CSR row partition, or the "
        "block-sparse (BSR) route",
    )
    p.add_argument("--multihost", action="store_true")
    p.add_argument(
        "--virtual-devices", type=int, default=0,
        help="run on N virtual CPU devices (a rehearsal of the sharding; "
        "its times are CPU times)",
    )
    args = p.parse_args()

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual_devices}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.multihost:
        from krylov_tpu.parallel import multihost

        multihost.initialize()

    import jax
    import jax.numpy as jnp

    import krylov_tpu
    from krylov_tpu import parallel, profiling
    from krylov_tpu.ops import stencil

    n_dev = jax.device_count()
    ny = args.ny
    rows_per_dev = args.rows_per_device // ny * ny  # multiple of ny
    nx = (rows_per_dev * n_dev) // ny
    N = nx * ny

    rng = np.random.default_rng(0)
    nnz_true = None
    if args.operator == "grid":
        A = stencil.poisson_2d(nx, ny, dtype=np.float32)
        nnz_true = int(A.nnz)
    elif args.operator == "csr":
        import scipy.sparse

        sp = scipy.sparse.diags(
            [-1.0, -1.0, 4.0, -1.0, -1.0], [-ny, -1, 0, 1, ny],
            shape=(N, N), format="csr", dtype=np.float32,
        )
        nnz_true = int(sp.nnz)
        A = sp  # sharded_solve partitions the scipy matrix itself
    else:  # bsr: block-tridiagonal, 8x8 dense blocks
        import scipy.sparse

        from krylov_tpu.ops.bsr import BSROperator

        bs = 8
        nb = N // bs
        blocks = scipy.sparse.diags(
            [-1.0, 2.5, -1.0], [-1, 0, 1], shape=(nb, nb), format="csr"
        )
        dense_blk = np.eye(bs) + 0.05
        sp = scipy.sparse.kron(blocks, dense_blk).tocsr().astype(np.float32)
        nnz_true = int(sp.nnz)
        A = BSROperator.from_scipy(sp, blocksize=(bs, bs))
    solver = getattr(krylov_tpu, args.solver)
    if args.solver == "cg_block":
        b = jnp.asarray(
            rng.standard_normal((N, args.block_rhs)), jnp.float32
        )
    else:
        b = jnp.asarray(rng.standard_normal(N), jnp.float32)
    mesh = parallel.make_mesh()

    (sol, info), dt = profiling.timed_solve(  # warm-up run compiles
        parallel.sharded_solve, solver, A, b, mesh=mesh, tol=0.0, atol=0.0,
        maxiter=args.iters,
    )

    nnz = nnz_true
    if args.solver == "cg_block":
        nnz *= args.block_rhs  # effective work: one SpMM over k columns
    per_iter = dt / args.iters
    out = {
        "metric": f"weak_scaling_{args.solver}"
        + ("" if args.operator == "grid" else f"_{args.operator}"),
        "solver": args.solver,
        "operator": args.operator,
        "device": jax.devices()[0].device_kind,
        "devices": n_dev,
        "processes": jax.process_count(),
        "n_rows": N,
        "nnz": nnz,
        "iters": args.iters,
        "s_per_iter": round(per_iter, 6),
        "nnz_per_s": round(nnz / per_iter, 1),
        "nnz_per_s_per_device": round(nnz / per_iter / n_dev, 1),
    }
    if jax.process_index() == 0:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
