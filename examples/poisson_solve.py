"""Solve a 2-D Poisson problem three ways on one device.

    python examples/poisson_solve.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import jax.numpy as jnp
import numpy as np

import krylov_tpu as krylov
from krylov_tpu import profiling
from krylov_tpu.ops import stencil


def main():
    nx = 128
    rng = np.random.default_rng(0)

    # 1. variable-coefficient grid stencil
    A = stencil.poisson_2d(nx, nx, dtype=np.float32)
    b = jnp.asarray(rng.standard_normal(nx * nx), jnp.float32)
    (sol, info), secs = profiling.timed_solve(
        krylov.cg, A, b, M=krylov.jacobi_preconditioner(A),
        tol=1e-4, maxiter=1500, backend="while_loop"
    )
    print(f"grid CG:   {info.numsteps} iters, {secs*1e3:.1f} ms, "
          f"final resnorm {float(info.resnorms[-1]):.3e}")

    # 2. constant-coefficient stencil with the grid-vector CG driver
    Ac = stencil.poisson_2d_const(nx, nx, dtype=np.float32)
    (sol, info), secs = profiling.timed_solve(
        krylov.cg_stencil, Ac, b, tol=1e-4, maxiter=1500
    )
    print(f"stencil CG: {info.numsteps} iters, {secs*1e3:.1f} ms")

    # 3. restarted GMRES on the same system
    (sol, info), secs = profiling.timed_solve(
        krylov.gmres, A, b, restart=100, tol=1e-4, maxiter=600,
        backend="while_loop",
    )
    print(f"GMRES(m):  {info.numsteps} iters, {secs*1e3:.1f} ms")


if __name__ == "__main__":
    main()
