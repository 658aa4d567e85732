"""Two-process ``jax.distributed`` CPU smoke test.

Exercises the multi-host path (``krylov_tpu.parallel.multihost``) without a
pod: spawns two local processes, each with 2 virtual CPU devices, connects
them through ``jax.distributed.initialize`` (coordinator on localhost), and
runs

1. a process-spanning ``(rows,)`` mesh over all 4 global devices,
2. a shard_map'd psum + halo ``ppermute`` across the process boundary,
3. a full ``sharded_solve`` CG on a global array built with
   ``jax.make_array_from_callback``.

Run:  ``python tools/multiprocess_smoke.py``  (parent spawns the workers and
checks both exit codes and the psum/residual values they print).

CPU only, by design: both workers pin ``jax_platforms`` to the CPU, so the
script never opens a GPU (a JAX process reserves most of a card's memory;
two processes on one card would fail).  Real multi-host jobs pass the
coordinator explicitly to ``multihost.initialize``.
"""

import json
import os
import subprocess
import sys

PORT = 47123
N_PROC = 2
DEV_PER_PROC = 2


def worker(pid: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    import numpy as np

    from krylov_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    assert jax.process_count() == N_PROC, jax.process_count()
    assert jax.device_count() == N_PROC * DEV_PER_PROC

    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = multihost.global_mesh()
    n_rows = mesh.shape["rows"]
    assert n_rows == N_PROC * DEV_PER_PROC

    # global array spanning both processes
    n = 16 * n_rows
    rng = np.random.default_rng(0)  # identical stream on both processes
    host_b = rng.standard_normal(n)
    sharding = NamedSharding(mesh, P("rows"))
    b = jax.make_array_from_callback(
        (n,), sharding, lambda idx: host_b[idx]
    )

    # 1. psum across the process boundary
    def local_norm2(b_l):
        return lax.psum(jnp.sum(b_l * b_l), "rows")

    norm2 = jax.jit(
        jax.shard_map(
            local_norm2, mesh=mesh, in_specs=P("rows"), out_specs=P(),
        )
    )(b)
    want = float(np.sum(host_b * host_b))
    got = float(np.asarray(norm2))
    assert abs(got - want) < 1e-8 * (1 + want), (got, want)

    # 2. halo ppermute crossing the process boundary: neighbor shift
    def shift_right(b_l):
        idx = lax.axis_index("rows")
        src_dst = [(i, (i + 1) % n_rows) for i in range(n_rows)]
        return lax.ppermute(b_l, "rows", src_dst)

    shifted = jax.jit(
        jax.shard_map(
            shift_right, mesh=mesh, in_specs=P("rows"), out_specs=P("rows"),
        )
    )(b)
    got_s = np.asarray(multihost_utils.process_allgather(
        shifted, tiled=True
    ))
    want_s = np.roll(host_b.reshape(n_rows, -1), 1, axis=0).reshape(-1)
    assert np.allclose(got_s, want_s), "ppermute mismatch"

    # 3. full sharded CG across processes
    import krylov_tpu
    from krylov_tpu import parallel
    from krylov_tpu.ops import stencil

    A = stencil.poisson_2d(n_rows * 2, 8)  # banded path, N = 16 * n_rows
    sol, info = parallel.sharded_solve(
        krylov_tpu.cg, A, b, mesh=mesh, tol=1e-10, maxiter=200
    )
    x = np.asarray(
        multihost_utils.process_allgather(
            info.xk, tiled=True
        )
    )
    # residual check against the host operator
    r = host_b - np.asarray(A @ jnp.asarray(x))
    relres = float(np.linalg.norm(r) / np.linalg.norm(host_b))
    print(json.dumps({
        "process": pid,
        "processes": jax.process_count(),
        "devices": jax.device_count(),
        "psum_ok": True,
        "ppermute_ok": True,
        "cg_success": bool(info.success),
        "cg_relres": relres,
    }), flush=True)
    assert info.success and relres < 1e-9


def main() -> None:
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(N_PROC)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("{"):
                print(line)
    print(json.dumps({
        "verdict": "PASS" if ok else "FAIL",
        "returncodes": [p.returncode for p in procs],
    }))
    if not ok:
        for pid, out in enumerate(outs):
            sys.stderr.write(f"--- worker {pid} ---\n{out}\n")
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
    else:
        main()
