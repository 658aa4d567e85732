"""Single-GPU benchmark: the library's operators and solves against the card.

    python bench.py [--seed N]

Prints ONE JSON line.  The headline is the 5-point variable-coefficient
stencil SpMV at 4096^2 (16.7M rows), as achieved memory bandwidth under
the 7N-word streaming model (five coefficient planes + x + y; a 67 MB
vector does not fit the 50 MB L2), with ``vs_baseline = value / (0.8 *
peak)``.  Beside it, measured in the same process:

* the card's copy bandwidth (a large streaming read + write) and a large
  bf16 matrix product, the ceilings every other number is read against;
* each operator the library runs on the GPU, as time, bytes moved under
  its byte model, and that rate as a share of the measured copy rate:
  constant-coefficient stencil (2N words), unfused ``cg_stencil`` per
  iteration (~10N / ~15N words), one V(2,2) multigrid cycle, CSR SpMV on a
  1M-row irregular matrix (``nnz * 8 + 3N * 4`` bytes), and BSR SpMM at
  128 x 128 blocks with k = 128 (TFLOP/s) next to the same matrix as CSR;
* time to tolerance of the compiled solvers (MG-CG, BiCGSTAB, QMR, GMRES
  with three orthogonalizations, AMG-CG, Jacobi-CG).

Timing: every measurement ends in ``jax.block_until_ready``.  Chained
operators run K applications inside one compiled ``lax.fori_loop`` (K is
traced, so one compile serves every K) and report the least-squares slope
over several K, which drops the fixed launch cost; whole solves and single
applications report the best of a few runs.  Compilation is excluded.
The bench needs a GPU whose ``device_kind`` has a row in
``krylov_tpu.profiling.PEAKS``; anything else is an error.
"""

import argparse
import json
import os
import time
from functools import partial

import numpy as np

from chip_smoke import (
    REPO, block_tridiagonal, irregular_csr, laplacian_csr, nvidia_smi,
)


def _chain_slope(step, op, x, Ks=(4, 8, 16, 32), reps=3):
    """Seconds per application of ``u -> step(op, u)`` (slope of
    best-of-``reps`` wall time over the chain lengths ``Ks``).  ``op`` is
    a jit argument, never a baked-in constant."""
    import jax
    from jax import lax

    @jax.jit
    def chain(op, x, K):
        return lax.fori_loop(0, K, lambda i, u: step(op, u), x)

    jax.block_until_ready(chain(op, x, Ks[0]))
    ts = []
    for K in Ks:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chain(op, x, K))
            best = min(best, time.perf_counter() - t0)
        ts.append(best)
    slope = float(np.polyfit(np.asarray(Ks, float), np.asarray(ts), 1)[0])
    if not slope > 0:
        raise RuntimeError(f"non-physical slope {slope} from {ts}")
    return slope


def _best(fn, *args, reps=3):
    """Best-of-``reps`` seconds of ``fn(*args)`` (already compiled)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX's default device is "
            f"{dev.platform} ({dev.device_kind})"
        )

    import jax.numpy as jnp

    import krylov_tpu as krylov
    from krylov_tpu import profiling
    from krylov_tpu.ops import BSROperator, stencil

    peaks = profiling.device_peaks(dev)
    peak_gbps = peaks["hbm_gbps"]
    rng = np.random.default_rng(args.seed)
    out = {}

    # ---- ceilings measured in this run ---------------------------------
    big = jnp.asarray(rng.standard_normal(1 << 28), jnp.float32)  # 1 GiB
    t = _chain_slope(lambda c, u: u * c + 1e-3, 0.999, big, Ks=(2, 4, 8, 16))
    copy_gbps = 2 * big.nbytes / t / 1e9
    out["copy_gbps"] = copy_gbps
    del big
    nm = 8192
    a = jnp.asarray(rng.standard_normal((nm, nm)) / np.sqrt(nm), jnp.bfloat16)
    t, _ = _best(jax.jit(lambda a, c: a @ c), a, a, reps=5)
    out["matmul_bf16_tflops"] = 2 * nm ** 3 / t / 1e12
    del a

    def roofline(tag, seconds, nbytes):
        gbps = nbytes / seconds / 1e9
        out[f"{tag}_us"] = seconds * 1e6
        out[f"{tag}_gbps"] = gbps
        out[f"{tag}_of_copy"] = gbps / copy_gbps
        return gbps

    # ---- stencil operators at 4096^2 -------------------------------------
    n = 4096
    N = n * n
    w = 4
    coeff = (0.5 + rng.random((n, n))).astype(np.float32)
    Av = stencil.diffusion_2d(coeff)
    # scaled so K chained applications stay O(1) in f32
    Av_s = stencil.GridStencilOperator(
        Av.coeffs2d / (8 * coeff.max()), Av.offsets, Av.ny
    )
    x = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    matvec = lambda A, u: A @ u  # noqa: E731
    t = _chain_slope(matvec, Av_s, x)
    gbps = roofline("stencil_var", t, 7 * N * w)

    offs, ws = stencil._laplace_offsets(2)
    Ac_s = stencil.ConstStencilOperator(
        (n, n), offs, tuple(v / 8 for v in ws), dtype=np.float32
    )
    t = _chain_slope(matvec, Ac_s, x)
    roofline("stencil_const", t, 2 * N * w)

    # unfused cg_stencil: marginal seconds per iteration over maxiter
    Ac = stencil.poisson_2d_const(n, n, dtype=np.float32)
    for tag, A, words in (("cg_stencil_const", Ac, 10),
                          ("cg_stencil_var", Av, 15)):
        ts, its = [], (40, 80, 120, 160)
        for mi in its:
            f = jax.jit(partial(
                lambda A, b, mi: krylov.cg_stencil(
                    A, b, tol=0.0, atol=0.0, maxiter=mi)[1].resnorms,
                mi=mi))
            ts.append(_best(f, A, x)[0])
        t = float(np.polyfit(np.asarray(its, float), np.asarray(ts), 1)[0])
        roofline(f"{tag}_iter", t, words * N * w)

    # one V(2,2) multigrid cycle (fine level ~17.5N words, x 4/3 levels)
    Mmg = krylov.MultigridPreconditioner(Ac)
    t, _ = _best(jax.jit(lambda M, r: M @ r), Mmg, x, reps=5)
    roofline("mg_vcycle", t, int(17.5 * 4 / 3 * N) * w)

    # ---- CSR and BSR -----------------------------------------------------
    sp = irregular_csr(1 << 20, rng)
    A = krylov.as_operator(sp)
    A_s = type(A)(A.data / 60, A.indices, A.indptr, A.shape, A.row_ids)
    xv = jnp.asarray(rng.standard_normal(sp.shape[0]), jnp.float32)
    t = _chain_slope(matvec, A_s, xv)
    roofline("csr_irregular", t, sp.nnz * 8 + 3 * sp.shape[0] * w)
    out["csr_irregular_gnnz_per_s"] = sp.nnz / t / 1e9

    nb, R, k = 512, 128, 128
    bsr, *_ = block_tridiagonal(nb, R, rng)
    X = jnp.asarray(rng.standard_normal((nb * R, k)), jnp.float32)
    flops = 2 * bsr.nnz * k
    for tag, op in (
        ("bsr128", BSROperator.from_scipy(bsr, blocksize=(R, R))),
        ("bsr_routed", krylov.as_operator(bsr)),
        ("bsr_as_csr", krylov.ops.CSROperator.from_scipy(bsr.tocsr())),
    ):
        t, _ = _best(jax.jit(lambda A, X: A @ X), op, X, reps=5)
        out[f"{tag}_spmm_us"] = t * 1e6
        out[f"{tag}_spmm_tflops"] = flops / t / 1e12
    out["bsr_routed_blocksize"] = list(krylov.as_operator(bsr).blocksize)

    # ---- compiled solves: time to tolerance ------------------------------
    def solve_time(tag, solver, op, b, tol, maxiter, prec=None, **kw):
        """``prec = (name, preconditioner)`` rides in as a jit argument;
        ``kw`` are static solver options."""
        name, M = prec if prec is not None else ("M", None)

        def run(op, M, b):
            pk = {} if M is None else {name: M}
            return solver(op, b, tol=tol, maxiter=maxiter,
                          backend="while_loop", **pk, **kw)[1]

        t, info = _best(jax.jit(run), op, M, b, reps=3)
        out[f"{tag}_ms"] = t * 1e3
        out[f"{tag}_iters"] = int(info.numsteps)
        out[f"{tag}_converged"] = bool(info.success)

    xstar = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    solve_time("cg_mg", krylov.cg, Ac, Ac @ xstar, 1e-6, 30,
               prec=("M", Mmg), inner=lambda u, v: jnp.sum(u * v))

    side = 1024
    lap = laplacian_csr(side, 4.5)
    op = krylov.as_operator(lap)
    Mj = krylov.DiagonalOperator(jnp.asarray(1.0 / lap.diagonal()))
    b = jnp.asarray(rng.standard_normal(side * side), jnp.float32)
    solve_time("bicgstab", krylov.bicgstab, op, b, 1e-5, 400, ("Mr", Mj))
    solve_time("qmr", krylov.qmr, op, b, 1e-5, 400, ("Mr", Mj))
    opc = krylov.as_operator(laplacian_csr(side, 4.5, conv=0.4))
    for ortho in ("mgs", "householder", "cgs"):
        solve_time(f"gmres_{ortho}", krylov.gmres, opc, b, 1e-5, 120,
                   ortho=ortho)

    # unshifted Poisson (cond ~ N): a manufactured right-hand side keeps
    # the f32 attainable residual below tol
    lap0 = laplacian_csr(side, 4.0)
    op0 = krylov.as_operator(lap0)
    xs = rng.standard_normal(side * side).astype(np.float32)
    b0 = jnp.asarray(lap0 @ xs)
    t0 = time.perf_counter()
    Mamg = krylov.AMGPreconditioner.from_scipy(
        lap0, dtype=np.float32, fine_operator=op0)
    out["amg_setup_s"] = time.perf_counter() - t0
    out["amg_levels"] = list(Mamg.level_sizes)
    solve_time("cg_amg", krylov.cg, op0, b0, 1e-5, 100, ("M", Mamg))
    Mj0 = krylov.DiagonalOperator(jnp.asarray(1.0 / lap0.diagonal()))
    solve_time("cg_jacobi", krylov.cg, op0, b0, 1e-5, 4000, ("M", Mj0))

    payload = {
        "metric": "spmv_poisson2d_hbm_bandwidth",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / (0.8 * peak_gbps),
        "device": dev.device_kind,
        "card": nvidia_smi(),
        "peak_gbps": peak_gbps,
        "peak_bf16_tflops": peaks["bf16_tflops"],
        "peak_source": peaks["source"],
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "jax": jax.__version__,
        "n_rows": N,
        **out,
    }
    bad = [k for k, v in payload.items()
           if isinstance(v, float) and not (np.isfinite(v) and v > 0)]
    if bad:
        raise RuntimeError(f"bench refuses to emit non-physical {bad}")
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
