#!/usr/bin/env python3
"""End-to-end smoke test of krylov_tpu on an NVIDIA GPU, at full size.

    python chip_smoke.py                 # one card: phases 0-5
    python chip_smoke.py --chips 4       # four cards: the sharded phase only
    python chip_smoke.py --seed 7        # other random problems

Every phase goes through the public entry points (``krylov_tpu.cg`` /
``gmres`` / ``bicgstab`` / ``qmr`` / ``cg_block`` / ``cg_stencil``,
``as_operator`` on scipy input, the multigrid / AMG / ILU / block-Jacobi
preconditioners, ``parallel.sharded_solve`` / ``make_sharded_solver``) and
compares what comes back with a plain float64 reference computed on the
host with numpy/scipy.  Problems are generated from ``--seed``.

  0  device: a GPU is required (no CPU fallback); prints the card, its
     power limit, the jax/jaxlib versions, XLA_FLAGS and the native-helper
     routes.
  1  operators against the f64 reference at full width: relative max
     error of ``A @ x`` at most 1e-5.  The device runs f32, whose rounding
     gives about sqrt(nnz per row) * 6e-8; a contraction run in TF32 would
     show about 1e-3.  CSR's ``segment_sum`` is a scatter-add, so its order
     of summation, and the last bits of ``y``, may vary between runs.
  2  compiled solves (``backend="while_loop"`` under ``jax.jit``): each must
     converge and reach an f64-recomputed relative residual of at most
     2 * tol (the forward error is printed where x* is known).
  3  TF32 guard: one f32 Jacobi-CG, 30 iterations, on the GPU; its residual
     history agrees with the same iteration in numpy f64 to 1e-4 (the
     same program on the process's CPU device is printed beside it).
  4  the eager default backend on a scipy matrix.
  5  ``cg_stencil`` reproduces ``krylov_tpu.cg``'s first 20 residuals.

Each check prints one line; the last line is one JSON object,
``{"ok": true, "device": {...}}``.  Any failed check or phase exits
non-zero.  ``--rehearse`` runs the same phases at toy sizes and allows the
CPU (for checking the script itself; its times mean nothing).

The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set,
otherwise in ``.jax_cache`` beside this script.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FULL = dict(grid=4096, csr_side=1024, irr_rows=1 << 20, bsr_nb=512,
            bsr_block=128, bsr_k=128, ilu_side=512, rhs_k=8)
SMALL = dict(grid=128, csr_side=64, irr_rows=1 << 13, bsr_nb=48,
             bsr_block=16, bsr_k=16, ilu_side=32, rhs_k=8)

OP_LIMIT = 1e-5        # phase 1: relative max error of A @ x
TF32_RTOL = 1e-4       # phase 3: GPU f32 vs f64 residual histories
STENCIL_RTOL = 1e-4    # phase 5: cg_stencil vs cg, first 20 residuals
SHARD_RTOL = 1e-3      # --chips 4: sharded vs single-device residuals
#                        (relative to max(|r_k|, 1e-3 |r_0|))


def nvidia_smi():
    """The cards' names and power limits, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e!r})"


class Report:
    """One line per check; remembers failures for the exit code."""

    def __init__(self):
        self.failures = []

    def line(self, phase, name, *, value, limit, metric, iters=None,
             compile_s=None, run_s=None, extra=""):
        ok = bool(np.isfinite(value) and value <= limit)
        fields = [f"phase {phase}", name]
        if iters is not None:
            fields.append(f"iters={iters}")
        if compile_s is not None:
            fields.append(f"compile_s={compile_s:.4f}")
        if run_s is not None:
            fields.append(f"run_s={run_s:.6f}")
        fields.append(f"{metric}={value:.4e} limit={limit:.1e}")
        if extra:
            fields.append(extra)
        fields.append("ok" if ok else "FAIL")
        print(" ".join(fields), flush=True)
        if not ok:
            self.failures.append(f"phase {phase} {name}")
        return ok

    def require(self, phase, name, cond, why):
        if not cond:
            print(f"phase {phase} {name}: FAIL {why}", flush=True)
            self.failures.append(f"phase {phase} {name}")
        return cond


def compiled(fn, *args):
    """``(output, compile seconds, run seconds)`` of ``jax.jit(fn)(*args)``;
    the run time is the second execution, ended by block_until_ready."""
    import jax

    # lower over the flat leaves: operator pytrees are rebuilt inside the
    # trace, where their constructors see real (traced) arrays
    leaves, tree = jax.tree_util.tree_flatten(args)

    def flat(*leaves):
        return fn(*jax.tree_util.tree_unflatten(tree, leaves))

    t0 = time.perf_counter()
    exe = jax.jit(flat).lower(*leaves).compile()
    t1 = time.perf_counter()
    jax.block_until_ready(exe(*leaves))
    t2 = time.perf_counter()
    out = jax.block_until_ready(exe(*leaves))
    return out, t1 - t0, time.perf_counter() - t2


def rel_max_err(got, want):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def rel_res(b, r):
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(np.ravel(r)) / np.linalg.norm(np.ravel(b)))


# ---- plain f64 references, independent of the library ---------------------

def poisson_ref(x):
    """5-point Dirichlet Laplacian on the grid, f64."""
    x = np.asarray(x, np.float64)
    y = 4.0 * x
    y[1:, :] -= x[:-1, :]
    y[:-1, :] -= x[1:, :]
    y[:, 1:] -= x[:, :-1]
    y[:, :-1] -= x[:, 1:]
    return y


def diffusion_ref(a, x):
    """Finite-volume ``-div(a grad u)``: face conductivity is the mean of
    the two cells, a wall face takes its cell's own value (Dirichlet)."""
    a = np.asarray(a, np.float64)
    x = np.asarray(x, np.float64)
    y = np.zeros_like(x)
    y[0, :] += a[0, :] * x[0, :]
    y[-1, :] += a[-1, :] * x[-1, :]
    y[:, 0] += a[:, 0] * x[:, 0]
    y[:, -1] += a[:, -1] * x[:, -1]
    d = 0.5 * (a[1:, :] + a[:-1, :]) * (x[1:, :] - x[:-1, :])
    y[1:, :] += d
    y[:-1, :] -= d
    d = 0.5 * (a[:, 1:] + a[:, :-1]) * (x[:, 1:] - x[:, :-1])
    y[:, 1:] += d
    y[:, :-1] -= d
    return y


# ---- problems ---------------------------------------------------------------

def laplacian_csr(side, center, conv=0.0):
    """5-point Laplacian on a ``side`` x ``side`` grid with Dirichlet walls,
    as scipy CSR (f32): ``center`` 4 is Poisson, 4.5 the shifted SPD
    system; ``conv`` adds a nonsymmetric convection term along the rows."""
    import scipy.sparse

    ones = np.ones(side - 1)
    Tx = scipy.sparse.diags([-(1.0 + conv) * ones, -(1.0 - conv) * ones],
                            [-1, 1])
    Ty = scipy.sparse.diags([-ones, -ones], [-1, 1])
    eye = scipy.sparse.identity(side)
    A = (scipy.sparse.kron(eye, Tx) + scipy.sparse.kron(Ty, eye)
         + center * scipy.sparse.identity(side * side))
    return A.tocsr().astype(np.float32)


def jacobi_cg_history(A, b, iters):
    """Plain f64 Jacobi-preconditioned CG: ``sqrt(<r_k, D^-1 r_k>)``."""
    A = A.astype(np.float64)
    dinv = 1.0 / A.diagonal()
    r = np.asarray(b, np.float64).copy()
    z = dinv * r
    p = z.copy()
    rho = r @ z
    hist = [np.sqrt(rho)]
    for _ in range(iters):
        Ap = A @ p
        alpha = rho / (p @ Ap)
        r -= alpha * Ap
        z = dinv * r
        rho_new = r @ z
        hist.append(np.sqrt(rho_new))
        p = z + (rho_new / rho) * p
        rho = rho_new
    return np.asarray(hist)


def irregular_csr(n, rng):
    """Row degrees 5..49, columns scattered in a 1024-wide band: no
    stencil or block structure to exploit."""
    import scipy.sparse

    row_nnz = rng.integers(5, 50, n)
    nnz = int(row_nnz.sum())
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(row_nnz)
    rows = np.repeat(np.arange(n), row_nnz)
    cols = np.clip(rows + rng.integers(-512, 512, nnz), 0, n - 1)
    return scipy.sparse.csr_matrix(
        (rng.standard_normal(nnz).astype(np.float32),
         cols.astype(np.int32), indptr), shape=(n, n),
    )


def block_tridiagonal(nb, R, rng):
    """Dense R x R blocks on the block tridiagonal, as scipy BSR (f32)."""
    import scipy.sparse

    indptr = [0]
    indices = []
    for i in range(nb):
        cols = [j for j in (i - 1, i, i + 1) if 0 <= j < nb]
        indices += cols
        indptr.append(len(indices))
    data = rng.standard_normal((len(indices), R, R)).astype(np.float32)
    sp = scipy.sparse.bsr_matrix(
        (data, np.asarray(indices), np.asarray(indptr)),
        shape=(nb * R, nb * R),
    )
    return sp, data, np.asarray(indices), np.asarray(indptr)


# ---- phases -----------------------------------------------------------------

def phase0(rehearse):
    import jax

    dev = jax.devices()[0]
    print(f"phase 0 nvidia-smi: {nvidia_smi()}", flush=True)
    if dev.platform != "gpu" and not rehearse:
        print(f"phase 0 device: FAIL no GPU: JAX's default device is "
              f"{dev.platform} ({dev.device_kind}); this smoke test needs "
              "an NVIDIA GPU and has no CPU fallback", flush=True)
        sys.exit(5)

    import jaxlib

    from krylov_tpu.ops import _native

    print(f"phase 0 device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"jaxlib={jaxlib.__version__} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
          f"cache={jax.config.jax_compilation_cache_dir} "
          f"native={_native.status()}", flush=True)
    return dev


def phase1(rep, S, rng):
    import jax.numpy as jnp

    import krylov_tpu as krylov
    from krylov_tpu.ops import BSROperator, CSROperator, stencil

    apply = lambda A, x: A @ x  # noqa: E731
    n = S["grid"]

    Ac = stencil.poisson_2d_const(n, n, dtype=np.float32)
    x = rng.standard_normal((n, n)).astype(np.float32)
    y, tc, tr = compiled(apply, Ac, jnp.asarray(x))
    rep.line(1, f"poisson_2d_const {n}x{n}", value=rel_max_err(y, poisson_ref(x)),
             limit=OP_LIMIT, metric="rel_max_err", compile_s=tc, run_s=tr)

    a = (0.5 + rng.random((n, n))).astype(np.float32)
    Av = stencil.diffusion_2d(a)
    y, tc, tr = compiled(apply, Av, jnp.asarray(x))
    rep.line(1, f"diffusion_2d {n}x{n}", value=rel_max_err(y, diffusion_ref(a, x)),
             limit=OP_LIMIT, metric="rel_max_err", compile_s=tc, run_s=tr)

    sp = irregular_csr(S["irr_rows"], rng)
    A = krylov.as_operator(sp)
    rep.require(1, "irregular CSR routing", isinstance(A, CSROperator),
                f"as_operator gave {type(A).__name__}")
    xv = rng.standard_normal(sp.shape[0]).astype(np.float32)
    y, tc, tr = compiled(apply, A, jnp.asarray(xv))
    want = sp.astype(np.float64) @ xv.astype(np.float64)
    rep.line(1, f"irregular CSR n={sp.shape[0]} nnz={sp.nnz}",
             value=rel_max_err(y, want), limit=OP_LIMIT,
             metric="rel_max_err", compile_s=tc, run_s=tr)

    nb, R, k = S["bsr_nb"], S["bsr_block"], S["bsr_k"]
    bsr, data, indices, indptr = block_tridiagonal(nb, R, rng)
    X = rng.standard_normal((nb * R, k)).astype(np.float32)
    # f64 reference: one batched block product per stored block, summed
    # into its block row
    prod = np.matmul(data.astype(np.float64),
                     X.astype(np.float64).reshape(nb, R, k)[indices])
    want = np.add.reduceat(prod, indptr[:-1], axis=0).reshape(nb * R, k)
    routed = krylov.as_operator(bsr)
    rep.require(1, "block-structured routing",
                isinstance(routed, BSROperator),
                f"as_operator gave {type(routed).__name__}")
    for tag, op in (
        (f"as_operator blocks={routed.blocksize}", routed),
        (f"blocks={(R, R)}", BSROperator.from_scipy(bsr, blocksize=(R, R))),
    ):
        y, tc, tr = compiled(apply, op, jnp.asarray(X))
        rep.line(1, f"BSR {tag} n={nb * R} k={k}", value=rel_max_err(y, want),
                 limit=OP_LIMIT, metric="rel_max_err", compile_s=tc, run_s=tr)

    side = S["csr_side"]
    lap = laplacian_csr(side, 4.5)
    bs = 64
    Mb = krylov.BlockJacobiPreconditioner.from_scipy(lap, block=bs)
    r = rng.standard_normal(lap.shape[0]).astype(np.float32)
    z, tc, tr = compiled(apply, Mb, jnp.asarray(r))
    blocks = np.stack([
        lap[i:i + bs, i:i + bs].toarray() for i in range(0, lap.shape[0], bs)
    ]).astype(np.float64)
    want = np.linalg.solve(
        blocks, r.astype(np.float64).reshape(-1, bs, 1)
    ).reshape(-1)
    rep.line(1, f"BlockJacobiPreconditioner block={bs} n={lap.shape[0]}",
             value=rel_max_err(z, want), limit=OP_LIMIT,
             metric="rel_max_err", compile_s=tc, run_s=tr)


def _solve_line(rep, name, info, resid, tol, tc, tr, extra=""):
    ok_conv = bool(np.all(np.asarray(info.success)))
    rep.line(2, name, value=resid if ok_conv else float("inf"),
             limit=2 * tol, metric="f64_rel_res",
             iters=int(np.max(np.asarray(info.numsteps))),
             compile_s=tc, run_s=tr,
             extra=f"converged={ok_conv}" + (f" {extra}" if extra else ""))


def phase2(rep, S, rng):
    import jax.numpy as jnp

    import krylov_tpu as krylov
    from krylov_tpu.ops import stencil

    grid_inner = lambda u, v: jnp.sum(u * v)  # noqa: E731
    n = S["grid"]

    # MG-preconditioned CG, manufactured solution (b = A x*, so the f32
    # attainable floor sits far below tol)
    tol = 1e-6
    Ac = stencil.poisson_2d_const(n, n, dtype=np.float32)
    t0 = time.perf_counter()
    Mmg = krylov.MultigridPreconditioner(Ac)
    setup = time.perf_counter() - t0
    xstar = rng.standard_normal((n, n)).astype(np.float32)
    b = np.asarray(Ac @ jnp.asarray(xstar))

    def mg_cg(A, M, b):
        return krylov.cg(A, b, M=M, inner=grid_inner, tol=tol, maxiter=30,
                         backend="while_loop")[1]

    info, tc, tr = compiled(mg_cg, Ac, Mmg, jnp.asarray(b))
    x = np.asarray(info.xk, np.float64)
    fwd = np.linalg.norm(x - xstar) / np.linalg.norm(xstar)
    _solve_line(rep, f"MG-CG poisson_2d_const {n}x{n}", info,
                rel_res(b, b - poisson_ref(x)), tol, tc, tr,
                f"fwd_err={fwd:.4e} setup_s={setup:.4f}")

    a = (0.5 + rng.random((n, n))).astype(np.float32)
    Av = stencil.diffusion_2d(a)
    t0 = time.perf_counter()
    Mgal = krylov.MultigridPreconditioner(Av)
    setup = time.perf_counter() - t0
    b = np.asarray(Av @ jnp.asarray(xstar))
    info, tc, tr = compiled(mg_cg, Av, Mgal, jnp.asarray(b))
    x = np.asarray(info.xk, np.float64)
    fwd = np.linalg.norm(x - xstar) / np.linalg.norm(xstar)
    _solve_line(rep, f"Galerkin-MG-CG diffusion_2d {n}x{n}", info,
                rel_res(b, b - diffusion_ref(a, x)), tol, tc, tr,
                f"fwd_err={fwd:.4e} setup_s={setup:.4f}")

    # 1M-row CSR solves: shifted Poisson (SPD), convection-diffusion
    # (nonsymmetric), unshifted Poisson (cond ~ N) for AMG
    tol = 1e-5
    side = S["csr_side"]
    lap = laplacian_csr(side, 4.5)
    lap64 = lap.astype(np.float64)
    op = krylov.as_operator(lap)
    Mj = krylov.DiagonalOperator(jnp.asarray(1.0 / lap.diagonal()))
    b = rng.standard_normal(lap.shape[0]).astype(np.float32)

    # Jacobi as the RIGHT preconditioner: the residual both solvers test
    # is then the true residual (with Ml, BiCGSTAB's reference-parity
    # mid-iteration probe measures an Ml-scaled norm instead)
    for name, solver in (("BiCGSTAB", krylov.bicgstab), ("QMR", krylov.qmr)):
        def run(A, M, b, solver=solver):
            return solver(A, b, Mr=M, tol=tol, maxiter=400,
                          backend="while_loop")[1]

        info, tc, tr = compiled(run, op, Mj, jnp.asarray(b))
        x = np.asarray(info.xk, np.float64)
        _solve_line(rep, f"{name}+Jacobi shifted-Poisson CSR n={lap.shape[0]}",
                    info, rel_res(b, b - lap64 @ x), tol, tc, tr)

    cd = laplacian_csr(side, 4.5, conv=0.4)
    opc = krylov.as_operator(cd)
    for ortho in ("mgs", "householder", "cgs"):
        def run(A, b, ortho=ortho):
            return krylov.gmres(A, b, ortho=ortho, tol=tol, maxiter=120,
                                backend="while_loop")[1]

        info, tc, tr = compiled(run, opc, jnp.asarray(b))
        x = np.asarray(info.xk, np.float64)
        _solve_line(rep, f"GMRES ortho={ortho} conv-diff CSR n={cd.shape[0]}",
                    info, rel_res(b, b - cd.astype(np.float64) @ x), tol,
                    tc, tr)

    # unshifted Poisson (cond ~ N): a manufactured solution keeps the f32
    # attainable residual (~eps ||A|| ||x|| / ||b||) well below tol
    lap0 = laplacian_csr(side, 4.0)
    op0 = krylov.as_operator(lap0)
    t0 = time.perf_counter()
    Mamg = krylov.AMGPreconditioner.from_scipy(lap0, dtype=np.float32,
                                               fine_operator=op0)
    setup = time.perf_counter() - t0
    xs = rng.standard_normal(lap0.shape[0]).astype(np.float32)
    b0 = (lap0 @ xs).astype(np.float32)

    def run_cg(A, M, b):
        return krylov.cg(A, b, M=M, tol=tol, maxiter=100,
                         backend="while_loop")[1]

    info, tc, tr = compiled(run_cg, op0, Mamg, jnp.asarray(b0))
    x = np.asarray(info.xk, np.float64)
    fwd = np.linalg.norm(x - xs) / np.linalg.norm(xs)
    _solve_line(rep, f"AMG-CG Poisson CSR n={lap0.shape[0]}", info,
                rel_res(b0, b0 - lap0.astype(np.float64) @ x), tol, tc, tr,
                f"fwd_err={fwd:.4e} levels={list(Mamg.level_sizes)} "
                f"setup_s={setup:.4f}")

    # f32 GMRES on the f32 ILU(0)-preconditioned operator stalls near
    # 4e-5 at 512^2 (the same solve in f64 reaches 1e-10), so this run
    # asks for 1e-4
    tol_ilu = 1e-4
    si = S["ilu_side"]
    cdi = laplacian_csr(si, 4.5, conv=0.4)
    t0 = time.perf_counter()
    Milu = krylov.ILUPreconditioner.from_scipy(cdi, dtype=np.float32)
    setup = time.perf_counter() - t0
    bi = rng.standard_normal(cdi.shape[0]).astype(np.float32)

    def run_ilu(A, M, b):
        return krylov.gmres(A, b, Mr=M, tol=tol_ilu, maxiter=100,
                            backend="while_loop")[1]

    info, tc, tr = compiled(run_ilu, krylov.as_operator(cdi), Milu,
                            jnp.asarray(bi))
    x = np.asarray(info.xk, np.float64)
    _solve_line(rep, f"ILU(0)-GMRES conv-diff CSR n={cdi.shape[0]}", info,
                rel_res(bi, bi - cdi.astype(np.float64) @ x), tol_ilu, tc,
                tr, f"levels={Milu.nlevels} setup_s={setup:.4f}")

    k = S["rhs_k"]
    B = rng.standard_normal((lap.shape[0], k)).astype(np.float32)
    for name, solver in (("CG", krylov.cg), ("cg_block", krylov.cg_block)):
        def run(A, M, B, solver=solver):
            return solver(A, B, M=M, tol=tol, maxiter=400,
                          backend="while_loop")[1]

        info, tc, tr = compiled(run, op, Mj, jnp.asarray(B))
        X = np.asarray(info.xk, np.float64)
        R = B - lap64 @ X
        worst = float(np.max(np.linalg.norm(R, axis=0)
                             / np.linalg.norm(B, axis=0)))
        _solve_line(rep, f"{name}+Jacobi k={k} shifted-Poisson CSR", info,
                    worst, tol, tc, tr)


def phase3(rep, S, rng):
    """TF32 guard.  The GPU's f32 history is checked against the same
    Jacobi-CG run in f64 with numpy; a contraction in TF32 would move it
    by ~1e-3, f32 rounding by ~1e-6 (30 iterations on the unshifted
    Poisson stay far above the rounding floor).  The same jitted program
    on the process's CPU device is reported beside it: XLA's CPU f32 dot
    sums a 1M-long vector with an error of order 1e-2, so that run is
    information, not the reference."""
    import jax
    import jax.numpy as jnp

    import krylov_tpu as krylov

    lap0 = laplacian_csr(S["csr_side"], 4.0)
    op = krylov.as_operator(lap0)
    Mj = krylov.DiagonalOperator(jnp.asarray(1.0 / lap0.diagonal()))
    bh = rng.standard_normal(lap0.shape[0]).astype(np.float32)
    b = jnp.asarray(bh)

    def cg30(A, M, b):
        return krylov.cg(A, b, M=M, tol=0.0, atol=0.0, maxiter=30,
                         backend="while_loop")[1].resnorms

    gpu, tc, tr = compiled(cg30, op, Mj, b)
    gpu = np.asarray(gpu, np.float64)
    ref = jacobi_cg_history(lap0, bh, 30)
    cpu_dev = jax.devices("cpu")[0]
    cpu = np.asarray(jax.jit(cg30)(*jax.device_put((op, Mj, b), cpu_dev)),
                     np.float64)
    rep.line(3, f"TF32 guard Jacobi-CG 30 it n={lap0.shape[0]} "
             f"{jax.devices()[0].platform} f32 vs numpy f64",
             value=float(np.max(np.abs(gpu - ref) / ref)), limit=TF32_RTOL,
             metric="max_rel_diff_resnorms", iters=30, compile_s=tc,
             run_s=tr,
             extra=f"cpu_f32_vs_f64={np.max(np.abs(cpu - ref) / ref):.4e} "
                   f"{jax.devices()[0].platform}_vs_cpu_f32="
                   f"{np.max(np.abs(gpu - cpu) / cpu):.4e} "
                   f"final_rel_res={gpu[-1] / gpu[0]:.4e}")


def phase4(rep, S, rng):
    import krylov_tpu as krylov

    lap = laplacian_csr(S["csr_side"], 4.5)
    b = rng.standard_normal(lap.shape[0]).astype(np.float32)
    tol = 1e-5
    M = krylov.jacobi_preconditioner(krylov.as_operator(lap))
    t0 = time.perf_counter()
    sol, info = krylov.cg(lap, b, M=M, tol=tol)
    dt = time.perf_counter() - t0
    ok = rep.require(4, "eager CG success", bool(info.success) and sol is not None,
                     "eager solve did not converge")
    x = np.asarray(info.xk, np.float64)
    rep.line(4, f"eager CG+Jacobi scipy input n={lap.shape[0]}",
             value=rel_res(b, b - lap.astype(np.float64) @ x) if ok else np.inf,
             limit=2 * tol, metric="f64_rel_res", iters=int(info.numsteps),
             run_s=dt)


def phase5(rep, S, rng):
    import jax.numpy as jnp

    import krylov_tpu as krylov
    from krylov_tpu.ops import stencil

    n = S["grid"]
    b = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    a = (0.5 + rng.random((n, n))).astype(np.float32)
    for name, A in (
        ("const", stencil.poisson_2d_const(n, n, dtype=np.float32)),
        ("variable", stencil.diffusion_2d(a)),
    ):
        def fused_free(A, b):
            return krylov.cg_stencil(A, b, tol=0.0, atol=0.0,
                                     maxiter=20)[1].resnorms

        def generic(A, b):
            return krylov.cg(A, b, inner=lambda u, v: jnp.sum(u * v),
                             tol=0.0, atol=0.0, maxiter=20,
                             backend="while_loop")[1].resnorms

        got, tc, tr = compiled(fused_free, A, b)
        want, _, _ = compiled(generic, A, b)
        got, want = np.asarray(got)[:20], np.asarray(want)[:20]
        rep.line(5, f"cg_stencil {name} {n}x{n} vs cg",
                 value=float(np.max(np.abs(got - want) / np.abs(want))),
                 limit=STENCIL_RTOL, metric="max_rel_diff_resnorms",
                 iters=20, compile_s=tc, run_s=tr)


def phase_sharded(rep, S, rng):
    """Four cards: each sharded solve against the same solve on one device."""
    import jax
    import jax.numpy as jnp

    import krylov_tpu as krylov
    from krylov_tpu import parallel
    from krylov_tpu.ops import stencil

    mesh = parallel.make_mesh()
    n_dev = mesh.shape[parallel.ROWS]
    print(f"phase 4x mesh: {mesh.shape} devices={mesh.devices.ravel().tolist()}",
          flush=True)

    def compare(name, sol, info, ref_info, x_ref, tol):
        x = sol if sol is not None else info.xk
        devs = len(x.sharding.device_set)
        rep.require("4x", f"{name} sharding", devs == n_dev,
                    f"result on {devs} device(s): {x.sharding}")
        k, k_ref = int(info.numsteps), int(ref_info.numsteps)
        rep.require("4x", f"{name} iterations", abs(k - k_ref) <= 1 and
                    bool(info.success), f"sharded {k} vs single {k_ref}, "
                    f"success={info.success}")
        # a jitted single-device Info carries the whole (maxiter + 1)
        # history buffer: keep its first numsteps + 1 entries
        m = min(20, len(info.resnorms), k_ref + 1)
        r, rr = np.asarray(info.resnorms)[:m], np.asarray(ref_info.resnorms)[:m]
        # the two programs sum in different orders, which moves an f32
        # residual norm by a few eps * r_0; once a fast solve is below
        # ~1e-3 r_0 that is no longer small against r_k, so differences
        # are measured against max(r_k, 1e-3 r_0)
        diff = float(np.max(np.abs(r - rr)
                            / np.maximum(np.abs(rr), 1e-3 * np.abs(rr[0]))))
        xd = rel_res(x_ref, np.asarray(x, np.float64) - np.asarray(x_ref))
        rep.line("4x", name, value=diff, limit=SHARD_RTOL,
                 metric="max_rel_diff_resnorms", iters=f"{k}/{k_ref}",
                 extra=f"x_rel_diff={xd:.4e} sharding={x.sharding}")

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        return out, time.perf_counter() - t0

    n = S["grid"]
    Ac = stencil.poisson_2d_const(n, n, dtype=np.float32)
    b = jnp.asarray(Ac @ jnp.asarray(
        rng.standard_normal((n, n)).astype(np.float32)))
    ref = jax.jit(lambda A, M, b: krylov.cg(
        A, b, M=M, inner=lambda u, v: jnp.sum(u * v), tol=1e-6, maxiter=30,
        backend="while_loop")[1])(Ac, krylov.MultigridPreconditioner(Ac), b)
    (sol, info), dt = timed(
        parallel.sharded_solve, krylov.cg, Ac, b, mesh=mesh, tol=1e-6,
        maxiter=30, M_factory=krylov.multigrid_factory(coupling="full"),
    )
    compare(f"sharded MG-CG poisson_2d_const {n}x{n} (first call {dt:.2f}s)",
            sol, info, ref, ref.xk, 1e-6)

    side = S["csr_side"]
    lap = laplacian_csr(side, 4.5)
    dinv = (1.0 / lap.diagonal()).astype(np.float32)
    op = krylov.as_operator(lap)
    bv = jnp.asarray(rng.standard_normal(lap.shape[0]).astype(np.float32))
    ref = jax.jit(lambda A, M, b: krylov.bicgstab(
        A, b, Ml=M, tol=1e-5, maxiter=400, backend="while_loop")[1])(
        op, krylov.DiagonalOperator(jnp.asarray(dinv)), bv)
    part = parallel.partition_csr(lap, n_dev)
    (sol, info), dt = timed(
        parallel.sharded_solve, krylov.bicgstab, lap, bv, mesh=mesh,
        M_diag=dinv, tol=1e-5, maxiter=400,
    )
    compare(f"sharded BiCGSTAB+Jacobi CSR n={lap.shape[0]} "
            f"mode={part['mode']} (first call {dt:.2f}s)",
            sol, info, ref, ref.xk, 1e-5)

    # manufactured right-hand side, as in phase 2 (f32 attainable floor)
    lap0 = laplacian_csr(side, 4.0)
    b0 = jnp.asarray(lap0 @ rng.standard_normal(lap0.shape[0]).astype(
        np.float32))
    amg = parallel.partition_amg(lap0, n_dev, dtype=np.float32)
    ref = jax.jit(lambda A, M, b: krylov.cg(
        A, b, M=M, tol=1e-5, maxiter=100, backend="while_loop")[1])(
        krylov.as_operator(lap0), amg.as_global(), b0)
    (sol, info), dt = timed(
        parallel.sharded_solve, krylov.cg, lap0, b0, mesh=mesh,
        M_partition=amg, tol=1e-5, maxiter=100,
    )
    compare(f"sharded partition_amg CG n={lap0.shape[0]} (first call {dt:.2f}s)",
            sol, info, ref, ref.xk, 1e-5)

    run = parallel.make_sharded_solver(
        krylov.cg, lap, mesh=mesh, M_diag=dinv, tol=1e-5, maxiter=400,
    )
    single = jax.jit(lambda A, M, b: krylov.cg(
        A, b, M=M, tol=1e-5, maxiter=400, backend="while_loop")[1])
    Md = krylov.DiagonalOperator(jnp.asarray(dinv))
    for i in range(3):
        bi = jnp.asarray(rng.standard_normal(lap.shape[0]).astype(np.float32))
        (sol, info), dt = timed(run, bi)
        ref = single(op, Md, bi)
        compare(f"make_sharded_solver CG+Jacobi rhs {i} ({dt:.4f}s)",
                sol, info, ref, ref.xk, 1e-5)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    p.add_argument("--rehearse", action="store_true",
                   help="toy sizes, CPU allowed (checks the script only)")
    args = p.parse_args()

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))

    dev = phase0(args.rehearse)
    S = SMALL if args.rehearse else FULL
    rep = Report()
    if args.chips == 4:
        if len(jax.devices()) != 4:
            print(f"phase 4x: FAIL needs 4 devices, have {len(jax.devices())}",
                  flush=True)
            sys.exit(6)
        phases = [("4x", phase_sharded)]
    else:
        phases = [(1, phase1), (2, phase2), (3, phase3), (4, phase4),
                  (5, phase5)]
    for i, (tag, phase) in enumerate(phases):
        t0 = time.perf_counter()
        try:
            phase(rep, S, np.random.default_rng([args.seed, i]))
        except Exception:
            traceback.print_exc()
            print(f"phase {tag}: FAIL raised (traceback on stderr)", flush=True)
            rep.failures.append(f"phase {tag} raised")
        print(f"phase {tag} wall_s={time.perf_counter() - t0:.2f}", flush=True)

    result = {
        "ok": not rep.failures,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if rep.failures:
        print("failed: " + "; ".join(rep.failures), flush=True)
    print(json.dumps(result), flush=True)
    sys.exit(0 if not rep.failures else 1)


if __name__ == "__main__":
    main()
