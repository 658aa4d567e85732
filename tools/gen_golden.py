"""Generate golden residual-trajectory fixtures by RUNNING the reference
library at /root/reference (numerical ground truth for parity tests).

The fixtures record, for every (solver, problem, option-set): the residual
history, success flag, step count, and solution — the same quantities the
reference's own regression tests pin (reference: tests/test_*.py golden
tables).  Our test suite then checks this library against these within the
reference tolerances.

Run:  python tools/gen_golden.py   ->  tests/fixtures/golden.json
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, "/root/reference/src")

# numpy 2.x removed find_common_type, which the reference (written for
# numpy 1.x) uses; shim it for fixture generation only.
if not hasattr(np, "find_common_type"):
    def _find_common_type(array_types, scalar_types):
        return np.result_type(*array_types, *scalar_types)

    np.find_common_type = _find_common_type

import contextlib
import io

import krylov  # the reference library


def _problems():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    import linear_problems as lp

    return {
        "spd_dense_5": lp.spd_dense((5,)),
        "spd_dense_5x1": lp.spd_dense((5, 1)),
        "spd_dense_5x3": lp.spd_dense((5, 3)),
        "spd_rhs_0": lp.spd_rhs_0((5,)),
        "spd_rhs_0sol0": lp.spd_rhs_0sol0(),
        "hpd": lp.hpd(),
        "symmetric_indefinite": lp.symmetric_indefinite(),
        "hermitian_indefinite": lp.hermitian_indefinite(),
        "real_unsymmetric": lp.real_unsymmetric(),
        "complex_unsymmetric": lp.complex_unsymmetric(),
    }


SOLVER_PROBLEMS = {
    "cg": [
        "spd_dense_5", "spd_dense_5x1", "spd_dense_5x3", "spd_rhs_0",
        "spd_rhs_0sol0", "hpd", "symmetric_indefinite", "hermitian_indefinite",
    ],
    "minres": [
        "spd_dense_5", "spd_dense_5x1", "spd_dense_5x3", "spd_rhs_0",
        "spd_rhs_0sol0", "hpd", "symmetric_indefinite", "hermitian_indefinite",
    ],
    "gmres": [
        "spd_dense_5", "spd_dense_5x1", "spd_dense_5x3", "spd_rhs_0",
        "spd_rhs_0sol0", "hpd", "symmetric_indefinite", "hermitian_indefinite",
        "real_unsymmetric", "complex_unsymmetric",
    ],
    "symmlq": ["spd_dense_5", "symmetric_indefinite"],
    "bicg": [
        "spd_dense_5", "hpd", "symmetric_indefinite", "hermitian_indefinite",
        "real_unsymmetric", "complex_unsymmetric",
    ],
    "bicgstab": [
        "spd_dense_5", "hpd", "symmetric_indefinite", "hermitian_indefinite",
        "real_unsymmetric", "complex_unsymmetric",
    ],
    "cgs": ["spd_dense_5", "hpd", "real_unsymmetric", "complex_unsymmetric"],
    "qmr": [
        "spd_dense_5", "hpd", "symmetric_indefinite", "hermitian_indefinite",
        "real_unsymmetric", "complex_unsymmetric",
    ],
    "cgr": ["spd_dense_5", "hpd", "symmetric_indefinite", "hermitian_indefinite"],
    "gcr": [
        "spd_dense_5", "hpd", "symmetric_indefinite", "hermitian_indefinite",
        "real_unsymmetric", "complex_unsymmetric",
    ],
    "cgne": ["spd_dense_5", "real_unsymmetric"],
    "cgnr": ["spd_dense_5", "real_unsymmetric"],
}


def _encode(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return {"re": x.real.tolist(), "im": x.imag.tolist()}
    return x.tolist()


def run_case(fn, A, b, **kwargs):
    # The reference's cgr/gcr/symmlq never apply the maxiter=None -> N
    # default (upstream bug: unconverged solves loop forever), so always pass
    # maxiter explicitly.  For the solvers that do default it, this is a
    # no-op: their default is also N.
    kwargs.setdefault("maxiter", A.shape[0])
    with contextlib.redirect_stdout(io.StringIO()):  # reference gmres has stray prints
        sol, info = fn(A, b, **kwargs)
    return {
        "success": bool(info.success),
        "numsteps": int(info.numsteps),
        "resnorms": np.asarray(info.resnorms).tolist(),
        "xk": _encode(info.xk),
    }


def main():
    problems = _problems()
    out = {}

    for name, prob_names in SOLVER_PROBLEMS.items():
        fn = getattr(krylov, name)
        for pname in prob_names:
            A, b = problems[pname]
            out[f"{name}/{pname}"] = run_case(fn, A, b, tol=1e-7)

    # gmres orthogonalization variants
    for pname in ["spd_dense_5", "real_unsymmetric", "complex_unsymmetric", "hpd"]:
        A, b = problems[pname]
        out[f"gmres_mgs2/{pname}"] = run_case(krylov.gmres, A, b, tol=1e-7, ortho="mgs2")
    for pname in ["spd_dense_5", "hermitian_indefinite", "real_unsymmetric"]:
        A, b = problems[pname]
        out[f"gmres_householder/{pname}"] = run_case(
            krylov.gmres, A, b, tol=1e-7, ortho="householder"
        )

    # preconditioned variants on a slightly larger SPD problem
    n = 10
    a = np.linspace(1.0, 2.0, n)
    a[-1] = 1e-2
    A10 = np.diag(a)
    b10 = np.ones(n)
    Mdiag = np.diag(1.0 / np.sqrt(np.abs(a)))
    for name in ["cg", "minres", "gmres"]:
        fn = getattr(krylov, name)
        out[f"{name}_M/spd10"] = run_case(fn, A10, b10, tol=1e-7, M=Mdiag)
        out[f"{name}_Ml/spd10"] = run_case(fn, A10, b10, tol=1e-7, Ml=Mdiag)
    for name in ["minres", "gmres"]:
        fn = getattr(krylov, name)
        out[f"{name}_Mr/spd10"] = run_case(fn, A10, b10, tol=1e-7, Mr=Mdiag)
    out["bicgstab_MlMr/spd10"] = run_case(
        krylov.bicgstab, A10, b10, tol=1e-7, Ml=Mdiag, Mr=Mdiag
    )
    out["qmr_MlMr/spd10"] = run_case(krylov.qmr, A10, b10, tol=1e-7, Ml=Mdiag, Mr=Mdiag)
    out["bicg_M/spd10"] = run_case(krylov.bicg, A10, b10, tol=1e-7, M=Mdiag)
    out["cgs_M/spd10"] = run_case(krylov.cgs, A10, b10, tol=1e-7, M=Mdiag)
    out["cgr_M/spd10"] = run_case(krylov.cgr, A10, b10, tol=1e-7, M=Mdiag)

    # custom (weighted) inner product
    w = 10.0 / np.arange(1, n + 1)

    def winner(x, y):
        return np.einsum("i...,i...->...", x.conj(), w.reshape(-1, *([1] * (x.ndim - 1))) * y)

    for name in ["cg", "minres", "gmres"]:
        fn = getattr(krylov, name)
        out[f"{name}_winner/spd10"] = run_case(fn, A10, b10, tol=1e-7, inner=winner)

    # chebyshev + stationary methods
    A5, b5 = problems["spd_dense_5"]
    out["chebyshev/spd5"] = run_case(
        krylov.chebyshev, A5, b5, eigenvalue_estimates=(1e-2, 1.75),
        tol=1e-7, maxiter=5,
    )
    out["richardson/spd5"] = run_case(krylov.richardson, A5, b5, tol=1e-7, maxiter=5)
    out["richardson_w/spd5"] = run_case(
        krylov.richardson, A5, b5, omega=0.9, tol=1e-7, maxiter=5
    )
    # diagonal spd: one-step convergence family
    out["jacobi/spd5"] = run_case(krylov.jacobi, A5, b5, tol=1e-7, maxiter=5)
    out["gauss_seidel/spd5"] = run_case(krylov.gauss_seidel, A5, b5, tol=1e-7, maxiter=5)
    out["sor/spd5"] = run_case(krylov.sor, A5, b5, omega=1.0, tol=1e-7, maxiter=5)
    out["ssor/spd5"] = run_case(krylov.ssor, A5, b5, omega=1.0, tol=1e-7, maxiter=5)

    # non-diagonal SPD for a real triangular-sweep trajectory
    rng = np.random.RandomState(0)
    L = np.tril(rng.rand(6, 6), -1) * 0.1
    Asym = L + L.T + np.diag(np.arange(2.0, 8.0))
    bsym = np.ones(6)
    out["jacobi/sym6"] = run_case(krylov.jacobi, Asym, bsym, tol=1e-7, maxiter=20)
    out["gauss_seidel/sym6"] = run_case(krylov.gauss_seidel, Asym, bsym, tol=1e-7, maxiter=20)
    out["gauss_seidel_upper/sym6"] = run_case(
        krylov.gauss_seidel, Asym, bsym, lower=False, tol=1e-7, maxiter=20
    )
    out["sor/sym6"] = run_case(krylov.sor, Asym, bsym, omega=1.2, tol=1e-7, maxiter=20)
    out["ssor/sym6"] = run_case(krylov.ssor, Asym, bsym, omega=1.2, tol=1e-7, maxiter=20)
    out["richardson/sym6"] = run_case(
        krylov.richardson, Asym, bsym, omega=0.2, tol=1e-7, maxiter=20
    )
    out["chebyshev/sym6"] = run_case(
        krylov.chebyshev, Asym, bsym, eigenvalue_estimates=(1.8, 8.3),
        tol=1e-7, maxiter=20,
    )
    # chebyshev with jacobi-style preconditioner
    out["chebyshev_M/sym6"] = run_case(
        krylov.chebyshev, Asym, bsym, eigenvalue_estimates=(0.9, 1.1),
        M=np.diag(1.0 / np.diag(Asym)), tol=1e-7, maxiter=20,
    )

    # the README / test_solvers 100x100 headline problem
    n = 100
    A100 = np.diag([1.0e-3] + list(range(2, n + 1)))
    b100 = np.ones(n)
    for name in ["cg", "gmres", "minres"]:
        fn = getattr(krylov, name)
        out[f"{name}/diag100"] = run_case(fn, A100, b100)

    os.makedirs(os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures"), exist_ok=True)
    path = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures", "golden.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {len(out)} cases to {path}")


if __name__ == "__main__":
    main()
