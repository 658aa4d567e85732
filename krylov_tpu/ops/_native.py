"""On-demand native (C++) helpers, with graceful numpy fallback.

The reference is pure Python end-to-end (SURVEY.md §2.2: zero first-party
native code); here the host-side setup passes are native where it pays:
AMG pairwise aggregation (``amg_agg.cpp``), the AMG Galerkin triple
product (``amg_rap.cpp``) and the ILU(0) factorization / triangular level
schedule (``ilu0.cpp``).

Each shared object is compiled once per machine with ``g++ -O3`` from the
committed source into the user cache dir and loaded via ctypes (no
build-system dependency, no pybind11).  Every native path has the numpy
implementation as fallback and ground truth; set ``KRYLOV_TPU_NO_NATIVE=1``
to disable natives.  :func:`status` reports which route each helper took.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")


def _cache_dir():
    base = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    d = os.path.join(base, "krylov_tpu")
    os.makedirs(d, exist_ok=True)
    return d


def _build(name, extra_flags=()):
    """Compile ``csrc/<name>.cpp`` once (keyed by its content hash) and
    return the loaded ``ctypes.CDLL``."""
    src = os.path.join(_CSRC, f"{name}.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_cache_dir(), f"_{name}_{tag}.so")
    if not os.path.exists(so):
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, f"{name}.so")
            subprocess.run(
                ["g++", "-O3", *extra_flags, "-shared", "-fPIC",
                 "-std=c++17", src, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)
    return ctypes.CDLL(so)


def status():
    """``{helper: "native" | "numpy"}`` — which route each setup helper
    takes in this process (loads them on first call)."""
    return {
        name: "native" if load() is not None else "numpy"
        for name, load in (
            ("amg_agg", _load_agg), ("amg_rap", _load_rap),
            ("ilu0", _load_ilu),
        )
    }


# ---- amg_agg.cpp: AMG pairwise-matching aggregation -----------------------

_agg_lib = None
_agg_tried = False


def _load_agg():
    global _agg_lib, _agg_tried
    if _agg_tried:
        return _agg_lib
    _agg_tried = True
    if os.environ.get("KRYLOV_TPU_NO_NATIVE"):
        return None
    try:
        # -ffp-contract=off: the sort key must be bit-identical to numpy's
        # (no FMA fusion of the final mul-subtract)
        lib = _build("amg_agg", ("-ffp-contract=off",))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.amg_pairwise_labels.restype = ctypes.c_int64
        lib.amg_pairwise_labels.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int64, i64p,
        ]
        _agg_lib = lib
    except Exception as e:  # no compiler / sandboxed fs / bad cache
        sys.stderr.write(f"krylov_tpu: native amg_agg unavailable ({e!r}); "
                         "using the numpy aggregation path\n")
        _agg_lib = None
    return _agg_lib


def amg_pairwise_labels_native(csr, theta, rounds=8):
    """Native twin of ``amg._pairwise_labels`` (label-identical; tests
    assert equality).  ``csr`` must be canonical (sorted indices, no
    duplicates); returns ``(labels, n_agg)`` or None when the native
    path is unavailable or the dtype is unsupported (complex)."""
    import numpy as np

    lib = _load_agg()
    if lib is None:
        return None
    if csr.dtype == np.float32:
        kind = 0
    elif csr.dtype == np.float64:
        kind = 1
    else:
        return None
    if not csr.has_sorted_indices:
        return None
    n = csr.shape[0]
    # scipy's int32/int64 index arrays are read directly by the kernel
    # (idx_kind dispatch) — converting 2*nnz indices to int64 per call
    # was an O(nnz) copy tax on every matching pass
    if csr.indptr.dtype == np.int32 and csr.indices.dtype == np.int32:
        idx_kind = 0
        indptr = np.ascontiguousarray(csr.indptr)
        indices = np.ascontiguousarray(csr.indices)
    else:
        idx_kind = 1
        indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(csr.indices, dtype=np.int64)
    data = np.ascontiguousarray(csr.data)
    labels = np.empty(n, dtype=np.int64)
    n_agg = lib.amg_pairwise_labels(
        n,
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        idx_kind,
        data.ctypes.data_as(ctypes.c_void_p),
        kind, float(theta), int(rounds),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_agg < 0:
        return None
    return labels, int(n_agg)


# ---- amg_rap.cpp: smoothed-aggregation Galerkin triple product ------------

_rap_lib = None
_rap_tried = False

_RAP_ALLOC_FN = ctypes.CFUNCTYPE(
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
)


def _load_rap():
    global _rap_lib, _rap_tried
    if _rap_tried:
        return _rap_lib
    _rap_tried = True
    if os.environ.get("KRYLOV_TPU_NO_NATIVE"):
        return None
    try:
        lib = _build("amg_rap")
        lib.amg_rap.restype = ctypes.c_int64
        lib.amg_rap.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), _RAP_ALLOC_FN,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _rap_lib = lib
    except Exception as e:  # no compiler / sandboxed fs / bad cache
        sys.stderr.write(f"krylov_tpu: native amg_rap unavailable ({e!r}); "
                         "using the scipy Galerkin path\n")
        _rap_lib = None
    return _rap_lib


def amg_rap_native(csr, labels, n_agg, scale=None):
    """Native Galerkin triple product ``P^H A P`` with the SA prolongator
    ``P = P_hat - diag(scale) (A P_hat)`` (``scale=None``: the tentative
    ``P_hat`` itself — plain aggregation / relabel-and-sum).

    ``csr`` must be canonical real f32/f64 CSR.  Returns the coarse
    matrix as a scipy CSR in ``csr.dtype`` with sorted indices, or None
    when the native path is unavailable (complex dtypes fall back to the
    scipy ground-truth path in ``amg._smoothed_prolongator``)."""
    import numpy as np

    lib = _load_rap()
    if lib is None:
        return None
    if csr.dtype == np.float32:
        data_kind = 0
    elif csr.dtype == np.float64:
        data_kind = 1
    else:
        return None
    n = csr.shape[0]
    if csr.indptr.dtype == np.int32 and csr.indices.dtype == np.int32:
        idx_kind = 0
        indptr = np.ascontiguousarray(csr.indptr)
        indices = np.ascontiguousarray(csr.indices)
    else:
        idx_kind = 1
        indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(csr.indices, dtype=np.int64)
    data = np.ascontiguousarray(csr.data)
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    scale64 = (
        None if scale is None
        else np.ascontiguousarray(scale, dtype=np.float64)
    )

    bufs = {}

    @_RAP_ALLOC_FN
    def _alloc(nbytes, which):
        a = np.zeros(int(nbytes), np.uint8)
        bufs[int(which)] = a
        return a.ctypes.data

    nnz_c = ctypes.c_int64()
    rc = lib.amg_rap(
        n,
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        idx_kind,
        data.ctypes.data_as(ctypes.c_void_p),
        data_kind,
        labels64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(n_agg),
        (None if scale64 is None
         else scale64.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
        _alloc,
        ctypes.byref(nnz_c),
    )
    if rc != 0:
        return None
    import scipy.sparse

    nnz = int(nnz_c.value)
    Ac = scipy.sparse.csr_matrix(
        (bufs[2].view(np.float64)[:nnz].astype(csr.dtype),
         bufs[1].view(np.int32)[:nnz],
         bufs[0].view(np.int64)),
        shape=(int(n_agg), int(n_agg)),
    )
    Ac.has_sorted_indices = True  # rows emitted sorted by the kernel
    return Ac


# ---- ilu0.cpp: incomplete-LU setup helpers --------------------------------

_ilu_lib = None
_ilu_tried = False


def _load_ilu():
    global _ilu_lib, _ilu_tried
    if _ilu_tried:
        return _ilu_lib
    _ilu_tried = True
    if os.environ.get("KRYLOV_TPU_NO_NATIVE"):
        return None
    try:
        lib = _build("ilu0")
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ilu0_factor.restype = ctypes.c_int64
        lib.ilu0_factor.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.POINTER(ctypes.c_double),
        ]
        lib.tri_levels.restype = ctypes.c_int64
        lib.tri_levels.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p,
        ]
        _ilu_lib = lib
    except Exception as e:  # no compiler / sandboxed fs / bad cache
        sys.stderr.write(f"krylov_tpu: native ilu0 unavailable ({e!r}); "
                         "using the numpy setup path\n")
        _ilu_lib = None
    return _ilu_lib


def ilu0_factor_native(csr):
    """Native in-place ILU(0) numerics; returns the factored ``data``
    (float64) or None when the native path is unavailable.  ``csr`` must
    be canonical (sorted indices)."""
    import numpy as np

    lib = _load_ilu()
    if lib is None or np.iscomplexobj(csr.data):
        # the C kernel is real-f64; complex matrices take the numpy path
        return None
    n = csr.shape[0]
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int64)
    data = np.ascontiguousarray(csr.data, dtype=np.float64).copy()
    rc = lib.ilu0_factor(
        n,
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return data if rc == 0 else None


def tri_levels_native(sp_csr, lower):
    """Native dependency-level assignment; returns the per-row level
    array (int64) or None when the native path is unavailable."""
    import numpy as np

    lib = _load_ilu()
    if lib is None:
        return None
    n = sp_csr.shape[0]
    indptr = np.ascontiguousarray(sp_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(sp_csr.indices, dtype=np.int64)
    level = np.zeros(n, dtype=np.int64)
    lib.tri_levels(
        n,
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if lower else 0,
        level.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return level
