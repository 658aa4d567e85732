"""Profiling and observability.

The reference's only observability is the ``Info`` result and the analytic
``num_operations`` cost dictionaries (reference: src/krylov/cg.py:243-250,
gmres.py:240-247, minres.py:242-249).  This module keeps that cost model and
adds the device-side instrumentation the reference never needed:

* :data:`PEAKS` / :func:`device_peaks` — the one table of published device
  peaks, keyed by ``device_kind``; an unknown device is an error,
* :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-loadable trace of a solve,
* :func:`timed_solve` — wall-clock a solve that ends in
  ``jax.block_until_ready``,
* :func:`spmv_traffic_model` / :func:`roofline_report` — the ideal-traffic
  byte counts per operator type and the achieved-fraction-of-roofline
  summary used by bench.py.
"""

import contextlib
import os
import tempfile
import time

import jax
import numpy as np

# Published per-device peaks (dense rates, no sparsity), by jax
# ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet, SXM
# part, at its full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "source": "NVIDIA H100 data sheet (SXM)",
    },
}


def _kind(device):
    if device is None:
        device = jax.devices()[0]
    return device if isinstance(device, str) else device.device_kind


def device_peaks(device=None) -> dict:
    """Published peaks of ``device`` (a device, a ``device_kind`` string,
    or default: the first device).  Raises ``KeyError`` for a device that
    is not in :data:`PEAKS` — a made-up peak would make every roofline
    share meaningless."""
    kind = _kind(device)
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a sourced "
            f"row to krylov_tpu.profiling.PEAKS (known: {sorted(PEAKS)})"
        )
    return PEAKS[kind]


def peak_gbps(device=None) -> float:
    """Published memory bandwidth (GB/s) of ``device``; see :func:`device_peaks`."""
    return device_peaks(device)["hbm_gbps"]


@contextlib.contextmanager
def trace(logdir=None):
    """``with profiling.trace(): solve(...)`` — TensorBoard trace of a solve
    (default directory: ``krylov_tpu_trace`` under the temp directory)."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "krylov_tpu_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def timed_solve(solve_fn, *args, warmup=True, **kwargs):
    """Run ``solve_fn(*args, **kwargs)``, return ``(result, seconds)``.

    The clock stops when every array of the result is ready on the device
    (``jax.block_until_ready``); ``warmup`` runs it once first so the time
    excludes compilation.
    """
    if warmup:
        jax.block_until_ready(solve_fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = jax.block_until_ready(solve_fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def spmv_traffic_model(A, dtype=None) -> int:
    """Ideal memory bytes of one ``A @ x`` for the operator types here.

    * ConstStencilOperator: x read + y write (weights are compile-time)
    * Banded/GridStencil:  coefficient planes + x + y
    * CSR: data + indices + x gathers (counted once) + y
    * dense: matrix + x + y
    """
    itemsize = np.dtype(dtype or getattr(A, "dtype", np.float32)).itemsize
    n = A.shape[0]
    kind = type(A).__name__
    if kind == "ConstStencilOperator":
        return 2 * n * itemsize
    if hasattr(A, "coeffs2d") or hasattr(A, "coeffs"):
        ndiag = (
            A.coeffs2d.shape[0] if hasattr(A, "coeffs2d") else A.coeffs.shape[0]
        )
        return (ndiag + 2) * n * itemsize
    if hasattr(A, "indptr"):  # CSR
        nnz = int(A.nnz)
        return nnz * (itemsize + 4) + 2 * n * itemsize
    return (n * n + 2 * n) * itemsize  # dense


def roofline_report(A, seconds_per_matvec, device=None) -> dict:
    """Achieved bandwidth and fraction of roofline for one SpMV, against
    the published bandwidth of ``device`` (a device or ``device_kind``;
    default the first device) from :data:`PEAKS`."""
    bytes_ideal = spmv_traffic_model(A)
    gbps = bytes_ideal / seconds_per_matvec / 1e9
    peak = peak_gbps(device)
    return {
        "bytes_ideal": bytes_ideal,
        "achieved_gbps": gbps,
        "peak_gbps": peak,
        "fraction_of_roofline": gbps / peak,
        "nnz_per_s": float(getattr(A, "nnz", 0)) / seconds_per_matvec,
    }
