"""Operator layer (L0).

Structural typing for anything applied with ``@`` plus a small zoo of concrete
operators.  Capability parity with the reference operator protocol
(reference: src/krylov/_helpers.py:14-90), re-designed for JAX:

* every concrete operator here is a **registered pytree**, so operators flow
  through ``jit`` / ``lax.while_loop`` / ``shard_map`` as ordinary arguments —
  this is what lets one solver implementation run eagerly on host *and*
  fully compiled on one device or a device mesh;
* ``rmatvec`` (adjoint matvec, needed by BiCG/QMR/CGNE/CGNR) is provided
  functionally instead of via cached transposed copies.
"""

from typing import Protocol

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_pytree_node_class

from . import _precision as prec


class LinearOperator(Protocol):
    def __matmul__(self, x): ...


class RLinearOperator(LinearOperator, Protocol):
    def rmatvec(self, x): ...


@register_pytree_node_class
class Identity:
    """No-op operator, default preconditioner.

    dtype is ``uint8`` so it never widens the common dtype of a product
    (behavior parity: reference src/krylov/_helpers.py:26-36).
    """

    dtype = np.dtype("uint8")

    def __matmul__(self, x):
        return x

    matvec = __matmul__

    def rmatvec(self, x):
        return x

    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls()


@register_pytree_node_class
class Product:
    """Lazy operator composition, applied right-to-left.

    ``Product(Ml, A, Mr) @ x == Ml @ (A @ (Mr @ x))`` (behavior parity:
    reference src/krylov/_helpers.py:39-48).
    """

    def __init__(self, *operators):
        self.operators = operators
        self.dtype = np.result_type(*(op.dtype for op in operators))

    def __matmul__(self, x):
        out = x
        for op in self.operators[::-1]:
            out = op @ out
        return out

    def tree_flatten(self):
        return self.operators, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@register_pytree_node_class
class MatrixOperator:
    """Dense-matrix operator backed by a device array.

    The matvec is an XLA GEMM/GEMV at full f32 precision; the adjoint is
    computed as ``conj(A.T @ conj(x))`` with no cached adjoint copy
    (capability parity: reference src/krylov/_helpers.py:51-80).
    """

    def __init__(self, a):
        self.a = a

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def shape(self):
        return self.a.shape

    def __matmul__(self, x):
        return prec.matmul(self.a, x)

    matvec = __matmul__

    def rmatvec(self, x):
        """y = A^H @ x."""
        return jnp.conj(prec.matmul(self.a.T, jnp.conj(x)))

    def diagonal(self):
        return jnp.diagonal(self.a)

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@register_pytree_node_class
class DiagonalOperator:
    """Diagonal operator ``diag(d)`` — the Jacobi preconditioner shape.

    Elementwise multiply, so it shards trivially with the vectors (used by
    ``parallel.sharded_solve(..., M_diag=...)``) and works with any vector
    shape (flat, multi-RHS, grid-shaped).
    """

    def __init__(self, d):
        self.d = d

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def shape(self):
        n = int(np.prod(self.d.shape))
        return (n, n)

    def __matmul__(self, x):
        if x.ndim > self.d.ndim:  # multi-RHS trailing dims
            return self.d.reshape(self.d.shape + (1,) * (x.ndim - self.d.ndim)) * x
        return self.d * x

    matvec = __matmul__

    def rmatvec(self, x):
        if x.ndim > self.d.ndim:
            return jnp.conj(
                self.d.reshape(self.d.shape + (1,) * (x.ndim - self.d.ndim))
            ) * x
        return jnp.conj(self.d) * x

    def diagonal(self):
        return self.d.reshape(-1)

    def tree_flatten(self):
        return (self.d,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def jacobi_preconditioner(A):
    """``M = diag(A)^-1`` as a :class:`DiagonalOperator` (guarding zeros)."""
    d = jnp.asarray(A.diagonal() if hasattr(A, "diagonal") else jnp.diagonal(A))
    return DiagonalOperator(jnp.where(d != 0, 1.0 / d, 1.0))


class CallableOperatorWrapper:
    """Wraps an arbitrary object that implements ``__matmul__``.

    Used for duck-typed user operators (e.g. scipy LinearOperator or any
    object with ``@``); eager-mode only since the callable may not be
    traceable.  ``rmatvec`` delegates if available, otherwise tries the cached
    conjugate transpose (capability parity: reference
    src/krylov/_helpers.py:51-90).
    """

    def __init__(self, obj):
        self._obj = obj
        self._adj = None
        self.shape = getattr(obj, "shape", None)
        self._dtype = getattr(obj, "dtype", None)

    @property
    def dtype(self):
        if self._dtype is None:
            # infer LAZILY from a probe matvec (so solves that never read
            # the dtype pay nothing) -- e.g. a complex custom operator must
            # not silently get a float64 common dtype
            if self.shape is not None:
                try:
                    n = int(self.shape[-1])
                    probe = self._obj @ np.zeros(n)
                    self._dtype = np.result_type(
                        getattr(probe, "dtype", float)
                    )
                except Exception:
                    pass
            if self._dtype is None:
                self._dtype = np.dtype(float)
        return self._dtype

    def __matmul__(self, x):
        return self._obj @ x

    matvec = __matmul__

    def rmatvec(self, x):
        if hasattr(self._obj, "rmatvec"):
            return self._obj.rmatvec(x)
        if self._adj is None:
            self._adj = self._obj.T.conj()
        return self._adj @ x

    def diagonal(self):
        return self._obj.diagonal()


# auto-routed operators (CSR / BSR conversions) are cached per scipy object:
# as_operator runs on every solve call and each build is an O(nnz) host-side
# pass.  The cache key includes a content fingerprint so in-place mutation
# of the scipy matrix (A.data *= ... in a time-stepping re-solve loop)
# invalidates the cached operator instead of silently serving stale values.
_ROUTE_CACHE = {}


def _sparse_fingerprint(A):
    """Content fingerprint of a scipy sparse matrix.

    CRC of the FULL data/index buffers plus nnz and shape — every in-place
    edit (``A.data[i] = v``, ``A[i, j] = v`` on an existing entry, index
    rewrites) flips it.  zlib's C-speed CRC makes this ~GB/s, well under
    1% of the O(nnz) conversion it guards even on the largest matrices;
    sampling was tried first and silently missed single-element edits.
    """
    import zlib

    parts = [A.shape, getattr(A, "nnz", None)]
    for name in ("data", "indices", "indptr", "row", "col", "offsets"):
        buf = getattr(A, name, None)
        if buf is None or getattr(buf, "size", 0) == 0:
            continue
        arr = np.asarray(buf)
        if arr.dtype == object:  # lil/dok store ragged object arrays
            continue
        arr = np.ascontiguousarray(arr)
        crc = zlib.crc32(memoryview(arr).cast("B"))
        parts.append((name, arr.dtype.str, crc))
    return hash(tuple(parts))


def _route_cached(A, build):
    """Return ``build(A)`` memoized on ``(id(A), fingerprint(A))``.

    Entries self-evict when the scipy matrix is garbage collected (the
    weakref callback below) — a loop building a fresh matrix per time step
    must not accumulate dead entries each strongly holding O(nnz) device
    buffers.
    """
    import weakref

    fp = _sparse_fingerprint(A)
    key = id(A)
    hit = _ROUTE_CACHE.get(key)
    if hit is not None and hit[0]() is A and hit[1] == fp:
        return hit[2]
    op = build(A)
    try:
        def _evict(ref, _key=key, _cache=_ROUTE_CACHE):
            # _cache bound as a default: at interpreter shutdown module
            # globals are cleared before the matrices are finalized, and
            # a global lookup here would raise inside the weakref callback
            if _cache is not None:
                ent = _cache.get(_key)
                if ent is not None and ent[0] is ref:
                    del _cache[_key]

        _ROUTE_CACHE[key] = (weakref.ref(A, _evict), fp, op)
    except TypeError:
        pass
    return op


def as_operator(A):
    """Normalize anything with ``@`` into an operator this library can drive.

    * jnp/np ndarrays -> :class:`MatrixOperator` (device GEMV + functional
      adjoint),
    * scipy sparse matrices -> :class:`krylov_tpu.ops.CSROperator` (on-device
      CSR), or :class:`krylov_tpu.ops.BSROperator` when the matrix is
      block-structured,
    * objects already exposing ``rmatvec`` are used as-is,
    * any other object with ``__matmul__`` is wrapped.

    (Capability parity: reference src/krylov/_helpers.py:83-90.)
    """
    if isinstance(A, (jax.Array, np.ndarray)) or (
        hasattr(A, "__array__") and hasattr(A, "ndim") and not hasattr(A, "tocsr")
    ):
        return MatrixOperator(jnp.asarray(A))

    if hasattr(A, "rmatvec"):
        # already a full operator (ours, or e.g. scipy LinearOperator)
        return A

    if hasattr(A, "tocsr"):  # scipy sparse, without importing scipy here
        return _route_cached(A, _route_scipy_sparse)

    if not hasattr(A, "__matmul__"):
        raise ValueError(f"Unknown linear operator A = {A}")

    return CallableOperatorWrapper(A)


def _route_scipy_sparse(A):
    """Pick the sparse operator backend for a scipy matrix (uncached)."""
    from .ops.bsr import BSROperator, detect_blocksize
    from .ops.sparse import CSROperator

    bs = detect_blocksize(A)
    if bs is not None:
        # block-structured: dense-block SpMM streams no per-entry indices
        return BSROperator.from_scipy(A, blocksize=bs)
    return CSROperator.from_scipy(A)


@register_pytree_node_class
class ChebyshevPreconditioner:
    """Polynomial preconditioner ``M r ~= A^{-1} r`` of fixed degree.

    Runs ``degree`` steps of the Chebyshev semi-iteration (the same
    recurrence as :func:`krylov_tpu.chebyshev`, from a zero initial guess)
    entirely with matvecs — no inner products, hence NO reductions: when
    sharded, a degree-m application costs m halo exchanges but zero
    allreduces, shifting the compute/latency balance of outer Krylov
    iterations (one CG iteration then does m+1 matvecs of work per 2
    psums).  Extension beyond the reference; pairs with
    :func:`krylov_tpu.utils.estimate_spectrum` for the interval.

    The induced polynomial is SPD-preserving on ``[lmin, lmax]`` (it
    approximates 1/lambda positively), so it is a valid CG/MINRES ``M``.
    """

    def __init__(self, A, interval, degree=8):
        self.A = as_operator(A)
        self.lmin, self.lmax = float(interval[0]), float(interval[1])
        self.degree = int(degree)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return getattr(self.A, "dtype", np.dtype(float))

    def __matmul__(self, r):
        d = (self.lmax + self.lmin) / 2.0
        c = (self.lmax - self.lmin) / 2.0
        x = jnp.zeros_like(r)
        p = jnp.zeros_like(r)
        rk = r
        alpha_prev = 0.0
        for k in range(self.degree):
            factor = 0.25 if k > 1 else 0.5
            beta = 0.0 if k == 0 else factor * (c * alpha_prev) ** 2
            alpha = 1.0 / (d - (beta / alpha_prev if k else 0.0))
            p = rk + beta * p
            x = x + alpha * p
            rk = rk - alpha * jnp.asarray(self.A @ p)
            alpha_prev = alpha
        return x

    matvec = __matmul__

    def rmatvec(self, r):
        # polynomial in a Hermitian A is Hermitian
        return self @ r

    def tree_flatten(self):
        return (self.A,), (self.lmin, self.lmax, self.degree)

    @classmethod
    def tree_unflatten(cls, aux, children):
        lmin, lmax, degree = aux
        return cls(children[0], (lmin, lmax), degree)
