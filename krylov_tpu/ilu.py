"""Incomplete-LU preconditioner on level-scheduled triangular sweeps.

Extension beyond the reference (which ships no preconditioners — ``M`` is
always user-supplied, reference: src/krylov/cg.py:33-36).  Completes the
classic preconditioner suite for the NONSYMMETRIC family: use as the ``Ml``
of gmres/bicgstab/cgs/qmr.  For SPD matrices with symmetric sparsity,
``method="ilu0"`` (no pivoting, exact pattern) factors into ``L D Lᵀ``
exactly — the classical IC(0) equivalence — so it is ALSO a valid SPD
``M`` of cg/minres (tested to machine-precision symmetry); ``method=
"ilut"`` pivots and is nonsymmetric-only.

Split of labor:

* **Setup** (once, host): ``method="ilu0"`` (default) factors on the
  EXACT sparsity pattern of ``A`` with no pivoting — the factor's
  dependency-level count then equals the matrix wavefront (~2·sqrt(N) on
  2-D grids), which is what bounds both the compiled program size and the
  per-application latency.  ``method="ilut"`` delegates to
  ``scipy.sparse.linalg.spilu`` (SuperLU ILUTP: threshold fill + partial
  pivoting) for stronger factors at the price of deeper level chains.
* **Apply** (every iteration, on device): two permutation gathers (ILUT
  only) and two
  :class:`~krylov_tpu.ops.triangular.StackedTriangularSweep` sweeps —
  rows grouped host-side into dependency levels, executed as ONE
  ``lax.scan`` over padded levels (one data-parallel gather + segment-sum
  per step), so there is no sequential row loop and the compiled program
  is O(1) in the level count (the reference's ``spsolve_triangular``
  analogue, SURVEY.md §2.2).  Matrices whose factors have deep dependency
  chains are refused at setup with a clear error (``max_levels``) —
  Chebyshev/AMG are the right tools there.

ILUT apply semantics match ``SuperLU.solve`` exactly (verified in tests):
``z[perm_r] = r;  y = L⁻¹ z;  w = U⁻¹ y;  M r = w[perm_c]``.
"""

import numpy as np

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from .ops.triangular import StackedTriangularSweep, stacked_level_arrays


def _sweep(factor, lower, max_levels):
    """Build one scan-based sweep from a scipy triangular factor."""
    arrs = stacked_level_arrays(
        [factor], factor.shape[0], lower=lower, max_levels=max_levels
    )
    return StackedTriangularSweep(
        *(jnp.asarray(a[0]) for a in arrs), factor.shape[0]
    )

__all__ = ["ILUPreconditioner"]


def _ilu0_numeric_numpy(A):
    """Numpy fallback/ground truth of the ILU(0) numeric phase (one Python
    pass over the rows; each row's update is a vectorized index
    intersection)."""
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = A.data.astype(np.result_type(A.dtype, np.float32)).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        dp = np.searchsorted(cols, i)
        if dp < e - s and cols[dp] == i:
            diag_pos[i] = s + dp

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        for t in range(s, e):
            k = indices[t]
            if k >= i:
                break
            dk = diag_pos[k]
            ukk = data[dk] if dk >= 0 else 0.0
            if ukk == 0:
                ukk = 1.0  # breakdown guard (reference-style where-guard)
            lik = data[t] / ukk
            data[t] = lik
            # row i -= lik * (upper part of row k), restricted to row i's
            # own pattern (that restriction IS the "(0)" in ILU(0))
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks <= 0 or ks >= ke:
                continue
            kcols = indices[ks:ke]
            pos = np.searchsorted(cols, kcols)
            ok = (pos < cols.shape[0]) & (cols[np.minimum(pos, cols.shape[0] - 1)] == kcols)
            data[s + pos[ok]] -= lik * data[ks:ke][ok]
    return data


def _ilu0_factor(A):
    """ILU(0): incomplete LU on the exact sparsity pattern of ``A``, no
    pivoting (IKJ ordering).  Returns scipy ``(L, U)`` with unit lower
    diagonal stored explicitly.  The numeric phase runs in the native
    helper (csrc/ilu0.cpp, ~0.1 s at 1M rows) with the numpy row pass as
    fallback and ground truth."""
    import scipy.sparse

    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    from .ops._native import ilu0_factor_native

    data = ilu0_factor_native(A)
    if data is not None:
        data = data.astype(np.result_type(A.dtype, np.float32))
    else:
        data = _ilu0_numeric_numpy(A)

    row_of = np.repeat(np.arange(n), np.diff(indptr))
    low = indices < row_of
    upp = ~low
    L = scipy.sparse.csr_matrix(
        (np.concatenate([data[low], np.ones(n, data.dtype)]),
         (np.concatenate([row_of[low], np.arange(n)]),
          np.concatenate([indices[low], np.arange(n)]))),
        shape=A.shape,
    )
    U = scipy.sparse.csr_matrix(
        (data[upp], (row_of[upp], indices[upp])), shape=A.shape
    )
    # rows with a missing/zeroed diagonal solve against 1 (same guard as
    # the stationary sweeps)
    du = U.diagonal()
    if np.any(du == 0):
        U = U + scipy.sparse.diags((du == 0).astype(U.dtype))
    return L.tocsr(), U.tocsr()


@register_pytree_node_class
class ILUPreconditioner:
    """``z = M @ r`` applies one ILU solve (``M r ~= A^{-1} r``).

    Build with :meth:`from_scipy`.  ``rmatvec`` (needed by qmr's left
    preconditioner) is available when built with ``with_rmatvec=True``.
    """

    def __init__(self, lsolve, usolve, ipr, pc, adj=None):
        self._l = lsolve
        self._u = usolve
        self._ipr = ipr  # inverse row permutation (gather indices)
        self._pc = pc    # column permutation (gather indices)
        self._adj = adj  # (uH_lower_solve, lH_upper_solve, ipc, pr) | None

    @classmethod
    def from_scipy(cls, A, *, method="ilu0", drop_tol=1e-4, fill_factor=10,
                   max_levels=4096, with_rmatvec=False, dtype=None,
                   **spilu_kwargs):
        """``method="ilu0"`` (default): exact-pattern no-pivot factors —
        wavefront-shallow level chains, device cost of one application ~
        one matvec.  ``method="ilut"``: SuperLU ILUTP; ``drop_tol`` /
        ``fill_factor`` are its knobs (smaller drop_tol / larger
        fill_factor = stronger, denser, DEEPER factors).  ``dtype`` casts
        the device factors (``np.float32`` halves the sweep traffic).  ``max_levels``
        bounds the factors' dependency-level count."""
        import scipy.sparse

        if not scipy.sparse.issparse(A):
            A = scipy.sparse.csr_matrix(np.asarray(A))
        if method == "ilu0":
            L, U = _ilu0_factor(A)
            perm_r = perm_c = None
        elif method == "ilut":
            from scipy.sparse.linalg import spilu

            ilu = spilu(
                A.tocsc(), drop_tol=drop_tol, fill_factor=fill_factor,
                **spilu_kwargs,
            )
            L, U = ilu.L.tocsr(), ilu.U.tocsr()
            perm_r, perm_c = ilu.perm_r, ilu.perm_c
        else:
            raise ValueError(f"unknown method {method!r}")
        if dtype is not None:
            L, U = L.astype(dtype), U.astype(dtype)
        lsolve = _sweep(L, True, max_levels)
        usolve = _sweep(U, False, max_levels)
        adj = None
        if with_rmatvec:
            # ilu0 has identity permutations: keep them None so the
            # per-iteration apply skips the gathers entirely
            adj = (
                _sweep(U.conj().T.tocsr(), True, max_levels),
                _sweep(L.conj().T.tocsr(), False, max_levels),
                None if perm_c is None
                else jnp.asarray(np.argsort(perm_c), jnp.int32),
                None if perm_r is None
                else jnp.asarray(perm_r, jnp.int32),
            )
        return cls(
            lsolve, usolve,
            None if perm_r is None
            else jnp.asarray(np.argsort(perm_r), jnp.int32),
            None if perm_c is None
            else jnp.asarray(perm_c, jnp.int32),
            adj=adj,
        )

    @property
    def shape(self):
        return (self._l.n_local, self._l.n_local)

    @property
    def dtype(self):
        return self._l.dat.dtype

    @property
    def nlevels(self):
        """Dependency-level counts of the (L, U) sweeps."""
        return (self._l.nlevels, self._u.nlevels)

    def __matmul__(self, r):
        z = r if self._ipr is None else r[self._ipr]  # z[perm_r] = r
        w = self._u(self._l(z))
        return w if self._pc is None else w[self._pc]

    matvec = __matmul__

    def rmatvec(self, r):
        if self._adj is None:
            raise ValueError(
                "build ILUPreconditioner.from_scipy(..., with_rmatvec=True) "
                "for solvers that apply the adjoint preconditioner (qmr)"
            )
        uH, lH, ipc, pr = self._adj
        w = lH(uH(r if ipc is None else r[ipc]))
        return w if pr is None else w[pr]

    def tree_flatten(self):
        return (self._l, self._u, self._ipr, self._pc, self._adj), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)
