"""Device-resident sparse operators.

The reference consumes scipy's CSR matvec implicitly (reference:
tests/test_solvers.py:199-209 accepts any ``A`` with ``@``).  Here sparse
matrices are first-class device-resident operators:

* :class:`CSROperator` — general sparsity: a gather of ``x`` by column
  index, an elementwise product and a ``segment_sum`` over rows.  The
  segment sum is a scatter-add, so on a GPU its order of summation (and
  with it the last bits of ``y``) may vary between runs.
* :class:`DiaOperator` — diagonal/banded (stencil) storage: SpMV is a sum of
  shifted scaled vector reads with no index traffic at all.  This is the
  preferred format for the Poisson/Laplacian benchmark family (see also the
  grid-stencil operators in :mod:`krylov_tpu.ops.stencil`).

Both are registered pytrees, so they pass through ``jit``/``while_loop`` and
can be sharded over a mesh (see :mod:`krylov_tpu.parallel`).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_pytree_node_class


@register_pytree_node_class
class CSROperator:
    """Compressed-sparse-row operator.

    ``data (nnz,), indices (nnz,), indptr (N+1,)`` plus a precomputed
    ``row_ids (nnz,)`` expansion (the CSR->COO row map) so both the matvec and
    the adjoint matvec are single segment-sum contractions:

        A  @ x = segment_sum(data * x[indices],  row_ids)
        A^H @ x = segment_sum(conj(data) * x[row_ids], indices)
    """

    def __init__(self, data, indices, indptr, shape, row_ids=None):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(shape)
        if row_ids is None:
            counts = indptr[1:] - indptr[:-1]
            row_ids = jnp.repeat(
                jnp.arange(shape[0], dtype=indices.dtype),
                counts,
                total_repeat_length=data.shape[0],
            )
        self.row_ids = row_ids

    @classmethod
    def from_scipy(cls, A, to_device=True):
        """``to_device=False`` keeps host numpy leaves so a caller
        assembling many operators can move them in ONE ``jax.device_put``
        of the enclosing pytree."""
        csr = A.tocsr()
        csr.sort_indices()
        # host-side row expansion: the jnp.repeat fallback in __init__
        # costs an XLA compile per distinct (nnz, N) shape
        row_ids = np.repeat(
            np.arange(csr.shape[0], dtype=np.int32), np.diff(csr.indptr)
        )
        conv = jnp.asarray if to_device else np.asarray
        return cls(
            conv(csr.data),
            conv(csr.indices.astype(np.int32, copy=False)),
            conv(csr.indptr.astype(np.int32, copy=False)),
            csr.shape,
            row_ids=conv(row_ids),
        )

    @classmethod
    def from_dense(cls, A):
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        indptr = np.zeros(A.shape[0] + 1, dtype=np.int32)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return cls(
            jnp.asarray(A[rows, cols]),
            jnp.asarray(cols, dtype=jnp.int32),
            jnp.asarray(indptr),
            A.shape,
            row_ids=jnp.asarray(rows, dtype=jnp.int32),
        )

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self):
        return self.data.shape[0]

    def __matmul__(self, x):
        prod = (self.data.reshape(self.data.shape + (1,) * (x.ndim - 1))) * x[
            self.indices
        ]
        return jax.ops.segment_sum(
            prod, self.row_ids, num_segments=self.shape[0], indices_are_sorted=True
        )

    matvec = __matmul__

    def rmatvec(self, x):
        prod = (
            jnp.conj(self.data).reshape(self.data.shape + (1,) * (x.ndim - 1))
        ) * x[self.row_ids]
        return jax.ops.segment_sum(prod, self.indices, num_segments=self.shape[1])

    def diagonal(self):
        mask = self.indices == self.row_ids
        return jax.ops.segment_sum(
            jnp.where(mask, self.data, 0),
            self.row_ids,
            num_segments=self.shape[0],
            indices_are_sorted=True,
        )

    def todense(self):
        out = jnp.zeros(self.shape, self.dtype)
        return out.at[self.row_ids, self.indices].add(self.data)

    def tril(self, keep_diagonal=True):
        """Lower-triangular part as a new CSROperator (for GS/SOR sweeps)."""
        mask = np.asarray(
            self.indices <= self.row_ids if keep_diagonal else self.indices < self.row_ids
        )
        return self._masked(mask)

    def triu(self, keep_diagonal=True):
        mask = np.asarray(
            self.indices >= self.row_ids if keep_diagonal else self.indices > self.row_ids
        )
        return self._masked(mask)

    def _masked(self, mask):
        data = np.asarray(self.data)[mask]
        indices = np.asarray(self.indices)[mask]
        rows = np.asarray(self.row_ids)[mask]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int32)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return CSROperator(
            jnp.asarray(data),
            jnp.asarray(indices),
            jnp.asarray(indptr),
            self.shape,
        )

    def with_diagonal(self, d):
        """Return a copy whose diagonal entries are replaced by ``d`` (SOR)."""
        on_diag = self.indices == self.row_ids
        new_data = jnp.where(on_diag, jnp.asarray(d)[self.row_ids], self.data)
        return CSROperator(new_data, self.indices, self.indptr, self.shape, self.row_ids)

    def tree_flatten(self):
        return (self.data, self.indices, self.indptr, self.row_ids), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        data, indices, indptr, row_ids = children
        return cls(data, indices, indptr, shape, row_ids)


@register_pytree_node_class
class DiaOperator:
    """Diagonal-storage (banded / stencil) operator.

    ``diags`` has shape ``(ndiag, N)``; ``offsets`` is a static tuple.  The
    matvec reads each stored diagonal once and accumulates shifted elementwise
    products — no index traffic, so the matvec is memory-bandwidth-bound.
    Scipy ``spdiags`` convention: ``diags[d, i] * x[i]`` contributes to row
    ``i - offset`` (i.e. row i reads ``diags[d, i + offset] * x[i + offset]``).
    """

    def __init__(self, diags, offsets, shape):
        self.diags = diags
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)

    @classmethod
    def from_scipy(cls, A):
        dia = A.todia()
        return cls(jnp.asarray(dia.data), tuple(int(o) for o in dia.offsets), dia.shape)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def nnz(self):
        n = self.shape[0]
        return sum(n - abs(o) for o in self.offsets)

    def __matmul__(self, x):
        n = self.shape[0]
        y = jnp.zeros(x.shape, jnp.result_type(self.diags, x))
        for d, off in enumerate(self.offsets):
            diag = self.diags[d]
            if off >= 0:
                contrib = (diag[off:] .reshape((n - off,) + (1,) * (x.ndim - 1))) * x[off:]
                y = y.at[: n - off].add(contrib)
            else:
                contrib = (diag[: n + off].reshape((n + off,) + (1,) * (x.ndim - 1))) * x[: n + off]
                y = y.at[-off:].add(contrib)
        return y

    matvec = __matmul__

    def rmatvec(self, x):
        # A^H: diagonal at +off becomes conj at -off
        n = self.shape[0]
        y = jnp.zeros(x.shape, jnp.result_type(self.diags, x))
        for d, off in enumerate(self.offsets):
            diag = jnp.conj(self.diags[d])
            if off >= 0:
                contrib = (diag[off:].reshape((n - off,) + (1,) * (x.ndim - 1))) * x[: n - off]
                y = y.at[off:].add(contrib)
            else:
                contrib = (diag[: n + off].reshape((n + off,) + (1,) * (x.ndim - 1))) * x[-off:]
                y = y.at[: n + off].add(contrib)
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return jnp.zeros(self.shape[0], self.dtype)

    def tocsr(self):
        import scipy.sparse

        sp = scipy.sparse.dia_matrix(
            (np.asarray(self.diags), np.asarray(self.offsets)), shape=self.shape
        )
        return CSROperator.from_scipy(sp)

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape = aux
        return cls(children[0], offsets, shape)
