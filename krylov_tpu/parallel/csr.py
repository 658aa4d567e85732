"""Row-partitioned CSR operator for a device mesh.

General-sparsity counterpart of :class:`ShardedBandedOperator` (no reference
counterpart — SURVEY.md §2.3).  The global matrix is split into contiguous
row slabs on host (:func:`partition_csr`); each shard stores its rows in
COO-ish form padded to a common nnz so the stacked arrays shard cleanly over
the ``rows`` mesh axis.

Two communication strategies, chosen automatically from the sparsity pattern:

* ``"halo"`` — every off-shard column lies within ``h`` rows of the shard
  boundary (true for any banded/PDE matrix): column indices are pre-remapped
  to an extended local vector ``[left halo | local | right halo]`` and the
  matvec does the same two-``ppermute`` halo exchange as the banded operator,
  then one ``segment_sum`` contraction.
* ``"gather"`` — arbitrary sparsity: ``lax.all_gather`` the full iterate
  (tiled) and contract against global columns.  The adjoint matvec scatters
  into a full-length vector and ``psum_scatter``s it back — the
  reduce-scatter dual of the all-gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.tree_util import register_pytree_node_class

from .mesh import ROWS
from .banded import _identity_perm_shift


def pad_unit_diagonal(A, pad):
    """Append ``pad`` unit-diagonal rows/cols to a scipy CSR matrix.

    Zero coupling to real rows: padded entries of every solver vector start
    at zero and stay exactly zero (identity rows map 0 -> 0, padded columns
    are never read by real rows), so Krylov trajectories are bit-identical
    to the unpadded problem — and diagonal-dividing solvers/smoothers divide
    by 1 at padded rows instead of 0/0 = NaN."""
    import scipy.sparse

    if pad == 0:
        # copy so the canonicalizing sort never mutates the caller's
        # matrix and downstream holders (e.g. AMGPartition.padded_matrix)
        # never alias user data
        A = A.tocsr().copy()
        A.sort_indices()
        return A
    n0, m0 = A.shape
    A = A.copy()
    A.resize((n0 + pad, m0 + pad))
    eye_pad = scipy.sparse.csr_matrix(
        (
            np.ones(pad, A.dtype),
            (np.arange(n0, n0 + pad), np.arange(m0, m0 + pad)),
        ),
        shape=A.shape,
    )
    A = (A + eye_pad).tocsr()
    A.sort_indices()
    return A


def partition_csr(A, n_shards):
    """Split a CSR matrix into ``n_shards`` contiguous row slabs (host side).

    ``A`` is a scipy sparse matrix or :class:`krylov_tpu.ops.CSROperator`.
    Returns a dict of stacked numpy arrays (leading axis = shard) plus static
    metadata; feed the arrays through ``shard_map`` with spec
    ``P('rows', None)`` and build a :class:`ShardedCSROperator` inside.
    """
    import scipy.sparse

    if hasattr(A, "todense") and not scipy.sparse.issparse(A):
        # krylov_tpu CSROperator
        A = scipy.sparse.csr_matrix(
            (np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)),
            shape=A.shape,
        )
    A = A.tocsr()
    A.sort_indices()
    N = A.shape[0]
    pad = (-N) % n_shards
    if pad:
        A = pad_unit_diagonal(A, pad)
        N = N + pad
    n_local = N // n_shards

    # per-shard COO with global columns
    datas, cols, rows = [], [], []
    h = 0  # halo width: max distance of any column outside the owning slab
    for s in range(n_shards):
        r0, r1 = s * n_local, (s + 1) * n_local
        blk = A[r0:r1].tocoo()
        datas.append(blk.data)
        cols.append(blk.col)
        rows.append(blk.row)
        if blk.nnz:
            h = max(h, int(max(r0 - blk.col.min(), blk.col.max() + 1 - r1, 0)))

    mode = "halo" if h <= n_local else "gather"
    nnz_max = max(len(d) for d in datas)

    S = n_shards
    data = np.zeros((S, nnz_max), dtype=A.dtype)
    col = np.zeros((S, nnz_max), dtype=np.int32)
    row = np.zeros((S, nnz_max), dtype=np.int32)
    for s in range(S):
        k = len(datas[s])
        data[s, :k] = datas[s]
        row[s, :k] = rows[s]
        if mode == "halo":
            # remap to x_ext coordinates: global col c -> c - r0 + h
            col[s, :k] = cols[s] - s * n_local + h
            col[s, k:] = h  # padding points at a valid slot (data is 0)
        else:
            col[s, :k] = cols[s]

    return {
        "data": data,
        "col": col,
        "row": row,
        "n_local": n_local,
        "halo": h,
        "mode": mode,
        "shape": A.shape,
    }


@register_pytree_node_class
class ShardedCSROperator:
    """Local row-slab of a CSR matrix (use inside ``shard_map``).

    ``data/col/row`` are the local padded COO arrays from
    :func:`partition_csr` (leading shard axis already stripped).
    """

    def __init__(self, data, col, row, n_local, halo, mode, axis=ROWS):
        self.data = data
        self.col = col
        self.row = row
        self.n_local = int(n_local)
        self._halo = int(halo)
        self.mode = mode
        self.axis = axis

    @property
    def shape(self):
        return (self.n_local, self.n_local)

    @property
    def dtype(self):
        return self.data.dtype

    def _x_ext(self, x):
        h = self._halo
        if h == 0:
            return x
        n_ax = lax.axis_size(self.axis)
        left = lax.ppermute(x[-h:], self.axis, _identity_perm_shift(n_ax, +1))
        right = lax.ppermute(x[:h], self.axis, _identity_perm_shift(n_ax, -1))
        return jnp.concatenate([left, x, right], axis=0)

    def __matmul__(self, x):
        tail = (1,) * (x.ndim - 1)
        d = self.data.reshape(self.data.shape + tail)
        if self.mode == "halo":
            x_src = self._x_ext(x)
        else:
            x_src = lax.all_gather(x, self.axis, axis=0, tiled=True)
        prod = d * x_src[self.col]
        return jax.ops.segment_sum(prod, self.row, num_segments=self.n_local)

    matvec = __matmul__

    def rmatvec(self, x):
        tail = (1,) * (x.ndim - 1)
        d = jnp.conj(self.data).reshape(self.data.shape + tail)
        prod = d * x[self.row]
        if self.mode == "halo":
            h = self._halo
            y_ext = jax.ops.segment_sum(
                prod, self.col, num_segments=self.n_local + 2 * h
            )
            y = y_ext[h : h + self.n_local]
            if h:
                n_ax = lax.axis_size(self.axis)
                # send left-halo contributions back to the left neighbor,
                # right-halo contributions to the right neighbor
                from_right = lax.ppermute(
                    y_ext[:h], self.axis, _identity_perm_shift(n_ax, -1)
                )
                from_left = lax.ppermute(
                    y_ext[-h:], self.axis, _identity_perm_shift(n_ax, +1)
                )
                y = y.at[-h:].add(from_right)
                y = y.at[:h].add(from_left)
            return y
        # gather mode: full-length scatter then reduce-scatter back
        N = self.n_local * lax.axis_size(self.axis)
        y_full = jax.ops.segment_sum(prod, self.col, num_segments=N)
        return lax.psum_scatter(y_full, self.axis, scatter_dimension=0, tiled=True)

    def diagonal(self):
        if self.mode == "halo":
            diag_col = self.row + self._halo
        else:
            r0 = lax.axis_index(self.axis) * self.n_local
            diag_col = self.row + r0
        mask = self.col == diag_col
        return jax.ops.segment_sum(
            jnp.where(mask, self.data, 0), self.row, num_segments=self.n_local
        )

    def tree_flatten(self):
        return (self.data, self.col, self.row), (
            self.n_local,
            self._halo,
            self.mode,
            self.axis,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, col, row = children
        n_local, halo, mode, axis = aux
        return cls(data, col, row, n_local, halo, mode, axis=axis)
