"""Row-partitioned BSR operator (all-gather mode).

Block-structured matrices get the dense-block SpMM locally
(:class:`~krylov_tpu.ops.bsr.BSROperator`); across the mesh, each shard
owns a slab of block rows and the iterate is ``all_gather``-ed
before the local SpMM (dense block columns generally reach far from the
diagonal, so the all-gather mode mirrors the CSR "gather" strategy).
The adjoint matvec computes each shard's full-length contribution and
``psum``-reduces it.  No reference counterpart (SURVEY.md §2.3).
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class

from ..ops.bsr import BSROperator
from .mesh import ROWS


@register_pytree_node_class
class ShardedBSROperator:
    """Local block-row slab of a BSROperator (inside shard_map).

    ``data (nbrows_local * max_blocks, R, C)``; ``cols (nbrows_local,
    max_blocks)`` hold GLOBAL block-column indices.  ``n_global`` is the
    full matrix dimension.
    """

    def __init__(self, data, cols, n_global, axis=ROWS):
        self.n_global = int(n_global)
        self._local = BSROperator(data, cols, (self._n_local(data, cols), n_global))
        self.axis = axis

    @staticmethod
    def _n_local(data, cols):
        return cols.shape[0] * data.shape[1]

    @property
    def dtype(self):
        return self._local.dtype

    @property
    def blocksize(self):
        return self._local.blocksize

    @property
    def shape(self):
        n_local = self._local.shape[0]
        return (n_local, n_local)  # local SPMD view

    def __matmul__(self, x):
        x_full = lax.all_gather(x, self.axis, tiled=True)
        return self._local @ x_full

    matvec = __matmul__

    def rmatvec(self, x):
        contrib = self._local.rmatvec(x)          # full length
        total = lax.psum(contrib, self.axis)
        n_local = self._local.shape[0]
        i0 = lax.axis_index(self.axis) * n_local
        return lax.dynamic_slice_in_dim(total, i0, n_local, axis=0)

    def diagonal(self):
        R, C = self.blocksize
        nbrows, max_blocks = self._local.cols.shape
        if R != C:
            return jnp.zeros(self._local.shape[0], self.dtype)
        b0 = lax.axis_index(self.axis) * nbrows
        brow = jnp.repeat(jnp.arange(nbrows) + b0, max_blocks)
        on_diag = self._local.cols.reshape(-1) == brow
        blk_diags = jnp.einsum("bii->bi", self._local.data)
        contrib = jnp.where(on_diag[:, None], blk_diags, 0)
        return contrib.reshape(nbrows, max_blocks, R).sum(axis=1).reshape(-1)

    def tree_flatten(self):
        return (self._local.data, self._local.cols), (self.n_global, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        n_global, axis = aux
        return cls(children[0], children[1], n_global, axis=axis)
