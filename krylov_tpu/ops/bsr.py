"""Block-sparse-row (BSR) operator.

Device-resident BSR in ELL-padded form (every block-row stores the same
number of blocks; zero blocks pad short rows — padding contributes exact
zeros).  The multi-RHS matvec is a gather + batched block einsum + sum
over each block row, which XLA hands to its batched-matmul path.

This is the block-structured counterpart of :class:`CSROperator`
(SURVEY.md §2.2: the reference's scipy-CSR/BLAS crossings map to device
CSR/BSR SpMV/SpMM).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_pytree_node_class

from .._precision import einsum


@register_pytree_node_class
class BSROperator:
    """ELL-padded BSR: ``data (nbrows * max_blocks, R, C)``,
    ``cols (nbrows, max_blocks)`` block-column indices."""

    def __init__(self, data, cols, shape):
        self.data = data
        self.cols = cols
        self.shape = tuple(int(s) for s in shape)

    @classmethod
    def from_scipy(cls, A, blocksize=None):
        """Convert a scipy sparse matrix (any format) to ELL-padded BSR."""
        import scipy.sparse

        bsr = (
            A.tobsr(blocksize=blocksize)
            if blocksize is not None
            else A.tobsr()
        )
        bsr.sort_indices()
        R, C = bsr.blocksize
        nbrows = bsr.shape[0] // R
        counts = np.diff(bsr.indptr)
        max_blocks = max(1, int(counts.max()))

        data = np.zeros((nbrows * max_blocks, R, C), dtype=bsr.dtype)
        cols = np.zeros((nbrows, max_blocks), dtype=np.int32)
        for i in range(nbrows):
            s, e = bsr.indptr[i], bsr.indptr[i + 1]
            n = e - s
            data[i * max_blocks : i * max_blocks + n] = bsr.data[s:e]
            cols[i, :n] = bsr.indices[s:e]
        return cls(jnp.asarray(data), jnp.asarray(cols), bsr.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def blocksize(self):
        return self.data.shape[1:]

    @property
    def nnz(self):
        """Stored entries (including ELL/zero padding inside blocks)."""
        return int(np.prod(self.data.shape))

    def _spmm(self, x2):
        # gather x slabs, batched block matmul, then sum the max_blocks
        # products of each block-row
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        xg = x2.reshape(-1, C, x2.shape[1])[self.cols.reshape(-1)]
        prod = einsum("brc,bck->brk", self.data, xg)
        prod = prod.reshape(nbrows, max_blocks, R, x2.shape[1])
        return prod.sum(axis=1).reshape(nbrows * R, x2.shape[1])

    def __matmul__(self, x):
        if x.ndim == 1:
            return self._spmm(x[:, None])[:, 0]
        return self._spmm(x)

    matvec = __matmul__

    def rmatvec(self, x):
        # A^H @ x: scatter-add of conj(block)^H products into block columns
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        x2 = x[:, None] if x.ndim == 1 else x
        k = x2.shape[1]
        xr = x2.reshape(nbrows, R, k)
        # per stored block: conj(B)^H @ x_blockrow
        xb = jnp.repeat(xr, max_blocks, axis=0)  # (nb_total, R, k)
        prod = einsum("brc,brk->bck", jnp.conj(self.data), xb)
        nbcols = self.shape[1] // C
        out = jax.ops.segment_sum(
            prod, self.cols.reshape(-1), num_segments=nbcols
        ).reshape(nbcols * C, k)
        return out[:, 0] if x.ndim == 1 else out

    def diagonal(self):
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        if R != C:
            return jnp.zeros(self.shape[0], self.dtype)
        brow = jnp.repeat(jnp.arange(nbrows), max_blocks)
        on_diag = self.cols.reshape(-1) == brow
        blk_diags = jnp.einsum("bii->bi", self.data)  # (nb_total, R)
        contrib = jnp.where(on_diag[:, None], blk_diags, 0)
        return contrib.reshape(nbrows, max_blocks, R).sum(axis=1).reshape(-1)

    def todense(self):
        R, C = self.blocksize
        nbrows, max_blocks = self.cols.shape
        nbcols = self.shape[1] // C
        out = jnp.zeros((nbrows, nbcols, R, C), self.dtype)
        brow = jnp.repeat(jnp.arange(nbrows), max_blocks)
        out = out.at[brow, self.cols.reshape(-1)].add(self.data)
        return out.transpose(0, 2, 1, 3).reshape(self.shape)

    def tree_flatten(self):
        return (self.data, self.cols), self.shape

    @classmethod
    def tree_unflatten(cls, shape, children):
        return cls(*children, shape)


def detect_blocksize(
    sp,
    candidates=((128, 128), (64, 64), (32, 32)),
    min_fill=0.35,
    min_nnz=1 << 15,
):
    """Detect whether a scipy sparse matrix is profitably block-structured.

    Among the candidate blocksizes whose dense-block fill ratio (true nnz /
    stored block entries) reaches ``min_fill``, returns the one with the
    HIGHEST fill -- the SpMM is memory-bound, so minimizing streamed padding
    beats maximizing the block size.  Returns ``None`` when no candidate
    qualifies (scattered sparsity stays on the CSR path).

    Candidates whose **ELL padding** would blow up are also rejected:
    :meth:`BSROperator.from_scipy` pads every block row to the max
    block count, so a skewed matrix (one dense row, arrow structure) can
    pass the per-block fill test yet allocate near-dense memory.  The
    bound ``nbrows * max_blocks * R * C <= max_ell_expand * nnz`` caps the
    streamed (and allocated) bytes at a small multiple of the true data.
    Cost: one O(nnz) coarsening per candidate.
    """
    import scipy.sparse

    n, m = sp.shape
    if sp.nnz < min_nnz:
        return None
    max_ell_expand = 1.0 / min_fill
    coo = sp.tocoo()
    best, best_fill = None, min_fill
    for R, C in candidates:
        if n % R or m % C:
            continue
        coarse = scipy.sparse.csr_matrix(
            (np.ones(sp.nnz, np.int64), (coo.row // R, coo.col // C)),
            shape=(n // R, m // C),
        )
        nblocks = coarse.count_nonzero()
        fill = sp.nnz / (nblocks * R * C) if nblocks else 0.0
        counts = np.diff(coarse.indptr)
        ell_entries = (n // R) * int(counts.max() if counts.size else 0) * R * C
        if ell_entries > max_ell_expand * sp.nnz:
            continue
        if fill >= best_fill:
            best, best_fill = (R, C), fill
    return best
