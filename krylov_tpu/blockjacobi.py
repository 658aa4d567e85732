"""Block-Jacobi preconditioner: batched dense block inverses.

Extension beyond the reference (which ships no preconditioners — ``M`` is
always user-supplied, reference: src/krylov/cg.py:33-36).  Where pointwise
Jacobi is one elementwise multiply and AMG is a whole cycle, block Jacobi
is ONE batched matmul — ``z_b = inv(A_bb) r_b`` for every diagonal block
at once, an ``(nb, k, k) @ (nb, k, rhs)`` einsum at full f32 precision.  Zero
communication when sharded (blocks never cross shard boundaries), so a
sharded application costs nothing but local FLOPs.

This is non-overlapping additive Schwarz with exact subdomain solves.  For
SPD ``A`` every principal submatrix is SPD, so the inverses exist and the
preconditioner is SPD — valid as the ``M`` of cg/minres.  Line-shaped
blocks (``block = ny`` on an ``nx x ny`` grid) give the classic "line
Jacobi" smoother that pointwise Jacobi cannot imitate on anisotropic
problems.

Setup (host, vectorized scipy/numpy): extract the block diagonal in one
COO filter, batch-invert with ``np.linalg.inv``.  Apply (device): one
einsum.  Both the single-device class and the sharded partition
(:func:`partition_block_jacobi`, the ``M_partition=`` protocol of
:func:`~krylov_tpu.parallel.sharded_solve`) share the extraction.
"""

import numpy as np

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.tree_util import register_pytree_node_class

from . import _precision as prec

__all__ = ["BlockJacobiPreconditioner", "partition_block_jacobi"]


def _block_diag_inverses(A, block, dtype=None):
    """``(nb, k, k)`` batched inverses of the diagonal blocks of ``A``
    (zero-padded to the block multiple; padded/empty diagonal entries are
    set to 1 so the padding acts as the identity)."""
    import scipy.sparse

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    if A.shape[0] != A.shape[1]:
        raise ValueError("block Jacobi needs a square matrix")
    k = int(block)
    if k <= 0:
        raise ValueError("block must be positive")
    n = A.shape[0]
    nb = -(-n // k)
    coo = A.tocoo()
    keep = (coo.row // k) == (coo.col // k)
    blocks = np.zeros((nb, k, k), dtype=dtype or A.dtype)
    np.add.at(
        blocks,
        (coo.row[keep] // k, coo.row[keep] % k, coo.col[keep] % k),
        coo.data[keep],
    )
    d = np.einsum("bii->bi", blocks)  # writable diagonal view
    d[d == 0] = 1.0
    return np.linalg.inv(blocks), n


def _apply_blocks(inv, r):
    """One batched matmul: ``z_b = inv_b r_b`` per block (``r`` may be
    shorter than the block grid; the tail is zero-padded and sliced off)."""
    nb, k, _ = inv.shape
    pad = nb * k - r.shape[0]
    rp = (
        jnp.concatenate(
            [r, jnp.zeros((pad,) + r.shape[1:], r.dtype)], axis=0
        )
        if pad
        else r
    )
    rb = rp.reshape((nb, k) + r.shape[1:])
    z = prec.einsum("bij,bj...->bi...", inv, rb)
    z = z.reshape((nb * k,) + r.shape[1:])
    return z[: r.shape[0]]


@register_pytree_node_class
class BlockJacobiPreconditioner:
    """``z = M @ r`` solves each diagonal block exactly (one batched
    matmul).  Build with :meth:`from_scipy`; SPD for SPD input, so it is a
    valid ``M`` of cg/minres in either backend."""

    def __init__(self, inv, n):
        self._inv = inv
        self._n = int(n)

    @classmethod
    def from_scipy(cls, A, block=64, dtype=None):
        """``block`` — uniform block size ``k``; rows are grouped
        contiguously, the trailing block is zero-padded internally.  On a
        grid, ``block = ny`` gives line-Jacobi."""
        inv, n = _block_diag_inverses(A, block, dtype=dtype)
        return cls(jnp.asarray(inv), n)

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._inv.dtype

    @property
    def block(self):
        return self._inv.shape[1]

    hermitian = True

    def __matmul__(self, r):
        return _apply_blocks(self._inv, r)

    matvec = __matmul__

    def rmatvec(self, r):
        return _apply_blocks(jnp.conj(jnp.swapaxes(self._inv, 1, 2)), r)

    def tree_flatten(self):
        return (self._inv,), (self._n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


@register_pytree_node_class
class _LocalBlockJacobi:
    """Shard-local slab of the block-Jacobi apply (inside ``shard_map``)."""

    def __init__(self, inv):
        self._inv = inv

    @property
    def shape(self):
        n = self._inv.shape[0] * self._inv.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self._inv.dtype

    hermitian = True

    def __matmul__(self, r):
        return _apply_blocks(self._inv, r)

    matvec = __matmul__

    def rmatvec(self, r):
        return _apply_blocks(jnp.conj(jnp.swapaxes(self._inv, 1, 2)), r)

    def tree_flatten(self):
        return (self._inv,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


class BlockJacobiPartition:
    """Sharded block Jacobi for ``sharded_solve(M_partition=)``.

    Blocks never cross shard boundaries, so the sharded application is
    communication-free; the only constraint is ``block`` dividing the
    shard-local row count."""

    def __init__(self, inv_stacked, n_shards, n, n_pad):
        self._inv = inv_stacked  # (S, nb_local, k, k)
        self.n_shards = int(n_shards)
        self.shape = (int(n), int(n))
        self.n_pad = int(n_pad)

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def block(self):
        return self._inv.shape[2]

    def device_arrays(self):
        return (self._inv,)

    def specs(self):
        from .parallel.mesh import ROWS

        return (P(ROWS, None, None, None),)

    def make_local(self, A_op, *arrs, axis=None):
        n_loc_op = getattr(A_op, "n_local", None)
        if n_loc_op is not None and int(n_loc_op) != self.n_local_fine:
            raise ValueError(
                f"block-Jacobi partition built for local rows "
                f"{self.n_local_fine} but the sharded operator has "
                f"n_local={int(n_loc_op)}"
            )
        (inv,) = arrs
        return _LocalBlockJacobi(inv[0])

    def as_global(self):
        """Single-device twin on the padded problem (exact same blocks)."""
        S, nbl, k, _ = self._inv.shape
        return BlockJacobiPreconditioner(
            jnp.asarray(np.asarray(self._inv).reshape(S * nbl, k, k)),
            self.n_pad,
        )


def partition_block_jacobi(A, n_shards, block=64, dtype=None):
    """Host setup of sharded block Jacobi (``M_partition=`` protocol).

    The matrix is zero-padded to the shard multiple exactly like
    :func:`~krylov_tpu.parallel.csr.partition_csr` pads the solve's
    matrix (unit-diagonal rows -> identity blocks), so pass the SAME
    matrix to both.  ``block`` must divide the shard-local row count."""
    import scipy.sparse

    from .parallel.csr import pad_unit_diagonal

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    N = A.shape[0]
    A_pad = pad_unit_diagonal(A.tocsr(), (-N) % n_shards)
    n_pad = A_pad.shape[0]
    n_local = n_pad // n_shards
    k = int(block)
    if n_local % k:
        raise ValueError(
            f"block={k} does not divide the shard-local row count "
            f"{n_local} (padded N={n_pad} over {n_shards} shards); "
            f"pick a divisor of {n_local}"
        )
    inv, _ = _block_diag_inverses(A_pad, k, dtype=dtype)
    nb_local = n_local // k
    return BlockJacobiPartition(
        jnp.asarray(inv.reshape(n_shards, nb_local, k, k)),
        n_shards, N, n_pad,
    )
