"""Symmetric bandwidth-reducing reorderings of sparse matrices (host side).

A row-partitioned sharded solve exchanges, per matvec, the x entries each
shard's rows reference outside its own block.  For a badly ordered matrix
(a scrambled mesh) almost every column is remote; a reverse-Cuthill–McKee
permutation ``B = A[perm][:, perm]`` brings the pattern back near the
diagonal, so the halo shrinks to a few neighbor rows.  The solve then runs
on ``B`` and maps the solution back with :func:`invert_permutation`.
"""

import numpy as np


def rcm_permutation(sp):
    """Symmetric reverse-Cuthill–McKee ordering of ``sp``'s pattern.

    Returns the row/column permutation ``perm`` minimizing (greedily) the
    bandwidth of ``sp[perm][:, perm]``; the pattern is symmetrized first,
    so nonsymmetric matrices are accepted.
    """
    import scipy.sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = scipy.sparse.csr_matrix(sp)
    pattern = (csr + csr.T).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(pattern, symmetric_mode=True), dtype=np.int64
    )


def invert_permutation(perm):
    """Inverse of an index permutation: ``inv[perm[i]] = i``."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def resolve_reorder(sp, reorder):
    """Resolve a reorder spec to a permutation, or None to keep order.

    ``reorder``: ``None`` (keep order), ``"rcm"`` (always reorder),
    ``"auto"`` (reorder only when RCM at least halves the matrix
    bandwidth), or an explicit index array.  Raises up front for
    rectangular matrices; never materializes the permuted matrix (callers
    permute once, if at all).
    """
    import scipy.sparse

    if reorder is None:
        return None
    if sp.shape[0] != sp.shape[1]:
        raise ValueError(
            "reorder= needs a square matrix (symmetric permutation)"
        )
    if not isinstance(reorder, str):
        return np.asarray(reorder, np.int64)
    if reorder == "rcm":
        return rcm_permutation(sp)
    if reorder != "auto":
        raise ValueError(f"unknown reorder mode {reorder!r}")
    # compare bandwidths without materializing the permuted matrix
    csr = scipy.sparse.csr_matrix(sp)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    if rows.size == 0:
        return None
    bw0 = int(np.abs(csr.indices - rows).max())
    cand = rcm_permutation(csr)
    inv = invert_permutation(cand)
    bw1 = int(np.abs(inv[csr.indices] - inv[rows]).max())
    return cand if 2 * bw1 <= bw0 else None
