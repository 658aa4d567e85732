"""Additive-Schwarz ILU(0): per-shard subdomain factorizations.

No reference counterpart (the reference ships neither preconditioners nor a
distribution layer — reference: src/krylov/cg.py:33-36, SURVEY.md §2.3).
This is the industry-default distributed preconditioner (PETSc's
``bjacobi + ilu0``): each shard factors its OWN diagonal block with exact-
pattern ILU(0), and an application is two local triangular sweeps — zero
communication, so preconditioning adds no collectives to the solve.  Use it
where the dense-inverse :func:`~krylov_tpu.blockjacobi.partition_block_jacobi`
cannot scale (subdomains of 10^5+ rows) and a full
:func:`~krylov_tpu.parallel.amg.partition_amg` hierarchy is more than the
problem needs.  Nonsymmetric apply: feed the ``Ml`` of
gmres/bicgstab/cgs/qmr (``sharded_solve`` routes ``M_partition`` there
automatically for those solvers).

Device mapping — the sweep engine here differs deliberately from the
single-device :class:`~krylov_tpu.ops.triangular.LevelScheduledTriangularSolve`
(which unrolls one XLA stage per dependency level): all levels are padded to
a COMMON shape and the sweep is one ``lax.scan`` over the level axis, so the
compiled program is O(1) in the level count instead of O(levels) — the
difference between a 30 s and a 2 s solver compile at wavefront depth ~2·k.
Padding is exact, not approximate: padded rows write a dummy slot beyond the
local vector, padded entries carry zero data, padded level steps are
identity.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.tree_util import register_pytree_node_class

from ..ilu import _ilu0_factor
from ..ops.triangular import (
    StackedTriangularSweep,
    stacked_level_arrays,
)
from .csr import pad_unit_diagonal
from .mesh import ROWS

__all__ = ["ILUSchwarzPartition", "partition_ilu0"]


@register_pytree_node_class
class _LocalILUSchwarz:
    """``z = U⁻¹ L⁻¹ r`` on the shard's own diagonal block (no
    communication); built inside ``shard_map``."""

    def __init__(self, lsweep, usweep, adj=None):
        self._l = lsweep
        self._u = usweep
        self._adj = adj  # (uH_lower, lH_upper) | None

    @property
    def shape(self):
        n = self._l.n_local
        return (n, n)

    @property
    def dtype(self):
        return self._l.dat.dtype

    def __matmul__(self, r):
        return self._u(self._l(r))

    matvec = __matmul__

    def rmatvec(self, r):
        if self._adj is None:
            raise ValueError(
                "build partition_ilu0(..., with_rmatvec=True) for solvers "
                "that apply the adjoint preconditioner (qmr)"
            )
        uH, lH = self._adj
        return lH(uH(r))

    def tree_flatten(self):
        return (self._l, self._u, self._adj), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class ILUSchwarzPartition:
    """Sharded block-Jacobi-ILU(0) for ``sharded_solve(M_partition=)``."""

    def __init__(self, arrays, n_shards, shape, n_pad, with_rmatvec):
        self._arrays = arrays  # 10 or 20 stacked (S, nlev, .) arrays
        self.n_shards = int(n_shards)
        self.shape = tuple(shape)
        self.n_pad = int(n_pad)
        self._with_rmatvec = bool(with_rmatvec)

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def nlevels(self):
        """(L, U) padded dependency-level counts (max across shards)."""
        return (self._arrays[0].shape[1], self._arrays[5].shape[1])

    def device_arrays(self):
        return tuple(self._arrays)

    def specs(self):
        return (P(ROWS, None, None),) * len(self._arrays)

    def _sweeps(self, arrs, n_local):
        l = StackedTriangularSweep(*arrs[0:5], n_local)
        u = StackedTriangularSweep(*arrs[5:10], n_local)
        adj = None
        if self._with_rmatvec:
            adj = (
                StackedTriangularSweep(*arrs[10:15], n_local),
                StackedTriangularSweep(*arrs[15:20], n_local),
            )
        return _LocalILUSchwarz(l, u, adj=adj)

    def make_local(self, A_op, *arrs, axis=None):
        n_loc_op = getattr(A_op, "n_local", None)
        if n_loc_op is not None and int(n_loc_op) != self.n_local_fine:
            raise ValueError(
                f"ILU-Schwarz partition built for local rows "
                f"{self.n_local_fine} but the sharded operator has "
                f"n_local={int(n_loc_op)}"
            )
        return self._sweeps([a[0] for a in arrs], self.n_local_fine)

    def as_global(self):
        """Single-device twin on the padded problem: the same per-shard
        sweeps vmapped over the shard axis (the apply is shard-local, so
        the twin is exact, not merely equivalent)."""
        return _GlobalILUSchwarz(self)


@register_pytree_node_class
class _GlobalILUSchwarz:
    def __init__(self, part):
        self._part = part

    @property
    def shape(self):
        return (self._part.n_pad, self._part.n_pad)

    @property
    def dtype(self):
        return self._part._arrays[2].dtype

    def _apply(self, r, adjoint):
        part = self._part
        n_loc = part.n_local_fine
        rb = r.reshape((part.n_shards, n_loc) + r.shape[1:])

        def solve_shard(arrs, rs):
            obj = part._sweeps(list(arrs), n_loc)
            return obj.rmatvec(rs) if adjoint else obj @ rs

        z = jax.vmap(solve_shard)(tuple(part._arrays), rb)
        return z.reshape(r.shape)

    def __matmul__(self, r):
        return self._apply(r, adjoint=False)

    matvec = __matmul__

    def rmatvec(self, r):
        return self._apply(r, adjoint=True)

    def tree_flatten(self):
        return (tuple(self._part._arrays),), (
            self._part.n_shards, self._part.shape, self._part.n_pad,
            self._part._with_rmatvec,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        n_shards, shape, n_pad, with_rmatvec = aux
        return cls(ILUSchwarzPartition(
            list(children[0]), n_shards, shape, n_pad, with_rmatvec
        ))


def partition_ilu0(A, n_shards, *, with_rmatvec=False, dtype=None,
                   max_levels=4096):
    """Host setup of sharded ILU(0)-Schwarz (``M_partition=`` protocol).

    Factors each shard's diagonal block on the exact pattern (no pivoting,
    :func:`~krylov_tpu.ilu._ilu0_factor`); couplings to other shards are
    simply dropped — that is the additive-Schwarz approximation, and it is
    what makes the apply communication-free.  The matrix is zero-padded to
    the shard multiple exactly like :func:`partition_csr` pads the
    solve's matrix, so pass the SAME matrix to both."""
    import scipy.sparse

    if not scipy.sparse.issparse(A):
        A = scipy.sparse.csr_matrix(np.asarray(A))
    if A.shape[0] != A.shape[1]:
        raise ValueError("ILU-Schwarz needs a square matrix")
    N = A.shape[0]
    A_pad = pad_unit_diagonal(A.tocsr(), (-N) % n_shards)
    n_pad = A_pad.shape[0]
    n_local = n_pad // n_shards
    dt = dtype or A_pad.dtype

    Ls, Us, UHs, LHs = [], [], [], []
    for s in range(n_shards):
        r0 = s * n_local
        blk = A_pad[r0 : r0 + n_local, r0 : r0 + n_local].tocsr()
        L, U = _ilu0_factor(blk)
        if dtype is not None:
            L, U = L.astype(dtype), U.astype(dtype)
        Ls.append(L)
        Us.append(U)
        if with_rmatvec:
            UHs.append(U.conj().T.tocsr())
            LHs.append(L.conj().T.tocsr())

    arrays = list(stacked_level_arrays(Ls, n_local, True, max_levels, dt))
    arrays += list(stacked_level_arrays(Us, n_local, False, max_levels, dt))
    if with_rmatvec:
        arrays += list(stacked_level_arrays(UHs, n_local, True, max_levels, dt))
        arrays += list(stacked_level_arrays(LHs, n_local, False, max_levels, dt))
    return ILUSchwarzPartition(
        [jnp.asarray(a) for a in arrays], n_shards, A.shape, n_pad,
        with_rmatvec,
    )
