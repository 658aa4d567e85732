"""Distribution layer: row-partitioned solves over a device mesh.

First-class build components with no reference counterpart (the reference is
a single-process NumPy program — SURVEY.md §2.3):

* :func:`make_mesh` / :func:`psum_inner` — the ``(rows, rhs)`` device mesh
  and the psum-allreduce inner product,
* :class:`ShardedBandedOperator` — stencil row slabs with ``ppermute`` halo
  exchange between neighbor devices,
* :class:`ShardedCSROperator` / :func:`partition_csr` — general sparsity with
  automatic halo/all-gather strategy,
* :func:`sharded_solve` — run any solver as one compiled SPMD program.
"""

from . import multihost
from ..blockjacobi import BlockJacobiPartition, partition_block_jacobi
from .amg import AMGPartition, partition_amg
from .banded import ShardedBandedOperator
from .bsr import ShardedBSROperator
from .csr import ShardedCSROperator, partition_csr
from .grid import ShardedConstStencilOperator, ShardedGridStencilOperator
from .mesh import RHS, ROWS, make_mesh, psum_inner
from .schwarz import ILUSchwarzPartition, partition_ilu0
from .solve import make_sharded_solver, sharded_solve

__all__ = [
    "AMGPartition",
    "partition_amg",
    "BlockJacobiPartition",
    "partition_block_jacobi",
    "ILUSchwarzPartition",
    "partition_ilu0",
    "make_mesh",
    "psum_inner",
    "ROWS",
    "RHS",
    "ShardedBandedOperator",
    "ShardedBSROperator",
    "ShardedCSROperator",
    "ShardedConstStencilOperator",
    "ShardedGridStencilOperator",
    "partition_csr",
    "make_sharded_solver",
    "sharded_solve",
    "multihost",
]
