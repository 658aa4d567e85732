"""krylov_tpu — a JAX-native Krylov-subspace solver framework.

Built from scratch on JAX/XLA: every solver is a functional recurrence
on a state pytree that runs either as a float64 host loop (numerical parity
mode) or as a single compiled ``lax.while_loop`` on device; sparse operators
are device-resident pytrees whose matvecs XLA compiles; distribution is
row-partitioning over a ``jax.sharding.Mesh`` with psum inner products.

Public surface mirrors the reference library (reference:
src/krylov/__init__.py:21-49) plus the device-native extensions under
``krylov_tpu.ops`` and ``krylov_tpu.parallel``.
"""

from . import diffable, ops, utils
from .__about__ import __version__
from ._info import Info
from ._operators import (
    ChebyshevPreconditioner,
    DiagonalOperator,
    Identity,
    Product,
    as_operator,
    jacobi_preconditioner,
)
from .arnoldi import (
    ArnoldiCGS,
    ArnoldiHouseholder,
    ArnoldiLanczos,
    ArnoldiMGS,
    arnoldi_res,
)
from .errors import ArgumentError
from .givens import givens
from .householder import Householder
from .amg import AMGPreconditioner
from .blockjacobi import BlockJacobiPreconditioner
from .ilu import ILUPreconditioner
from .multigrid import (
    MultigridPreconditioner,
    ShardedMultigridPreconditioner,
    multigrid_factory,
)
from .solvers import *  # noqa: F401,F403
from .solvers import __all__ as _solver_names

aslinearoperator = as_operator  # reference-compatible alias

__all__ = [
    *_solver_names,
    "utils",
    "ops",
    "diffable",
    "ArnoldiHouseholder",
    "ArnoldiCGS",
    "ArnoldiMGS",
    "ArnoldiLanczos",
    "arnoldi_res",
    "Householder",
    "givens",
    "Identity",
    "DiagonalOperator",
    "ChebyshevPreconditioner",
    "AMGPreconditioner",
    "BlockJacobiPreconditioner",
    "ILUPreconditioner",
    "MultigridPreconditioner",
    "ShardedMultigridPreconditioner",
    "multigrid_factory",
    "jacobi_preconditioner",
    "Product",
    "as_operator",
    "aslinearoperator",
    "Info",
    "ArgumentError",
    "__version__",
]
