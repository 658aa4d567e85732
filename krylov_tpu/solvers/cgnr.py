"""CGNR — CG on the normal equations ``A^H A x = A^H b``.

Capability parity with the reference (reference: src/krylov/cgnr.py:15-21).
"""

from jax.tree_util import register_pytree_node_class

from .._operators import as_operator
from .cg import cg


@register_pytree_node_class
class AH_A:
    """Lazy ``A^H @ A`` (two matvecs per application)."""

    def __init__(self, A):
        self.A = A
        self.shape = A.shape
        self.dtype = A.dtype

    def __matmul__(self, x):
        return self.A.rmatvec(self.A @ x)

    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def cgnr(A, b, *args, **kwargs):
    A = as_operator(A)
    return cg(AH_A(A), A.rmatvec(b), *args, **kwargs)
