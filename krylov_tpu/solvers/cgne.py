"""CGNE — CG on the normal equations ``A A^H y = b``, ``x = A^H y``.

Capability parity with the reference (reference: src/krylov/cgne.py:17-41).
"""


from jax.tree_util import register_pytree_node_class

from .._info import Info
from .._operators import as_operator
from .cg import cg


@register_pytree_node_class
class A_AH:
    """Lazy ``A @ A^H`` (two matvecs per application)."""

    def __init__(self, A):
        self.A = A
        self.shape = A.shape
        self.dtype = A.dtype

    def __matmul__(self, x):
        return self.A @ self.A.rmatvec(x)

    def tree_flatten(self):
        return (self.A,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def cgne(A, b, *args, **kwargs):
    A = as_operator(A)
    sol, info = cg(A_AH(A), b, *args, **kwargs)

    xk = A.rmatvec(info.xk)
    if sol is not None:
        sol = xk

    info = Info(
        info.success, xk, info.numsteps, info.resnorms,
        info.num_operations, info.arnoldi,
    )
    return sol, info
