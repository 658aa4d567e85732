"""Differentiable linear solves (implicit function theorem).

A capability with no reference counterpart and unique to the JAX-native
design: gradients flow *through* a Krylov solve without differentiating the
iteration.  For ``x(theta) = A(theta)^{-1} b(theta)``:

    dL/db     = lambda,                 where  A^H lambda = dL/dx
    dL/dtheta = -Re <lambda, dA/dtheta x>   (via a VJP of the matvec)

so the backward pass is one adjoint solve with the same solver — O(1)
memory in the iteration count, unlike unrolled differentiation.

Usage::

    from krylov_tpu import diffable

    def loss(coeffs2d):
        A = GridStencilOperator(coeffs2d, offsets, ny, hermitian=True)
        x = diffable.solve(A, b, params=(coeffs2d,),
                           make_op=lambda c: GridStencilOperator(
                               c, offsets, ny, hermitian=True))
        return jnp.sum(x ** 2)

    g = jax.grad(loss)(coeffs2d)

For convenience :func:`solve` also accepts plain operators whose pytree
leaves are the parameters (``params``/``make_op`` optional).
"""

from functools import partial

import jax

from .solvers.cg import cg


def solve(
    A,
    b,
    params=None,
    make_op=None,
    solver=cg,
    adjoint_solver=None,
    **solver_kwargs,
):
    """Solve ``A x = b`` with gradients defined by the implicit function
    theorem.

    * ``A`` — an operator pytree (its leaves are differentiated when
      ``params``/``make_op`` are omitted).
    * ``params``/``make_op`` — optional explicit parameterization:
      ``A = make_op(*params)``; gradients are returned for ``params``.
    * ``solver`` — any krylov_tpu solver; ``adjoint_solver`` defaults to the
      same (correct whenever A is Hermitian or the solver handles A^H via
      ``rmatvec``-based methods).

    Returns ``x`` only (differentiable); use the plain solver for ``Info``.
    """
    if params is None or make_op is None:
        params = jax.tree_util.tree_leaves(A)
        treedef = jax.tree_util.tree_structure(A)

        def make_op(*leaves):
            return jax.tree_util.tree_unflatten(treedef, leaves)

    adjoint_solver = solver if adjoint_solver is None else adjoint_solver

    solve_kw = dict(solver_kwargs)
    solve_kw.setdefault("backend", "while_loop")

    @partial(jax.custom_vjp, nondiff_argnums=())
    def _solve(params, b):
        A_ = make_op(*params)
        # info.xk rather than the sol-or-None first element: outside jit an
        # unconverged solve returns (None, info) and gradients should degrade
        # gracefully to the last iterate instead of crashing the custom_vjp.
        _, info = solver(A_, b, **solve_kw)
        return info.xk

    def _fwd(params, b):
        x = _solve(params, b)
        return x, (params, b, x)

    def _bwd(res, g):
        params, b, x = res
        A_ = make_op(*params)

        # adjoint system A^H lambda = g
        if getattr(A_, "hermitian", False):
            A_adj = A_
        else:

            class _Adj:
                shape = A_.shape
                dtype = getattr(A_, "dtype", None)
                vector_shape = getattr(A_, "vector_shape", None)

                def __matmul__(self, v):
                    return A_.rmatvec(v)

                matvec = __matmul__

                def rmatvec(self, v):
                    return A_ @ v

            A_adj = _Adj()

        _, adj_info = adjoint_solver(A_adj, g, **solve_kw)
        lam = adj_info.xk

        # d/dparams: vjp of params -> A(params) @ x at cotangent -lambda
        def apply_params(*p):
            return make_op(*p) @ x

        _, vjp_fn = jax.vjp(apply_params, *params)
        dparams = vjp_fn(-lam)
        return tuple(dparams), lam

    _solve.defvjp(_fwd, _bwd)
    return _solve(tuple(params), b)
