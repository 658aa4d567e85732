"""Every contraction on the solver path asks for full f32 precision.

On a GPU, XLA may run a float32 contraction in TF32 unless the operation
carries ``precision=HIGHEST``; the CPU cannot show the difference
numerically, so these tests read it off the traced program: every
``dot_general`` in the jaxpr of each site (sub-jaxprs of loops, conds and
``shard_map`` included) must carry ``Precision.HIGHEST`` on both operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
from jax import lax

import krylov_tpu
from krylov_tpu import _precision as prec
from krylov_tpu import arnoldi, parallel
from krylov_tpu._inner import get_default_inner
from krylov_tpu.householder import Householder
from krylov_tpu.ops import stencil
from krylov_tpu.parallel import mesh as pmesh

F32 = jnp.float32
HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _dot_precisions(jaxpr):
    """Precision params of every dot_general, recursing into sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


def _assert_all_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "site traced no contraction at all"
    assert all(p == HIGHEST for p in precs), precs


def _vec(*shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), F32)


def test_plain_jnp_contraction_carries_no_precision():
    """The check has teeth: an unpinned contraction is caught."""
    precs = _dot_precisions(
        jax.make_jaxpr(jnp.dot)(_vec(8), _vec(8)).jaxpr
    )
    assert precs == [None]


@pytest.mark.parametrize(
    "name", ["dot", "vdot", "einsum", "tensordot", "matmul"]
)
def test_helper_wrappers_pin_highest(name):
    fn = {
        "dot": lambda a, b: prec.dot(a, b),
        "vdot": lambda a, b: prec.vdot(a, b),
        "einsum": lambda a, b: prec.einsum("i,i->", a, b),
        "tensordot": lambda a, b: prec.tensordot(a, b, axes=1),
        "matmul": lambda a, b: prec.matmul(a, b),
    }[name]
    _assert_all_highest(fn, _vec(8), _vec(8, seed=1))


@pytest.mark.parametrize("shape", [(16,), (16, 3)])
def test_default_inner_products(shape):
    inner = get_default_inner(shape)
    _assert_all_highest(inner, _vec(*shape), _vec(*shape, seed=1))


@pytest.mark.parametrize("which", ["inner", "batch", "block"])
def test_mesh_aware_inner_products(which):
    mesh = parallel.make_mesh(n_rows=2, devices=jax.devices()[:2])
    P = jax.sharding.PartitionSpec
    if which == "inner":
        fn, args, specs = pmesh.psum_inner((8,)), (_vec(16), _vec(16)), (
            P("rows"), P("rows"))
    elif which == "batch":
        fn, args, specs = pmesh.psum_batch_inner(), (
            _vec(4, 16), _vec(16)), (P(None, "rows"), P("rows"))
    else:
        fn, args, specs = pmesh.psum_block_inner(), (
            _vec(16, 3), _vec(16, 3)), (P("rows", None), P("rows", None))
    smap = jax.shard_map(
        fn, mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False
    )
    _assert_all_highest(smap, *args)


@pytest.mark.parametrize("shape", [(12,), (12, 1)])
def test_householder_reflector_apply_and_matrix(shape):
    u = _vec(*shape)
    _assert_all_highest(
        lambda u, x: arnoldi._apply_reflector(u, 1.5, x), u,
        _vec(*shape, seed=1),
    )
    _assert_all_highest(lambda v: Householder(v).matrix(), u)


def _dense_system(n=24):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) * 0.1 + 4.0 * np.eye(n)
    return jnp.asarray(A, F32), _vec(n, seed=4)


@pytest.mark.parametrize("ortho", ["mgs", "householder", "cgs"])
def test_compiled_gmres_on_dense_operator(ortho):
    """The whole compiled GMRES — MatrixOperator matvec, Arnoldi, Givens
    rotations, basis combination — is contraction-clean."""
    A, b = _dense_system()

    def solve(A, b):
        return krylov_tpu.gmres(A, b, ortho=ortho, maxiter=8,
                                backend="while_loop")[1].xk

    _assert_all_highest(solve, A, b)


def test_compiled_block_cg():
    A, _ = _dense_system()
    A = A @ A.T + jnp.eye(A.shape[0], dtype=F32)

    def solve(A, B):
        return krylov_tpu.cg_block(A, B, maxiter=5, backend="while_loop")[1].xk

    _assert_all_highest(solve, A, _vec(A.shape[0], 3))


def test_bsr_and_block_jacobi_applies():
    from krylov_tpu.blockjacobi import BlockJacobiPreconditioner
    from krylov_tpu.ops.bsr import BSROperator

    dense = np.kron(np.eye(4), np.ones((4, 4))) + 4 * np.eye(16)
    sp = scipy.sparse.csr_matrix(dense.astype(np.float32))
    A = BSROperator.from_scipy(sp, blocksize=(4, 4))
    x = _vec(16, 2)
    _assert_all_highest(lambda A, x: A @ x, A, x)
    _assert_all_highest(lambda A, x: A.rmatvec(x), A, x)
    M = BlockJacobiPreconditioner.from_scipy(sp, block=4)
    _assert_all_highest(lambda M, r: M @ r, M, x)


def test_multigrid_and_amg_coarse_inverses():
    from krylov_tpu import AMGPreconditioner, MultigridPreconditioner

    A = stencil.diffusion_2d(np.ones((16, 16)), dtype=np.float32)
    Mg = MultigridPreconditioner(A)
    _assert_all_highest(lambda M, r: M @ r, Mg, _vec(16, 16))
    sp = stencil.poisson_2d(24, 24, dtype=np.float32).toscipy()
    Ma = AMGPreconditioner.from_scipy(sp, coarse_size=50)
    _assert_all_highest(lambda M, r: M @ r, Ma, _vec(sp.shape[0]))
