"""SPMD solver driver: run any krylov_tpu solver row-partitioned over a mesh.

The payoff of the L0 design (SURVEY.md §7 stage 7): operator apply and inner
product are the only two injection points in every solver, so the *identical*
solver code runs sharded — the operator becomes a halo-exchanging local block,
the inner product becomes a ``psum``, and the whole solve (one
``lax.while_loop``) compiles into a single SPMD program with zero host
round-trips: per iteration the only cross-device traffic is the halo
``ppermute``s inside the matvec and one/two scalar allreduces.

No reference counterpart (the reference is single-process NumPy,
reference: src/krylov/_helpers.py:101-110 is its entire "parallel" surface).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from .._driver import ShardMonitor
from .._info import Info
from ..ops.bsr import BSROperator
from ..ops.sparse import CSROperator
from ..ops.stencil import BandedOperator, ConstStencilOperator, GridStencilOperator
from .banded import ShardedBandedOperator
from .bsr import ShardedBSROperator
from .csr import ShardedCSROperator, partition_csr
from .grid import ShardedConstStencilOperator, ShardedGridStencilOperator
from .mesh import (
    ROWS, RHS, make_mesh, psum_batch_inner, psum_block_inner,
    psum_fused_inner, psum_inner,
)


def sharded_solve(
    solver,
    A,
    b,
    *,
    mesh=None,
    shard_rhs=False,
    x0=None,
    M_diag=None,
    M_factory=None,
    M_partition=None,
    tol=1e-5,
    atol=1e-15,
    maxiter=None,
    reorder=None,
    callback=None,
    **solver_kwargs,
):
    """Solve ``A x = b`` with ``solver`` row-partitioned over ``mesh``.

    * ``A`` — a :class:`~krylov_tpu.ops.stencil.BandedOperator` /
      :class:`GridStencilOperator` / :class:`ConstStencilOperator`, a
      :class:`~krylov_tpu.ops.CSROperator` or scipy sparse matrix, or a
      :class:`~krylov_tpu.ops.bsr.BSROperator`.
    * ``solver`` — any krylov_tpu solver accepting ``(A, b, inner=, x0=,
      backend=)`` (cg, minres, gmres, ...).
    * ``mesh`` — a ``(rows[, rhs])`` mesh from :func:`make_mesh` (default:
      all devices on the rows axis).
    * ``shard_rhs`` — additionally shard RHS columns over the ``rhs`` mesh
      axis (pure data parallelism).
    * ``M_diag`` — global diagonal of a Jacobi-type preconditioner
      ``M = diag(M_diag)`` (shape ``(N,)``); sharded with the vectors and
      passed to the solver as ``M`` (elementwise, no communication).
    * ``M_factory`` — callable receiving the SHARD-LOCAL operator and
      returning a preconditioner built on it, e.g.
      ``lambda A_l: ChebyshevPreconditioner(A_l, (lo, hi), degree=6)``:
      matvec-based preconditioners then run distributed for free (their
      matvecs are the sharded operator's own halo-exchanging matvecs).
    * ``M_partition`` — a host-built distributed preconditioner partition
      (e.g. :func:`~krylov_tpu.parallel.amg.partition_amg`): its stacked
      arrays ride through ``shard_map`` next to the operator's and its
      ``make_local`` assembles the cycle around the solve's own sharded
      fine-level operator.  Build it on the SAME matrix/ordering as ``A``
      (mutually exclusive with ``M_diag``/``M_factory``/``reorder``).
    * ``reorder`` — for scipy/CSR operators: solve on the symmetric
      RCM reordering (``"rcm"``, an index array, or ``"auto"`` which
      reorders only when it at least halves the matrix bandwidth).  A
      bandwidth-reduced ordering shrinks the halo the shards exchange
      and can flip the partition from all-gather to halo mode; the
      vectors are permuted once per solve and the iterate is returned
      in user order (trajectories are permutation-invariant).

    Returns ``(sol, Info)`` with reference-parity semantics: ``sol is None``
    when unconverged, ``info.resnorms`` a host array of shape
    ``(numsteps + 1, *b.shape[1:])``.

    ``callback`` — per-iteration observability hook, fired from INSIDE
    the compiled SPMD while_loop: ``callback(k, resnorm)`` with the
    iteration index (0 = initial residual) and the GLOBAL recurrence
    residual norm — the value iteration ``k`` appends to
    ``info.resnorms`` (the explicit-residual double-check may later
    overwrite history entries whose recurrence value dipped below the
    criterion; the overwrite persists in ``info.resnorms`` but the hook
    saw the recurrence value — exactly the reference's callback-vs-
    history semantics, reference: src/krylov/cg.py:184-204).  Called
    ``numsteps + 1`` times, the reference's count (reference:
    src/krylov/cg.py:119-120, 202-204).  It deliberately does NOT
    receive ``(x, r)`` vectors: inside the SPMD program those are
    shard-local slabs and a host callback would fire once per shard — a
    misleading contract.  The hook fires from the rank-0 row shard only
    (with ``shard_rhs`` each rhs shard reports its own columns);
    delivery is unordered, so use ``k`` — not arrival order — to index
    iterations.  For full ``callback(x, r)`` parity, replay
    ``info.resnorms`` after the solve, or run single-device where both
    backends honor the reference contract exactly.
    """
    mesh = make_mesh() if mesh is None else mesh
    n_rows = mesh.shape[ROWS]

    if M_partition is not None:
        if M_diag is not None or M_factory is not None:
            raise ValueError(
                "M_partition is mutually exclusive with M_diag/M_factory"
            )
        if reorder is not None:
            raise ValueError(
                "M_partition is built on a fixed row ordering; reorder= "
                "would misalign it (reorder the matrix before partition_amg)"
            )
        if isinstance(A, (GridStencilOperator, ConstStencilOperator)):
            raise TypeError(
                "grid operators precondition via "
                "M_factory=multigrid_factory(...), not M_partition"
            )
        if M_partition.n_shards != n_rows:
            raise ValueError(
                f"M_partition built for {M_partition.n_shards} shards but "
                f"the mesh rows axis has {n_rows} devices"
            )

    b = jnp.asarray(b)

    if reorder is not None:
        # resolve once, permute the problem, recurse, un-permute the
        # iterate — uniform across plain and restarted solves
        if not (isinstance(A, CSROperator) or hasattr(A, "tocsr")):
            raise ValueError(
                "reorder= supports scipy/CSR operators (grid/banded "
                "operators are already bandwidth-ordered)"
            )
        import scipy.sparse

        spA = A
        if not scipy.sparse.issparse(spA):
            spA = scipy.sparse.csr_matrix(
                (np.asarray(A.data), np.asarray(A.indices),
                 np.asarray(A.indptr)),
                shape=A.shape,
            )
        from ..ops.reorder import invert_permutation, resolve_reorder

        spA = spA.tocsr()
        # "auto" reorders when RCM at least halves the bandwidth — the
        # quantity that sets the halo width the shards must exchange
        perm_np = resolve_reorder(spA, reorder)
        if perm_np is not None:
            A_p = spA[perm_np][:, perm_np].tocsr()
            pj = jnp.asarray(perm_np, jnp.int32)
            b_p = jnp.take(b, pj, axis=0)
            x0_p = (
                None if x0 is None
                else jnp.take(jnp.asarray(x0), pj, axis=0)
            )
            Md_p = (
                None if M_diag is None
                else jnp.take(jnp.asarray(M_diag), pj, axis=0)
            )
            sol_p, info = sharded_solve(
                solver, A_p, b_p, mesh=mesh, shard_rhs=shard_rhs,
                x0=x0_p, M_diag=Md_p, M_factory=M_factory, tol=tol,
                atol=atol, maxiter=maxiter, callback=callback,
                **solver_kwargs,
            )
            inv_np = invert_permutation(perm_np)
            xk = jnp.take(info.xk, jnp.asarray(inv_np, jnp.int32), axis=0)
            info = Info(
                info.success, xk, info.numsteps, info.resnorms,
                info.num_operations, info.arnoldi,
            )
            return (xk if info.success else None), info
        # reorder resolved to "keep user order": fall through

    # restarts (GMRES(m)) are a host-level outer loop: run one compiled
    # sharded solve per cycle, warm-starting from the previous iterate
    restart = solver_kwargs.pop("restart", None)
    if restart is not None:
        return _sharded_restarted(
            solver, A, b, restart=restart, mesh=mesh, shard_rhs=shard_rhs,
            x0=x0, M_diag=M_diag, M_factory=M_factory,
            M_partition=M_partition, tol=tol, atol=atol,
            maxiter=maxiter, callback=callback, **solver_kwargs,
        )

    # grid-stencil fast paths: 2-D layout end-to-end, grid stencil
    # locally, halo exchange in grid rows; blocked multi-RHS rides the same
    # path with a trailing column axis (vmapped local kernel)
    if (
        isinstance(A, (GridStencilOperator, ConstStencilOperator))
        and not shard_rhs
        and (
            b.ndim == 1
            or b.shape == A.grid
            or (b.ndim == 2 and b.shape[0] == A.grid[0] * A.grid[1])
            or (b.ndim == 3 and b.shape[:2] == A.grid)
        )
    ):
        return _sharded_solve_grid(
            solver, A, b, mesh=mesh, x0=x0, M_diag=M_diag,
            M_factory=M_factory, tol=tol, atol=atol, maxiter=maxiter,
            callback=callback, **solver_kwargs,
        )

    run = _make_general_run(
        solver, A, mesh=mesh, n_rows=n_rows, shard_rhs=shard_rhs,
        M_diag=M_diag, M_factory=M_factory, M_partition=M_partition,
        tol=tol, atol=atol, maxiter=maxiter, callback=callback,
        rhs_ndim=b.ndim, rhs_dtype=b.dtype, N=b.shape[0],
        solver_kwargs=solver_kwargs,
    )
    return run(b, x0)


def _make_general_run(
    solver, A, *, mesh, n_rows, shard_rhs, M_diag, M_factory, M_partition,
    tol, atol, maxiter, callback, rhs_ndim, rhs_dtype, N, solver_kwargs,
):
    """Build the reusable core of the general (flat-vector) sharded solve.

    Everything independent of the RHS *values* happens here, once:
    operator padding and partitioning, host->device transfer of the
    operator/preconditioner arrays, and the ``shard_map`` + ``jax.jit``
    program construction.  The returned ``run(b, x0=None)`` only
    permutes/pads the vectors and invokes the cached compiled program —
    repeated solves against the same operator (time stepping, RHS
    sequences) stop re-paying the ~seconds of per-call partitioning,
    transfer and retracing that a fresh ``sharded_solve`` call costs.
    """
    if maxiter is None:
        maxiter = N
    # any-N sharding (the reference accepts any N, reference:
    # src/krylov/cg.py:96-113): structured formats pad with unit-diagonal
    # rows / identity blocks — zero coupling to real rows, so padded
    # vector entries start at zero and stay exactly zero and trajectories
    # are bit-identical to the unpadded problem (same contract as
    # parallel/csr.py::pad_unit_diagonal)
    pad_rows = (-N) % n_rows
    if isinstance(A, BSROperator):
        R_bs, C_bs = A.blocksize
        nbrows0 = A.cols.shape[0]
        pad_blk = (-nbrows0) % n_rows
        pad_rows = pad_blk * R_bs  # vectors pad in whole blocks
        if pad_blk:
            if R_bs != C_bs:
                raise ValueError(
                    f"BSR identity padding needs square blocks; got "
                    f"{(R_bs, C_bs)} — choose a mesh whose rows axis "
                    f"divides {nbrows0} block rows"
                )
            A = _pad_bsr(A, pad_blk)
    elif pad_rows and isinstance(A, BandedOperator):
        # includes grid stencils whose fast path above did not engage:
        # they fall back to the flat banded route, padded
        A = _pad_banded(A, pad_rows)
    if pad_rows and M_diag is not None:
        M_diag = jnp.concatenate(
            [jnp.asarray(M_diag), jnp.ones(pad_rows, rhs_dtype)], axis=0
        )

    rhs_axis = RHS if (shard_rhs and rhs_ndim > 1) else None
    vec_spec = P(ROWS, *([rhs_axis] * (rhs_ndim - 1)))
    buf_spec = P(None, *([rhs_axis] * (rhs_ndim - 1)))

    if isinstance(A, BandedOperator):
        A_arrays = (A.coeffs,)
        A_specs = (P(None, ROWS),)
        make_local = partial(
            _local_banded, offsets=A.offsets, hermitian=A.hermitian
        )
    elif isinstance(A, BSROperator):
        nbrows = A.cols.shape[0]
        if nbrows % n_rows:
            raise ValueError(
                f"{nbrows} block rows not divisible by mesh rows {n_rows}"
            )
        A_arrays = (A.data, A.cols)
        A_specs = (P(ROWS, None, None), P(ROWS, None))
        make_local = partial(_local_bsr, n_global=A.shape[1])
    else:
        if isinstance(A, CSROperator) or hasattr(A, "tocsr"):
            part = partition_csr(A, n_rows)
        else:
            raise TypeError(f"cannot shard operator of type {type(A)}")
        A_arrays = (
            jnp.asarray(part["data"]),
            jnp.asarray(part["col"]),
            jnp.asarray(part["row"]),
        )
        A_specs = (P(ROWS, None),) * 3
        make_local = partial(
            _local_csr,
            n_local=part["n_local"],
            halo=part["halo"],
            mode=part["mode"],
        )

    import inspect

    _params = inspect.signature(solver).parameters
    accepts_fused = "fused_inner" in _params
    accepts_block = "block_inner" in _params
    accepts_batch = "batch_inner" in _params
    # solvers without an SPD `M` slot (bicgstab/qmr) take the
    # preconditioner as a LEFT preconditioner instead
    prec_param = "M" if "M" in _params else ("Ml" if "Ml" in _params else None)
    if prec_param is None and (
        M_diag is not None or M_factory is not None or M_partition is not None
    ):
        raise ValueError(f"{solver} accepts neither M nor Ml")

    M_arrays, M_specs = (), ()
    if M_partition is not None:
        if M_partition.n_pad != N + pad_rows:
            raise ValueError(
                f"M_partition built for padded size {M_partition.n_pad} "
                f"but the solve's padded size is {N + pad_rows} — build "
                "partition_amg on the same matrix"
            )
        M_arrays = M_partition.device_arrays()
        M_specs = M_partition.specs()
    n_A_arrays = len(A_arrays)

    def local_solve(b_l, x0_l, Md_l, *arrs):
        A_l, M_l = arrs[:n_A_arrays], arrs[n_A_arrays:]
        A_op = make_local(*A_l)
        inner = psum_inner(b_l.shape, ROWS)
        kw = dict(solver_kwargs)
        if callback is not None:
            kw["callback"] = ShardMonitor(callback, axis=ROWS)
        if accepts_fused and "fused_inner" not in kw:
            # pipelined solvers: all of an iteration's scalars in ONE psum
            kw["fused_inner"] = psum_fused_inner(ROWS)
        if accepts_block and "block_inner" not in kw:
            # block solvers: (k, k) Gram contractions, one psum each
            kw["block_inner"] = psum_block_inner(ROWS)
        if accepts_batch and "batch_inner" not in kw:
            # CGS orthogonalization: whole sweep in one psum
            kw["batch_inner"] = psum_batch_inner(ROWS)
        if M_diag is not None:
            from .._operators import DiagonalOperator

            kw[prec_param] = DiagonalOperator(Md_l)
        elif M_factory is not None:
            kw[prec_param] = M_factory(A_op)
        elif M_partition is not None:
            kw[prec_param] = M_partition.make_local(A_op, *M_l, axis=ROWS)
        xk, info = solver(
            A_op,
            b_l,
            inner=inner,
            x0=x0_l,
            tol=tol,
            atol=atol,
            maxiter=maxiter,
            backend="while_loop",
            **kw,
        )
        # success/numsteps are scalars per (rows x rhs)-shard program; with
        # rhs sharding each rhs shard may stop at a different iteration, so
        # expose them rank-1 along the rhs axis and combine on host.
        return (
            xk,
            jnp.reshape(info.success, (1,)),
            jnp.reshape(jnp.asarray(info.numsteps), (1,)),
            info.resnorms,
        )

    Md = (
        jnp.zeros((1,), rhs_dtype)  # placeholder, unused
        if M_diag is None
        else jnp.asarray(M_diag)
    )
    Md_spec = P() if M_diag is None else P(ROWS)

    one_spec = P(rhs_axis) if rhs_axis else P()
    fn = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(vec_spec, vec_spec, Md_spec) + A_specs + M_specs,
        out_specs=(vec_spec, one_spec, one_spec, buf_spec),
        check_vma=False,
    )
    jfn = jax.jit(fn)
    # realize the operator/preconditioner transfers now, not inside the
    # first solve's wall time
    jax.block_until_ready(
        jax.tree_util.tree_leaves((A_arrays, M_arrays, Md))
    )

    def run(b, x0=None):
        b = jnp.asarray(b)
        if b.ndim != rhs_ndim or b.shape[0] != N:
            raise ValueError(
                f"this sharded solver was built for RHS of ndim "
                f"{rhs_ndim} with {N} rows; got shape {b.shape}"
            )
        if pad_rows:
            zpad = jnp.zeros((pad_rows,) + b.shape[1:], b.dtype)
            b = jnp.concatenate([b, zpad], axis=0)
            if x0 is not None:
                x0 = jnp.concatenate([jnp.asarray(x0), zpad], axis=0)
        x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

        xk, success, numsteps, buf = jfn(b, x0, Md, *A_arrays, *M_arrays)
        if callback is not None:
            jax.effects_barrier()  # all monitor callbacks have landed

        if pad_rows:
            xk = xk[:N]
        numsteps = int(np.max(np.asarray(numsteps)))
        success = bool(np.all(np.asarray(success)))
        resnorms = np.asarray(buf)[: numsteps + 1]
        info = Info(success, xk, numsteps, resnorms, None, None)
        return (xk if success else None), info

    return run


def make_sharded_solver(
    solver,
    A,
    *,
    mesh=None,
    shard_rhs=False,
    M_diag=None,
    M_factory=None,
    M_partition=None,
    tol=1e-5,
    atol=1e-15,
    maxiter=None,
    callback=None,
    n_rhs=None,
    **solver_kwargs,
):
    """Build once, solve many: the reusable form of :func:`sharded_solve`.

    Returns ``run(b, x0=None) -> (sol, Info)`` with identical semantics
    and trajectories to ``sharded_solve`` called with the same
    arguments.  The expensive per-call work — operator partitioning and
    padding, host->device transfer of the operator/preconditioner
    arrays, and the ``shard_map``/``jax.jit`` program construction —
    happens HERE, once; each ``run`` call only pads the vectors and
    invokes the cached compiled program.  Use for time stepping, RHS
    sequences, and inner-outer methods.

    * ``n_rhs`` — blocked-RHS column count the solver is built for
      (``None``: single RHS).  Grid operators accept flat ``(N,)`` /
      grid ``(M, ny)`` vectors when ``n_rhs is None``, flat ``(N, k)`` /
      grid ``(M, ny, k)`` when ``n_rhs=k``; flat-vector operators take
      ``(N,)`` or ``(N, k)`` accordingly.
    * ``reorder=``/``restart=`` are not supported here — pre-permute the
      matrix (:func:`krylov_tpu.ops.reorder.rcm_permutation`) and use
      :func:`sharded_solve` for restarted cycles.
    """
    if "reorder" in solver_kwargs or "restart" in solver_kwargs:
        raise ValueError(
            "make_sharded_solver does not take reorder=/restart= — "
            "pre-permute the matrix and use sharded_solve for restarted "
            "cycles"
        )
    mesh = make_mesh() if mesh is None else mesh
    n_rows = mesh.shape[ROWS]

    if isinstance(A, (GridStencilOperator, ConstStencilOperator)) and not shard_rhs:
        if M_partition is not None:
            raise TypeError(
                "grid operators precondition via "
                "M_factory=multigrid_factory(...), not M_partition"
            )
        return _make_grid_run(
            solver, A, mesh=mesh, tol=tol, atol=atol, maxiter=maxiter,
            M_diag=M_diag, M_factory=M_factory, callback=callback,
            n_rhs=n_rhs,
            rhs_dtype=jnp.dtype(getattr(A, "dtype", jnp.float32)),
            solver_kwargs=solver_kwargs,
        )

    if M_partition is not None and (M_diag is not None or M_factory is not None):
        raise ValueError(
            "M_partition is mutually exclusive with M_diag/M_factory"
        )
    if M_partition is not None and M_partition.n_shards != n_rows:
        raise ValueError(
            f"M_partition built for {M_partition.n_shards} shards but "
            f"the mesh rows axis has {n_rows} devices"
        )
    N = A.shape[0]
    rhs_dtype = jnp.dtype(getattr(A, "dtype", None) or jnp.float32)
    return _make_general_run(
        solver, A, mesh=mesh, n_rows=n_rows, shard_rhs=shard_rhs,
        M_diag=M_diag, M_factory=M_factory, M_partition=M_partition,
        tol=tol, atol=atol, maxiter=maxiter, callback=callback,
        rhs_ndim=1 if n_rhs is None else 2, rhs_dtype=rhs_dtype,
        N=N, solver_kwargs=solver_kwargs,
    )


def _sharded_solve_grid(
    solver, A, b, *, mesh, x0, tol, atol, maxiter, M_diag=None,
    M_factory=None, callback=None, **solver_kwargs
):
    """Row-partitioned solve in the grid (M, ny[, k]) layout — see
    parallel/grid.py.  A trailing RHS-column axis rides along unsharded."""
    n_rhs = (
        b.shape[2] if b.ndim == 3
        else (b.shape[1] if b.ndim == 2 and b.shape != A.grid else None)
    )
    run = _make_grid_run(
        solver, A, mesh=mesh, tol=tol, atol=atol, maxiter=maxiter,
        M_diag=M_diag, M_factory=M_factory, callback=callback,
        n_rhs=n_rhs, rhs_dtype=jnp.asarray(b).dtype,
        solver_kwargs=solver_kwargs,
    )
    return run(b, x0)


def _make_grid_run(
    solver, A, *, mesh, tol, atol, maxiter, M_diag, M_factory, callback,
    n_rhs, rhs_dtype, solver_kwargs,
):
    """Build-once core of the grid-layout sharded solve (see
    :func:`_make_general_run`): coefficient padding, device transfer and
    the shard_map/jit program happen here; the returned ``run(b, x0)``
    normalizes and pads the vectors and calls the cached program.
    ``n_rhs`` fixes the blocked-RHS column count (None: single RHS)."""
    n_rows = mesh.shape[ROWS]
    Mg, ny = A.grid
    N = Mg * ny
    if maxiter is None:
        maxiter = N
    grid_shape = (Mg, ny) if n_rhs is None else (Mg, ny, n_rhs)

    is_const = isinstance(A, ConstStencilOperator)
    pad_grid = (-Mg) % n_rows
    coeffs_global = None if is_const else A.coeffs2d
    Md2 = (
        jnp.zeros((1, 1), rhs_dtype)  # placeholder, unused
        if M_diag is None
        else jnp.asarray(M_diag).reshape(Mg, ny)
    )
    if pad_grid:
        # pad GRID ROWS to the shard multiple.  Variable-coefficient
        # operators get unit-diagonal padded rows (identity maps the
        # all-zero padded entries to zero, and the diagonal is 1 for
        # smoothers); the const-stencil operator masks rows >= Mg in its
        # local matvec instead (its weights are global constants, and its
        # constant center weight is already nonzero).  Real rows near the
        # bottom edge read the padded x rows as zeros — identical to the
        # operators' zero Dirichlet boundary — so trajectories are
        # unchanged.
        if M_diag is not None:
            Md2 = jnp.concatenate(
                [Md2, jnp.ones((pad_grid, ny), rhs_dtype)], axis=0
            )
        if not is_const:
            cpad = jnp.zeros(
                (coeffs_global.shape[0], pad_grid) + coeffs_global.shape[2:],
                coeffs_global.dtype,
            )
            if 0 in A.offsets:
                # unit center coefficient on padded rows: padded vector
                # entries still stay exactly zero (identity maps 0 -> 0),
                # but diagonal-dividing solvers and M_factory smoothers
                # divide by 1 there instead of 0/0 = NaN
                cpad = cpad.at[A.offsets.index(0)].set(1)
            coeffs_global = jnp.concatenate([coeffs_global, cpad], axis=1)
    Mg_pad = Mg + pad_grid
    Md_spec = P() if M_diag is None else P(ROWS, None)

    if not is_const:
        offsets, ny_, herm = A.offsets, A.ny, A.hermitian
    m_local = Mg_pad // n_rows

    def local_solve(b_l, x0_l, Md_l, coeffs_l):
        if is_const:
            A_op = ShardedConstStencilOperator(
                A, m_local, axis=ROWS,
                m_valid=Mg if pad_grid else None,
            )
        else:
            A_op = ShardedGridStencilOperator(
                coeffs_l, offsets, ny_, axis=ROWS, hermitian=herm
            )

        def inner(u, v):
            # full grid contraction; per-column for blocked RHS
            axes = (0, 1)
            return lax.psum(jnp.sum(jnp.conj(u) * v, axis=axes), ROWS)

        import inspect

        kw = dict(solver_kwargs)
        if callback is not None:
            kw["callback"] = ShardMonitor(callback, axis=ROWS)
        _gp = inspect.signature(solver).parameters
        _pp = "M" if "M" in _gp else ("Ml" if "Ml" in _gp else None)
        if "fused_inner" in _gp and "fused_inner" not in kw:
            kw["fused_inner"] = psum_fused_inner(ROWS, vector_ndim=2)
        if "block_inner" in _gp and "block_inner" not in kw:
            kw["block_inner"] = psum_block_inner(ROWS)
        if "batch_inner" in _gp and "batch_inner" not in kw:
            kw["batch_inner"] = psum_batch_inner(ROWS, vector_ndim=2)
        if M_diag is not None:
            from .._operators import DiagonalOperator

            kw[_pp] = DiagonalOperator(Md_l)
        elif M_factory is not None:
            kw[_pp] = M_factory(A_op)
        xk, info = solver(
            A_op, b_l, inner=inner, x0=x0_l, tol=tol, atol=atol,
            maxiter=maxiter, backend="while_loop", **kw,
        )
        return (
            xk,
            jnp.reshape(info.success, (1,)),
            jnp.reshape(jnp.asarray(info.numsteps), (1,)),
            info.resnorms,
        )

    coeff_arr = (
        jnp.zeros((1, 1, 1), rhs_dtype) if is_const else coeffs_global
    )
    coeff_spec = P() if is_const else P(None, ROWS, None)
    grid_ndim = 2 if n_rhs is None else 3
    vec_spec = P(ROWS, *([None] * (grid_ndim - 1)))
    fn = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(vec_spec, vec_spec, Md_spec, coeff_spec),
        out_specs=(vec_spec, P(), P(), P()),
        check_vma=False,
    )
    jfn = jax.jit(fn)
    # realize the coefficient transfer at build, not inside the first solve
    jax.block_until_ready(jax.tree_util.tree_leaves((coeff_arr, Md2)))

    def run(b, x0=None):
        b = jnp.asarray(b)
        # normalize b to the grid layout, remembering the caller's shape
        flat_shape = (
            (Mg * ny,) if n_rhs is None else (Mg * ny, n_rhs)
        )
        if b.shape not in (flat_shape, grid_shape):
            raise ValueError(
                f"this sharded solver was built for RHS shape "
                f"{flat_shape} or {grid_shape}; got {b.shape}"
            )
        flat_in = b.shape == flat_shape
        b2 = b.reshape(grid_shape)
        x02 = (
            jnp.zeros_like(b2)
            if x0 is None
            else jnp.asarray(x0).reshape(b2.shape)
        )
        if pad_grid:
            gpad = jnp.zeros((pad_grid,) + b2.shape[1:], b2.dtype)
            b2 = jnp.concatenate([b2, gpad], axis=0)
            x02 = jnp.concatenate([x02, gpad], axis=0)

        xk, success, numsteps, buf = jfn(b2, x02, Md2, coeff_arr)
        if callback is not None:
            jax.effects_barrier()  # all monitor callbacks have landed

        if pad_grid:
            xk = xk[:Mg]
        numsteps = int(np.max(np.asarray(numsteps)))
        success = bool(np.all(np.asarray(success)))
        resnorms = np.asarray(buf)[: numsteps + 1]
        if flat_in:
            xk = xk.reshape(b.shape)
        info = Info(success, xk, numsteps, resnorms, None, None)
        return (xk if success else None), info

    return run


def _pad_banded(A, pad):
    """Append ``pad`` unit-diagonal rows to a banded operator.

    Real rows' coefficients into the padded column range were already
    zero (the banded contract zeroes out-of-range columns), and padded
    rows carry only the unit diagonal — so padded entries of every
    solver vector stay exactly zero and trajectories are bit-identical
    (the banded twin of :func:`~krylov_tpu.parallel.csr.pad_unit_diagonal`)."""
    coeffs = jnp.asarray(A.coeffs)
    ndiag, N0 = coeffs.shape
    coeffs2 = jnp.concatenate(
        [coeffs, jnp.zeros((ndiag, pad), coeffs.dtype)], axis=1
    )
    offsets = tuple(A.offsets)
    if 0 in offsets:
        coeffs2 = coeffs2.at[offsets.index(0), N0:].set(1)
    else:
        diag = jnp.concatenate(
            [jnp.zeros((1, N0), coeffs.dtype),
             jnp.ones((1, pad), coeffs.dtype)], axis=1,
        )
        coeffs2 = jnp.concatenate([coeffs2, diag], axis=0)
        offsets = offsets + (0,)
    return BandedOperator(coeffs2, offsets, hermitian=A.hermitian)


def _pad_bsr(A, pad_blk):
    """Append ``pad_blk`` identity-block rows to an ELL-padded BSR
    operator (square blocks).  Same zero-coupling contract as
    :func:`_pad_banded`."""
    nbrows, max_blocks = A.cols.shape
    R, _ = A.blocksize
    dpad = jnp.zeros((pad_blk * max_blocks, R, R), A.data.dtype)
    dpad = dpad.at[::max_blocks].set(jnp.eye(R, dtype=A.data.dtype))
    cpad = jnp.zeros((pad_blk, max_blocks), A.cols.dtype)
    cpad = cpad.at[:, 0].set(
        nbrows + jnp.arange(pad_blk, dtype=A.cols.dtype)
    )
    return BSROperator(
        jnp.concatenate([A.data, dpad], axis=0),
        jnp.concatenate([A.cols, cpad], axis=0),
        (A.shape[0] + pad_blk * R, A.shape[1] + pad_blk * R),
    )


def _local_banded(coeffs, *, offsets, hermitian):
    return ShardedBandedOperator(coeffs, offsets, axis=ROWS, hermitian=hermitian)


def _local_csr(data, col, row, *, n_local, halo, mode):
    return ShardedCSROperator(data[0], col[0], row[0], n_local, halo, mode, axis=ROWS)


def _local_bsr(data, cols, *, n_global):
    return ShardedBSROperator(data, cols, n_global, axis=ROWS)


def _sharded_restarted(
    solver, A, b, *, restart, mesh, shard_rhs, x0, M_diag, M_factory=None,
    M_partition=None, tol, atol, maxiter, callback=None, **solver_kwargs,
):
    """Restarted sharded solve: one compiled cycle per outer iteration.

    Convergence is judged against the initial residual's criterion across
    cycles (same contract as the single-chip gmres(restart=m)).  A
    ``callback`` monitor fires per cycle with cycle-local iteration
    indices (each cycle restarts ``k`` at 0 for its warm-started
    residual)."""
    N = b.shape[0] if b.ndim == 1 else int(np.prod(b.shape))
    total_max = N if maxiter is None else maxiter
    m = min(restart, total_max)

    x = x0
    resnorms = None
    criterion = None
    numsteps = 0
    success = False
    while True:
        cycle_max = min(m, total_max - numsteps)
        kw = dict(
            mesh=mesh, shard_rhs=shard_rhs, x0=x, M_diag=M_diag,
            M_factory=M_factory, M_partition=M_partition,
            maxiter=cycle_max, callback=callback, **solver_kwargs,
        )
        if criterion is None:
            sol, info = sharded_solve(solver, A, b, tol=tol, atol=atol, **kw)
            # per-RHS-column criterion, matching single-cycle semantics
            criterion = np.maximum(tol * np.asarray(info.resnorms[0]), atol)
            resnorms = np.asarray(info.resnorms)
        else:
            sol, info = sharded_solve(solver, A, b, tol=0.0, atol=criterion, **kw)
            resnorms = np.concatenate([resnorms, np.asarray(info.resnorms)[1:]])
        numsteps += info.numsteps
        x = info.xk
        success = bool(info.success)
        if success or numsteps >= total_max or info.numsteps == 0:
            break

    info = Info(success, x, numsteps, resnorms, None, None)
    return (x if success else None), info
