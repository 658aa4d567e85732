"""Distributed algebraic multigrid over a row-partitioned mesh.

No reference counterpart (the reference ships no preconditioners at all —
``M`` is always user-supplied, reference: src/krylov/cg.py:33-36; and it has
no distribution layer, SURVEY.md §2.3).  This is the general-sparsity twin of
:class:`~krylov_tpu.multigrid.ShardedGalerkinMultigrid`: where the geometric
cycles need a grid stencil, AMG coarsens the MATRIX, so variable coefficients
and unstructured meshes shard too.

Split of labor:

* **Setup** (once, host, scipy): the same smoothed-aggregation coarsening as
  :class:`~krylov_tpu.amg.AMGPreconditioner`, but built on the zero-padded
  fine matrix so the hierarchy's row blocks align exactly with
  :func:`~krylov_tpu.parallel.sharded_solve`'s row partition.  Each sharded
  level stores its row slab of the level matrix (:func:`partition_csr`) and
  its fine-row slab of the prolongator as padded COO triplets.
* **Apply** (every iteration, on device, inside ``shard_map``): smoothing at
  the fine level rides the SOLVE'S OWN operator (the halo-exchanging
  ShardedCSR matvec — one ppermute pair per sweep); deeper sharded
  levels smooth through their own :class:`ShardedCSROperator`.  Grid
  transfer is where AMG differs from the geometric cycles: aggregates cross
  shard boundaries, so restriction is a shard-local ``P_s^H d_s`` partial
  followed by ONE collective —

  - ``psum`` of the (small) first-replicated-level residual when the next
    level is the replicated tail, or
  - ``psum_scatter`` when the next level is itself sharded (the
    reduce-scatter dual: each shard keeps exactly its coarse row block),
    with the matching ``all_gather`` on the way back up.

* **Replicated tail**: after ``n_sharded_levels`` coarsenings the problem is
  ~4^levels smaller, so every shard redundantly runs the same single-device
  :class:`~krylov_tpu.amg.AMGPreconditioner` V-cycle on it — replicated
  compute instead of a serial bottleneck.

``AMGPartition.as_global()`` returns the exact same cycle with every
collective elided (``axis=None``) — a single-device twin used to pin
trajectory parity of the distributed cycle in tests.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from jax.tree_util import register_pytree_node_class

from ..amg import AMGPreconditioner, _lmax_dinv_a, _smoothed_prolongator
from .csr import ShardedCSROperator, pad_unit_diagonal, partition_csr
from .mesh import ROWS

__all__ = ["AMGPartition", "partition_amg"]


def _split_prolongator(Ps, n_shards):
    """Split prolongator rows into shard slabs of padded COO triplets.

    Returns stacked ``(dat, rowf, colc)`` of shape ``(S, nnz_max)``:
    ``rowf`` is the shard-local fine row, ``colc`` the GLOBAL coarse
    column.  nnz padding carries zero data pointing at (row 0, col 0) —
    a zero contribution to both segment sums."""
    n_fine = Ps.shape[0]
    n_loc = n_fine // n_shards
    blks = [Ps[s * n_loc : (s + 1) * n_loc].tocoo() for s in range(n_shards)]
    nnz_max = max(max(b.nnz for b in blks), 1)
    dat = np.zeros((n_shards, nnz_max), dtype=Ps.dtype)
    rowf = np.zeros((n_shards, nnz_max), dtype=np.int32)
    colc = np.zeros((n_shards, nnz_max), dtype=np.int32)
    for s, b in enumerate(blks):
        dat[s, : b.nnz] = b.data
        rowf[s, : b.nnz] = b.row
        colc[s, : b.nnz] = b.col
    return dat, rowf, colc


@register_pytree_node_class
class ShardedAMG:
    """The distributed V-cycle (built by :meth:`AMGPartition.make_local`
    inside ``shard_map``; with ``axis=None`` it is the collective-free
    single-device twin).  ``z = M @ r`` on the local row slab."""

    def __init__(self, ops, dinvs, p_dat, p_rowf, p_colc, tail, *,
                 n_locals, n_nexts, jw, smooth, smoother, lmaxs, axis):
        self._ops = tuple(ops)          # level matvecs (level 0: solve's A)
        self._dinvs = tuple(dinvs)      # local 1/diag per sharded level
        self._p_dat = tuple(p_dat)      # prolongator slab triplets
        self._p_rowf = tuple(p_rowf)
        self._p_colc = tuple(p_colc)
        self._tail = tail               # replicated AMGPreconditioner | None
        self._n_locals = tuple(int(n) for n in n_locals)
        self._n_nexts = tuple(int(n) for n in n_nexts)
        self._jw = tuple(float(w) for w in jw)
        self.smooth = int(smooth)
        self.smoother = smoother
        self._lmaxs = tuple(float(v) for v in lmaxs)
        self.axis = axis

    # -- observables ----------------------------------------------------
    @property
    def shape(self):
        n = self._n_locals[0]
        return (n, n)

    @property
    def dtype(self):
        return self._dinvs[0].dtype

    @property
    def n_sharded_levels(self):
        return len(self._ops)

    hermitian = True

    # -- smoothing -------------------------------------------------------
    def _dinv_mul(self, level, v):
        d = self._dinvs[level]
        return d.reshape(d.shape + (1,) * (v.ndim - 1)) * v

    def _jacobi(self, level, z, r, iters, from_zero=False):
        A = self._ops[level]
        w = self._jw[level]
        if from_zero:
            z = w * self._dinv_mul(level, r)
            iters -= 1
        for _ in range(iters):
            z = z + w * self._dinv_mul(level, r - A @ z)
        return z

    def _chebyshev(self, level, z, r, from_zero=False):
        """Degree-(smooth+1) Chebyshev polynomial in D⁻¹A over the upper
        spectrum (same recurrence as the single-device cycle; the matvec
        is the halo-exchanging sharded operator)."""
        A = self._ops[level]
        lmax = 1.1 * self._lmaxs[level]
        lmin = lmax / 30.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        res = self._dinv_mul(level, r if from_zero else r - A @ z)
        if from_zero:
            z = jnp.zeros_like(r)
        d = res / theta
        for _ in range(self.smooth):
            z = z + d
            res = res - self._dinv_mul(level, A @ d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return z + d

    def _smooth_level(self, level, z, r, from_zero=False):
        if self.smoother == "chebyshev":
            return self._chebyshev(level, z, r, from_zero=from_zero)
        return self._jacobi(level, z, r, self.smooth, from_zero=from_zero)

    # -- grid transfer ----------------------------------------------------
    def _restrict(self, level, d):
        """Shard-local partial of ``P^H d`` over the FULL next level."""
        dat = jnp.conj(self._p_dat[level])
        dat = dat.reshape(dat.shape + (1,) * (d.ndim - 1))
        prod = dat * d[self._p_rowf[level]]
        return jax.ops.segment_sum(
            prod, self._p_colc[level], num_segments=self._n_nexts[level]
        )

    def _prolong(self, level, e):
        """Local fine rows of ``P e`` (``e`` is the full next-level vector)."""
        dat = self._p_dat[level]
        dat = dat.reshape(dat.shape + (1,) * (e.ndim - 1))
        prod = dat * e[self._p_colc[level]]
        return jax.ops.segment_sum(
            prod, self._p_rowf[level], num_segments=self._n_locals[level]
        )

    # -- the cycle ---------------------------------------------------------
    def _vcycle(self, level, r):
        z = self._smooth_level(level, None, r, from_zero=True)
        if level == len(self._ops) - 1 and self._tail is None:
            return z  # degenerate: coarsening stalled at the fine level
        d = r - self._ops[level] @ z
        partial = self._restrict(level, d)
        if level == len(self._ops) - 1:
            rc = (
                partial if self.axis is None
                else lax.psum(partial, self.axis)
            )
            e = self._tail @ rc
        elif self.axis is None:
            e = self._vcycle(level + 1, partial)
        else:
            rc = lax.psum_scatter(
                partial, self.axis, scatter_dimension=0, tiled=True
            )
            e_loc = self._vcycle(level + 1, rc)
            e = lax.all_gather(e_loc, self.axis, axis=0, tiled=True)
        z = z + self._prolong(level, e)
        return self._smooth_level(level, z, r)

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        return (
            (self._ops, self._dinvs, self._p_dat, self._p_rowf,
             self._p_colc, self._tail),
            (self._n_locals, self._n_nexts, self._jw, self.smooth,
             self.smoother, self._lmaxs, self.axis),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        ops, dinvs, p_dat, p_rowf, p_colc, tail = children
        n_locals, n_nexts, jw, smooth, smoother, lmaxs, axis = aux
        return cls(ops, dinvs, p_dat, p_rowf, p_colc, tail,
                   n_locals=n_locals, n_nexts=n_nexts, jw=jw, smooth=smooth,
                   smoother=smoother, lmaxs=lmaxs, axis=axis)


class AMGPartition:
    """Host-side distributed-AMG setup; feed to
    :func:`~krylov_tpu.parallel.sharded_solve` as ``M_partition=``.

    Built by :func:`partition_amg`.  Exposes the stacked device arrays +
    shard specs that ``sharded_solve`` threads through ``shard_map``, and
    ``make_local`` which assembles the :class:`ShardedAMG` cycle around the
    solve's own sharded fine-level operator."""

    def __init__(self, *, n_shards, shape, n_pad, levels, tail, jw, lmaxs,
                 smooth, smoother, host_As):
        self.n_shards = int(n_shards)
        self.shape = tuple(shape)            # global UNPADDED (N, N)
        self.n_pad = int(n_pad)              # padded fine size
        self._levels = levels                # list of per-level dicts
        self._tail = tail                    # AMGPreconditioner | None
        self._jw = tuple(jw)
        self._lmaxs = tuple(lmaxs)
        self.smooth = int(smooth)
        self.smoother = smoother
        self._host_As = host_As              # padded scipy per sharded level

    @property
    def n_local_fine(self):
        return self.n_pad // self.n_shards

    @property
    def n_sharded_levels(self):
        return len(self._levels)

    @property
    def level_sizes(self):
        sizes = tuple(a.shape[0] for a in self._host_As)
        if self._tail is not None:
            sizes = sizes + self._tail.level_sizes
        return sizes

    # -- sharded_solve interface -----------------------------------------
    def device_arrays(self):
        """Flat tuple of arrays/pytrees for ``shard_map`` (order matches
        :meth:`specs`; consumed back by :meth:`make_local`)."""
        out = []
        for lv in self._levels:
            out.extend([lv["dinv"], lv["p_dat"], lv["p_rowf"], lv["p_colc"]])
            if lv["Apart"] is not None:
                out.extend(
                    [lv["Apart"]["data"], lv["Apart"]["col"],
                     lv["Apart"]["row"]]
                )
        if self._tail is not None:
            out.append(self._tail)
        return tuple(out)

    def specs(self):
        out = []
        for lv in self._levels:
            n_stacked = 4 + (0 if lv["Apart"] is None else 3)
            out.extend([P(ROWS, None)] * n_stacked)
        if self._tail is not None:
            out.append(P())  # replicated tail pytree (spec prefix)
        return tuple(out)

    def make_local(self, A_op, *arrs, axis=ROWS):
        """Assemble the local cycle inside ``shard_map`` (stacked arrays
        arrive with a leading length-1 shard axis; strip it)."""
        n_loc_op = getattr(A_op, "n_local", None)
        if n_loc_op is not None and int(n_loc_op) != self.n_local_fine:
            raise ValueError(
                f"AMG partition built for local rows {self.n_local_fine} "
                f"but the sharded operator has n_local={int(n_loc_op)} — "
                "build partition_amg on the same matrix/ordering as A"
            )
        arrs = list(arrs)
        ops, dinvs, p_dat, p_rowf, p_colc = [], [], [], [], []
        n_locals, n_nexts = [], []
        for i, lv in enumerate(self._levels):
            dinv, dat, rowf, colc = (a[0] for a in arrs[:4])
            del arrs[:4]
            if lv["Apart"] is None:
                ops.append(A_op if i == 0 else None)
            else:
                d_, c_, r_ = (a[0] for a in arrs[:3])
                del arrs[:3]
                ap = lv["Apart"]
                ops.append(ShardedCSROperator(
                    d_, c_, r_, ap["n_local"], ap["halo"], ap["mode"],
                    axis=axis,
                ))
            dinvs.append(dinv)
            p_dat.append(dat)
            p_rowf.append(rowf)
            p_colc.append(colc)
            n_locals.append(lv["n_local"])
            n_nexts.append(lv["n_next"])
        tail = arrs.pop() if self._tail is not None else None
        assert not arrs
        return ShardedAMG(
            ops, dinvs, p_dat, p_rowf, p_colc, tail,
            n_locals=n_locals, n_nexts=n_nexts, jw=self._jw,
            smooth=self.smooth, smoother=self.smoother, lmaxs=self._lmaxs,
            axis=axis,
        )

    # -- single-device twin -------------------------------------------------
    def padded_matrix(self, level=0):
        """The padded scipy matrix of a sharded level (level 0 = the fine
        matrix the sharded solve actually runs on)."""
        return self._host_As[level]

    def as_global(self):
        """The identical cycle with every collective elided: a single-device
        preconditioner on the PADDED problem (``padded_matrix(0)``), used to
        pin trajectory parity of the distributed cycle."""
        from .._operators import as_operator

        ops, dinvs, p_dat, p_rowf, p_colc = [], [], [], [], []
        n_locals, n_nexts = [], []
        for i, lv in enumerate(self._levels):
            ops.append(as_operator(self._host_As[i]))
            d = self._host_As[i].diagonal()
            dinvs.append(jnp.asarray(1.0 / np.where(d != 0, d, 1.0)))
            S, nnz = lv["p_dat"].shape
            n_loc = lv["n_local"]
            offs = (np.arange(S, dtype=np.int32) * n_loc)[:, None]
            p_dat.append(jnp.asarray(lv["p_dat"].reshape(-1)))
            p_rowf.append(jnp.asarray((lv["p_rowf"] + offs).reshape(-1)))
            p_colc.append(jnp.asarray(lv["p_colc"].reshape(-1)))
            n_locals.append(self._host_As[i].shape[0])
            n_nexts.append(lv["n_next"])
        return ShardedAMG(
            ops, dinvs, p_dat, p_rowf, p_colc, self._tail,
            n_locals=n_locals, n_nexts=n_nexts, jw=self._jw,
            smooth=self.smooth, smoother=self.smoother, lmaxs=self._lmaxs,
            axis=None,
        )


def partition_amg(A, n_shards, *, theta=0.08, smooth=2, omega=2.0 / 3.0,
                  coarse_size=400, max_levels=12, dtype=None,
                  smoother="jacobi", smooth_prolongator=True,
                  n_sharded_levels=1):
    """Build a distributed smoothed-aggregation AMG hierarchy (host side).

    Same knobs as :meth:`AMGPreconditioner.from_scipy
    <krylov_tpu.amg.AMGPreconditioner.from_scipy>`, plus:

    * ``n_shards`` — must equal the rows-axis size of the solve's mesh.
    * ``n_sharded_levels`` — how many levels stay row-partitioned before
      the hierarchy is gathered into the replicated tail.  1 (default)
      shards only the fine level: one ``psum`` of the ~4x-smaller coarse
      residual per cycle.  Each extra sharded level trades replicated
      memory for a ``psum_scatter``/``all_gather`` pair per cycle.

    The fine level is zero-padded to the shard multiple exactly like
    :func:`~krylov_tpu.parallel.csr.partition_csr` pads the solve's matrix,
    so pass the SAME matrix (same ordering) to both.
    """
    import scipy.sparse

    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if not scipy.sparse.issparse(A):
        if hasattr(A, "indptr"):  # krylov_tpu CSROperator
            A = scipy.sparse.csr_matrix(
                (np.asarray(A.data), np.asarray(A.indices),
                 np.asarray(A.indptr)),
                shape=A.shape,
            )
        else:
            A = scipy.sparse.csr_matrix(np.asarray(A))
    A = A.tocsr()
    if A.shape[0] != A.shape[1]:
        raise ValueError("AMG needs a square matrix")
    if dtype is not None:
        A = A.astype(dtype)
    N = A.shape[0]
    n_sharded_levels = max(1, int(n_sharded_levels))

    Al = pad_unit_diagonal(A, (-N) % n_shards)
    levels, host_As, jw, lmaxs = [], [], [], []
    A_tail = None
    for l in range(n_sharded_levels):
        host_As.append(Al)
        d = Al.diagonal()
        dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(Al.dtype)
        n_loc = Al.shape[0] // n_shards
        lv = {
            "dinv": dinv.reshape(n_shards, n_loc),
            "n_local": n_loc,
            "Apart": None if l == 0 else partition_csr(Al, n_shards),
        }
        step = _smoothed_prolongator(Al, theta, smooth_prolongator)
        if step is None:
            # coarsening stalled (e.g. diagonal matrix): sharded smoothing
            # only — on exactly such matrices Jacobi is a near-exact solve
            lmax = _lmax_dinv_a(Al)
            jw.append(omega if lmax <= 2.0 else omega * 2.0 / lmax)
            lmaxs.append(lmax)
            lv.update(
                p_dat=np.zeros((n_shards, 1), Al.dtype),
                p_rowf=np.zeros((n_shards, 1), np.int32),
                p_colc=np.zeros((n_shards, 1), np.int32),
                n_next=1,
            )
            levels.append(lv)
            A_tail = None
            break
        Ps, Ac, lmax = step[0], step[1], step[2]
        jw.append(omega if lmax <= 2.0 else omega * 2.0 / lmax)
        lmaxs.append(lmax)
        last_sharded = (
            l + 1 == n_sharded_levels
            or Ac.shape[0] <= max(coarse_size, 8 * n_shards)
        )
        if not last_sharded:
            # pad the coarse level to the shard multiple so psum_scatter
            # tiles cleanly; P gains zero columns (nothing maps there)
            padc = (-Ac.shape[0]) % n_shards
            Ac = pad_unit_diagonal(Ac, padc)
            if padc:
                Ps = Ps.copy()
                Ps.resize((Ps.shape[0], Ac.shape[0]))
        if dtype is not None:
            Ps, Ac = Ps.astype(dtype), Ac.astype(dtype)
        dat, rowf, colc = _split_prolongator(Ps.tocsr(), n_shards)
        lv.update(p_dat=dat, p_rowf=rowf, p_colc=colc, n_next=Ac.shape[0])
        levels.append(lv)
        A_tail = Ac
        if last_sharded:
            break
        Al = Ac

    tail = None
    if A_tail is not None:
        tail = AMGPreconditioner.from_scipy(
            A_tail, theta=theta, smooth=smooth, omega=omega,
            coarse_size=coarse_size,
            max_levels=max(1, max_levels - len(levels)), dtype=dtype,
            smooth_prolongator=smooth_prolongator, smoother=smoother,
        )
    return AMGPartition(
        n_shards=n_shards, shape=A.shape, n_pad=host_As[0].shape[0],
        levels=levels, tail=tail, jw=jw, lmaxs=lmaxs, smooth=smooth,
        smoother=smoother, host_As=host_As,
    )
