"""Geometric multigrid V-cycle preconditioner for constant-coefficient
stencils (the Poisson/Laplacian family).

Extension beyond the reference (which has no preconditioners of its own —
``M`` is always user-supplied, reference: src/krylov/cg.py:33-36): one
V(s,s) cycle per application, used as the SPD-ish ``M`` of CG/MINRES or
the ``Ml`` of the two-sided family.  Krylov iteration counts on the 2-D
Poisson model problem drop from O(n) to O(10), which makes it the largest
single time-to-tolerance lever in this library — far beyond kernel-level
tuning.

Device mapping: every level's operator is a half-resolution
:class:`~krylov_tpu.ops.stencil.ConstStencilOperator` (a coefficient-free
fused stencil); restriction/prolongation are reshape-sums / repeats that
XLA fuses into bandwidth-bound elementwise passes.  The level
count is static, so the whole V-cycle inlines into the compiled
``while_loop`` solver with zero host round-trips.

Scaling convention: the unit-spacing stencil ``h^2 (-Lap)`` is reused
UNCHANGED at every level; coarsening doubles ``h``, so the restricted
residual picks up the factor ``h_c^2 / h^2 = 4`` — folded into the
restriction scale ``4 / 2^d``.  Transfer is order-2: cell-centered
multilinear interpolation with its exact transpose as restriction
(full weighting) — see the note at :func:`_lin_prolong_axis`; the
piecewise-constant (block repeat / block sum) pair is kept only for
the traced shard-local Galerkin coarsening, where it is exact
variational (``A_c = P^T A P``) and therefore safe, if slower.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class

from .ops.stencil import ConstStencilOperator
from . import _precision as prec


def _halve_all(shape_nd):
    return tuple(s // 2 for s in shape_nd)


def _can_halve(shape_nd, min_side=4):
    return all(s % 2 == 0 and s // 2 >= min_side for s in shape_nd)


def _block_restrict(x, nd, scale):
    """Scaled 2x..x2 block sum over the leading ``nd`` spatial axes."""
    for ax in range(nd):
        s = x.shape
        x = x.reshape(s[:ax] + (s[ax] // 2, 2) + s[ax + 1:]).sum(axis=ax + 1)
    return x * scale


def _block_prolong(x, nd):
    """Piecewise-constant interpolation: repeat each cell 2x per axis."""
    for ax in range(nd):
        x = jnp.repeat(x, 2, axis=ax)
    return x


# -- order-2 (cell-centered bilinear) transfer --------------------------
#
# Piecewise-constant transfer has interpolation order 1; the two-grid
# accuracy rule m_P + m_R > 2m (m = 1 for 2nd-order elliptic operators)
# then fails (1 + 1 = 2), which is exactly the observed mesh-DEPENDENT
# V-cycle: iteration counts grow with every refinement and the 4096^2
# bench case stalls.  Cell-centered linear interpolation (1-D weights
# 3/4, 1/4 toward the nearer/farther coarse neighbor; tensor-product
# across axes) and its exact transpose as restriction give order 2 + 2,
# restoring the textbook mesh-independent rate (~0.1 per V(2,2) cycle).
#
# Boundary ghosts use the Dirichlet convention ``c[-1] = -c[0]`` (the
# error vanishes at the wall half a cell outside the boundary cell
# center), matching the rediscretized Dirichlet coarse stencils.
# Restriction is the EXACT adjoint of prolongation (including the ghost
# corrections), which keeps the equal-pre/post-smoothing V-cycle
# symmetric — the property CG needs from its preconditioner.


def _lin_prolong_axis(x, ax):
    m = x.shape[ax]

    def sl(a, b):
        s = [slice(None)] * x.ndim
        s[ax] = slice(a, b)
        return tuple(s)

    first, last = x[sl(0, 1)], x[sl(m - 1, m)]
    cm = jnp.concatenate([-first, x[sl(0, m - 1)]], axis=ax)
    cp = jnp.concatenate([x[sl(1, m)], -last], axis=ax)
    even = 0.75 * x + 0.25 * cm
    odd = 0.75 * x + 0.25 * cp
    y = jnp.stack([even, odd], axis=ax + 1)
    return y.reshape(x.shape[:ax] + (2 * m,) + x.shape[ax + 1:])


def _lin_prolong(x, nd):
    """Cell-centered multilinear interpolation over the leading nd axes."""
    for ax in range(nd):
        x = _lin_prolong_axis(x, ax)
    return x


def _lin_restrict_axis(x, ax):
    m = x.shape[ax] // 2
    xr = x.reshape(x.shape[:ax] + (m, 2) + x.shape[ax + 1:])

    def sel(k):
        s = [slice(None)] * xr.ndim
        s[ax + 1] = k
        return xr[tuple(s)]

    even, odd = sel(0), sel(1)

    def sl(arr, a, b):
        s = [slice(None)] * arr.ndim
        s[ax] = slice(a, b)
        return arr[tuple(s)]

    zero = jnp.zeros_like(sl(even, 0, 1))
    even_next = jnp.concatenate([sl(even, 1, m), zero], axis=ax)
    odd_prev = jnp.concatenate([zero, sl(odd, 0, m - 1)], axis=ax)
    t = 0.75 * (even + odd) + 0.25 * even_next + 0.25 * odd_prev
    # exact adjoint of the Dirichlet ghost terms at the two walls
    tf = sl(t, 0, 1) - 0.25 * sl(even, 0, 1)
    tl = sl(t, m - 1, m) - 0.25 * sl(odd, m - 1, m)
    return jnp.concatenate([tf, sl(t, 1, m - 1), tl], axis=ax)


def _lin_restrict(x, nd, scale):
    """Exact transpose of :func:`_lin_prolong`, scaled (full weighting)."""
    for ax in range(nd):
        x = _lin_restrict_axis(x, ax)
    return x * scale


def _lead_lin_restrict_axis(x, axis):
    """Sharded-axis twin of :func:`_lin_restrict_axis` for the leading
    (row-partitioned) grid axis inside ``shard_map``: one boundary plane
    travels to each mesh neighbor by ``ppermute`` (zeros arrive at the
    mesh edges), and the Dirichlet ghost corrections apply only on the
    first/last shard — so the distributed restriction is exactly the
    single-device operator."""
    from .parallel.banded import _identity_perm_shift

    m = x.shape[0] // 2
    xr = x.reshape((m, 2) + x.shape[1:])
    even, odd = xr[:, 0], xr[:, 1]
    n_sh = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    ev_next = lax.ppermute(even[:1], axis, _identity_perm_shift(n_sh, -1))
    od_prev = lax.ppermute(odd[-1:], axis, _identity_perm_shift(n_sh, +1))
    even_next = jnp.concatenate([even[1:], ev_next], axis=0)
    odd_prev = jnp.concatenate([od_prev, odd[:-1]], axis=0)
    t = 0.75 * (even + odd) + 0.25 * even_next + 0.25 * odd_prev
    t = t.at[:1].add(jnp.where(idx == 0, -0.25 * even[:1], 0))
    t = t.at[m - 1:].add(jnp.where(idx == n_sh - 1, -0.25 * odd[-1:], 0))
    return t


def _lead_lin_prolong_axis(x, axis):
    """Sharded-axis twin of :func:`_lin_prolong_axis` (see above)."""
    from .parallel.banded import _identity_perm_shift

    n_sh = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    c_prev = lax.ppermute(x[-1:], axis, _identity_perm_shift(n_sh, +1))
    c_next = lax.ppermute(x[:1], axis, _identity_perm_shift(n_sh, -1))
    c_prev = jnp.where(idx == 0, -x[:1], c_prev)
    c_next = jnp.where(idx == n_sh - 1, -x[-1:], c_next)
    cm = jnp.concatenate([c_prev, x[:-1]], axis=0)
    cp = jnp.concatenate([x[1:], c_next], axis=0)
    even = 0.75 * x + 0.25 * cm
    odd = 0.75 * x + 0.25 * cp
    y = jnp.stack([even, odd], axis=1)
    return y.reshape((2 * x.shape[0],) + x.shape[1:])


def _sharded_lin_restrict(x, nd, scale, axis):
    x = _lead_lin_restrict_axis(x, axis)
    for ax in range(1, nd):
        x = _lin_restrict_axis(x, ax)
    return x * scale


def _sharded_lin_prolong(x, nd, axis):
    x = _lead_lin_prolong_axis(x, axis)
    for ax in range(1, nd):
        x = _lin_prolong_axis(x, ax)
    return x


def _bilinear_P_1d(m):
    """The 1-D cell-centered linear prolongation (2m, m) as scipy CSR —
    the explicit-matrix twin of :func:`_lin_prolong_axis`, used for the
    exact Galerkin triple product ``P^T A P`` on variable coefficients."""
    import scipy.sparse

    rows, cols, vals = [], [], []
    for I in range(m):
        rows += [2 * I, 2 * I + 1]
        cols += [I, I]
        vals += [0.75, 0.75]
        # even neighbor (I-1); Dirichlet ghost folds -1/4 onto I at the wall
        rows.append(2 * I)
        cols.append(I - 1 if I > 0 else 0)
        vals.append(0.25 if I > 0 else -0.25)
        # odd neighbor (I+1)
        rows.append(2 * I + 1)
        cols.append(I + 1 if I < m - 1 else m - 1)
        vals.append(0.25 if I < m - 1 else -0.25)
    return scipy.sparse.csr_matrix(
        (vals, (rows, cols)), shape=(2 * m, m)
    )


def _scipy_to_planes(A_sp, mx, my):
    """Split a (mx*my, mx*my) scipy CSR grid operator into coefficient
    planes ``(ndiag, mx, my)`` keyed by 2-D offsets (dr, dc)."""
    coo = A_sp.tocoo()
    I, J = coo.row // my, coo.row % my
    dr = coo.col // my - I
    dc = coo.col % my - J
    keys = sorted(set(zip(dr.tolist(), dc.tolist())))
    planes = np.zeros((len(keys), mx, my), A_sp.dtype)
    for k, (a, b) in enumerate(keys):
        sel = (dr == a) & (dc == b)
        planes[k][I[sel], J[sel]] = coo.data[sel]
    return planes, tuple(k[0] for k in keys), tuple(k[1] for k in keys)


def _galerkin_coarsen_2d(coeffs, row_offsets, col_offsets):
    """Exact Galerkin coarse stencil ``A_c = P^T A P`` for piecewise-
    constant transfer (P = 2x2 block repeat, R = P^T = block sum).

    ``coeffs``: numpy ``(ndiag, Mx, My)`` fine coefficient planes.  Fine
    entry (i, i+d) with ``i = 2I + p`` lands at coarse offset
    ``D = floor((p + d) / 2)`` per dim, position ``I`` — so each fine
    plane scatters into the coarse planes by parity sub-sampling; no
    per-entry work.  Returns ``(coarse_coeffs, coarse_row_offsets,
    coarse_col_offsets)``; the fine boundary contract (zero coefficient
    where the neighbor leaves the grid) is inherited exactly.
    """
    out = {}
    for d, (dr, dc) in enumerate(zip(row_offsets, col_offsets)):
        C = coeffs[d]
        for px in (0, 1):
            for py in (0, 1):
                key = ((px + dr) // 2, (py + dc) // 2)
                acc = out.get(key)
                sub = C[px::2, py::2]
                out[key] = sub if acc is None else acc + sub
    keys = sorted(out)
    stack = np.stack if isinstance(coeffs, np.ndarray) else jnp.stack
    cc = stack([out[k] for k in keys], axis=0)
    return cc, tuple(k[0] for k in keys), tuple(k[1] for k in keys)


@register_pytree_node_class
class MultigridPreconditioner:
    """``z = M @ r`` runs one geometric V-cycle approximating ``A^{-1} r``.

    * ``A`` — a :class:`ConstStencilOperator` (any rank >= 2 grid; each
      coarse level rediscretizes the same stencil weights on the halved
      grid) **or** a variable-coefficient 2-D
      :class:`~krylov_tpu.ops.stencil.GridStencilOperator` (each coarse
      level is the exact Galerkin triple product ``P^T A P`` for the
      cell-centered BILINEAR transfer, computed once on host — a 5/9-point
      fine stencil becomes 25-point coarse stencils, closed under
      further coarsening).  Both paths use the order-2 transfer pair
      (multilinear P, R = scale * P^T), which is what makes the V-cycle
      iteration count mesh-INDEPENDENT (see :func:`_lin_prolong_axis`).
    * ``smooth`` — pre- and post-smoothing sweeps of weighted Jacobi.
    * ``omega`` — Jacobi damping (0.8 suits the 5/7-point Laplacian).
    * ``n_levels`` — cap on the hierarchy depth (default: halve while all
      dims stay even and >= 4).
    * ``coarse_iters`` — weighted-Jacobi iterations for the coarsest grid.

    Accepts flat ``(N,)``, grid-shaped ``(M, ny)``, and blocked
    ``(..., k)`` right-hand sides (trailing axes ride along).
    """

    def __init__(self, A, smooth=2, omega=0.8, n_levels=None,
                 coarse_iters=40):
        from .ops.stencil import GridStencilOperator

        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)
        self._cap = n_levels
        self._coarse_inv = None

        if isinstance(A, ConstStencilOperator):
            shapes = [A.shape_nd]
            while _can_halve(shapes[-1]) and (
                n_levels is None or len(shapes) < n_levels
            ):
                shapes.append(_halve_all(shapes[-1]))
            ops = [A] + [
                ConstStencilOperator(s, A.offsets_nd, A.weights, A.dtype)
                for s in shapes[1:]
            ]
            center = [
                w for off, w in zip(A.offsets_nd, A.weights)
                if all(o == 0 for o in off)
            ]
            if not center or center[0] == 0.0:
                raise ValueError("stencil needs a nonzero center weight")
            winv = [
                jnp.asarray(self.omega / center[0], A.dtype)
            ] * len(ops)
            self._nd_shapes = tuple(tuple(s) for s in shapes)
            # rediscretized levels reuse the unit-spacing stencil, so the
            # restriction carries the h_c^2/h^2 factor
            self._r_scale = 4.0 / (2 ** len(A.shape_nd))
            nc = 1
            for s in shapes[-1]:
                nc *= s
            if nc <= 4096 and len(ops) > 1:
                # exact coarsest solve (tiny dense inverse) removes the
                # coarse-solve error term from the mesh-independence bound
                dense = np.asarray(
                    ops[-1].toscipy().toarray(), dtype=np.float64
                )
                try:
                    inv = np.linalg.inv(dense)
                except np.linalg.LinAlgError:
                    inv = np.linalg.pinv(dense)
                self._coarse_inv = jnp.asarray(inv, dtype=A.dtype)
        elif isinstance(A, GridStencilOperator):
            if not A.hermitian:
                raise ValueError(
                    "multigrid preconditioning needs a hermitian (SPD) "
                    "operator (the cycle advertises hermitian=True)"
                )
            if any(r not in (-2, -1, 0, 1, 2) for r in A.row_offsets) or any(
                c not in (-2, -1, 0, 1, 2) for c in A.col_offsets
            ):
                raise ValueError(
                    "Galerkin multigrid supports 2-D stencils with "
                    f"row/col offsets in [-2, 2]; got {A.row_offsets}/"
                    f"{A.col_offsets} (3-D grid operators collapse x into "
                    "grid rows — use AMGPreconditioner there)"
                )
            # exact variational hierarchy: A_c = P^T A P with the
            # cell-centered BILINEAR P (order-2 transfer; a 5/9-point fine
            # stencil becomes 25-point coarse stencils, closed under
            # further coarsening).  One host-side scipy pass at setup.
            ops, winv, shapes = [A], [], [tuple(A.grid)]
            A_sp = A.toscipy().astype(np.float64)
            while _can_halve(shapes[-1]) and (
                n_levels is None or len(shapes) < n_levels
            ):
                import scipy.sparse

                mx, my = shapes[-1]
                P = scipy.sparse.kron(
                    _bilinear_P_1d(mx // 2), _bilinear_P_1d(my // 2),
                    format="csr",
                )
                A_sp = (P.T @ A_sp @ P).tocsr()
                cc, ro, co = _scipy_to_planes(A_sp, mx // 2, my // 2)
                ny_c = my // 2
                offs = tuple(
                    r * ny_c + c for r, c in zip(ro, co)
                )
                ops.append(
                    GridStencilOperator(
                        jnp.asarray(cc.astype(np.asarray(A.coeffs2d).dtype)),
                        offs, ny_c, hermitian=A.hermitian,
                    )
                )
                shapes.append((mx // 2, ny_c))
            # per-level Jacobi weights from each level's own diagonal
            for op in ops:
                d = op.diagonal().reshape(op.grid)
                winv.append(self.omega / jnp.where(d != 0, d, 1.0))
            self._nd_shapes = tuple(shapes)
            self._r_scale = 1.0  # Galerkin R = P^T: no rescaling
            nc = shapes[-1][0] * shapes[-1][1]
            if nc <= 4096:
                # exact coarse solve as one dense matmul (also keeps the
                # unrolled coarse-Jacobi chain out of the compiled graph)
                dense = A_sp.toarray()
                try:
                    inv = np.linalg.inv(dense)
                except np.linalg.LinAlgError:
                    inv = np.linalg.pinv(dense)
                self._coarse_inv = jnp.asarray(
                    inv.astype(np.asarray(A.coeffs2d).dtype)
                )
        else:
            raise TypeError(
                "MultigridPreconditioner needs a ConstStencilOperator or "
                "a 2-D GridStencilOperator (general sparsity: use "
                "AMGPreconditioner)"
            )
        self._fine = ops[0]
        self._ops = tuple(ops)
        self._winv = tuple(winv)

    # -- observables ---------------------------------------------------
    @property
    def shape(self):
        return self._fine.shape

    @property
    def dtype(self):
        return self._fine.dtype

    @property
    def n_levels(self):
        return len(self._ops)

    hermitian = True

    # -- grid transfer (order-2: multilinear P, R = scale * P^T) --------
    def _restrict(self, x, nd):
        return _lin_restrict(x, nd, self._r_scale)

    def _prolong(self, x, nd):
        return _lin_prolong(x, nd)

    # -- smoothing -----------------------------------------------------
    def _wmul(self, level, r):
        w = self._winv[level]
        return w.reshape(w.shape + (1,) * (r.ndim - w.ndim)) * r

    def _smooth(self, level, z, r, iters):
        for _ in range(iters):
            z = z + self._wmul(level, r - self._apply(level, z))
        return z

    def _apply(self, level, x_nd):
        # op works on collapsed (M, ny)(+tail); x_nd is shape_nd(+tail)
        op = self._ops[level]
        nd = len(self._nd_shapes[level])
        tail = x_nd.shape[nd:]
        g = op.vector_shape
        y = op @ x_nd.reshape(g + tail)
        return y.reshape(x_nd.shape)

    # -- the cycle -----------------------------------------------------
    def _vcycle(self, level, r):
        if level == len(self._ops) - 1:
            if self._coarse_inv is not None:
                sh = self._nd_shapes[level]
                nc = 1
                for s in sh:
                    nc *= s
                r2 = r.reshape((nc,) + r.shape[len(sh):])
                z2 = prec.tensordot(self._coarse_inv, r2, axes=1)
                return z2.reshape(r.shape)
            z = jnp.zeros_like(r)
            return self._smooth(level, z, r, self.coarse_iters)
        nd = len(self._nd_shapes[level])
        z = self._wmul(level, r)  # first sweep from zero, no matvec
        z = self._smooth(level, z, r, self.smooth - 1)
        d = r - self._apply(level, z)
        e = self._vcycle(level + 1, self._restrict(d, nd))
        z = z + self._prolong(e, nd)
        return self._smooth(level, z, r, self.smooth)

    def __matmul__(self, r):
        A = self._fine
        g = A.vector_shape  # (M, ny)
        if r.ndim >= 2 and tuple(r.shape[:2]) == tuple(g):
            tail = r.shape[2:]
        else:  # flat (N,)(+tail)
            tail = r.shape[1:]
        z = self._vcycle(0, r.reshape(self._nd_shapes[0] + tail))
        return z.reshape(r.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle

    # -- pytree (level operators and Jacobi weights are the children;
    #    Galerkin coefficient planes ride inside the operator pytrees) --
    def tree_flatten(self):
        return (self._ops, self._winv, self._coarse_inv), (
            self.smooth, self.omega, self.coarse_iters,
            self._nd_shapes, self._r_scale,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        smooth, omega, coarse_iters, nd_shapes, r_scale = aux
        self = object.__new__(cls)
        self._ops, self._winv, self._coarse_inv = children
        self._fine = self._ops[0]
        self.smooth, self.omega = smooth, omega
        self.coarse_iters = coarse_iters
        self._cap = None
        self._nd_shapes, self._r_scale = nd_shapes, r_scale
        return self


@register_pytree_node_class
class ShardedMultigridPreconditioner:
    """Fully distributed geometric V-cycle over a row-sharded constant
    stencil (built inside ``shard_map`` by :func:`multigrid_factory`).

    Device mapping per level:

    * **smoothing / residual** — the level's matvec is a
      :class:`~krylov_tpu.parallel.grid.ShardedConstStencilOperator`
      (the fused const-stencil expression on the local slab + one halo
      ``ppermute`` pair between neighbor devices), so every Jacobi sweep costs exactly
      one neighbor exchange and zero allreduces;
    * **restriction / prolongation** — order-2 multilinear transfer
      (:func:`_lin_prolong_axis`); along the sharded axis each shard
      exchanges ONE boundary plane with its mesh neighbors per transfer
      (:func:`_lead_lin_restrict_axis`), the other axes are local
      reshape arithmetic — so the distributed cycle is exactly the
      single-device cycle, including its mesh-independent rate;
    * **coarsest level** — once a shard's slab can no longer halve, the
      (tiny) coarse residual is ``all_gather``\\ ed and every shard
      redundantly runs the same single-device
      :class:`MultigridPreconditioner` V-cycle on the global coarse
      problem, then slices out its rows — replicated compute instead of
      a serial bottleneck.

    Unlike the shard-local (block-Jacobi / additive-Schwarz) variant,
    the cycle couples shards at every level, so preconditioned iteration
    counts match the single-device V-cycle independent of the shard
    count (~15 on Poisson, vs ~80 for the local variant at 8 shards).
    """

    def __init__(self, A_l, smooth=2, omega=0.8, n_levels=None,
                 coarse_iters=40):
        from .parallel.grid import ShardedConstStencilOperator

        if not isinstance(A_l, ShardedConstStencilOperator):
            raise TypeError(
                "ShardedMultigridPreconditioner needs a "
                "ShardedConstStencilOperator"
            )
        if A_l.m_valid is not None:
            raise ValueError(
                "padded grids cannot coarsen consistently across shards; "
                "use multigrid_factory(coupling='local')"
            )
        g = A_l._op
        inner_rows = 1
        for s in g.shape_nd[1:-1]:
            inner_rows *= s
        if A_l.m_local % inner_rows:
            raise ValueError(
                f"shard slab of {A_l.m_local} grid rows does not tile the "
                f"inner grid dims {g.shape_nd[1:-1]}"
            )
        self.axis = A_l.axis
        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)
        self._m_local_fine = int(A_l.m_local)

        lead = A_l.m_local // inner_rows
        shapes, leads = [g.shape_nd], [lead]
        # halve while every shard keeps >= 1 whole leading cell and the
        # unsharded dims stay halvable
        while (
            leads[-1] % 2 == 0
            and _can_halve(shapes[-1][1:])
            and (n_levels is None or len(shapes) < n_levels)
        ):
            shapes.append(_halve_all(shapes[-1]))
            leads.append(leads[-1] // 2)
        self._ops = [
            ConstStencilOperator(s, g.offsets_nd, g.weights, g.dtype)
            for s in shapes
        ]
        self._leads = leads
        # redundant coarse solve: one single-device V-cycle on the global
        # coarse grid (which keeps coarsening below the shard limit)
        self._coarse = MultigridPreconditioner(
            self._ops[-1], smooth=smooth, omega=omega,
            coarse_iters=coarse_iters,
        )
        center = [
            w for off, w in zip(g.offsets_nd, g.weights)
            if all(o == 0 for o in off)
        ]
        if not center or center[0] == 0.0:
            raise ValueError("stencil needs a nonzero center weight")
        self._diag = float(center[0])
        self._r_scale = 4.0 / (2 ** len(g.shape_nd))

    @property
    def dtype(self):
        return self._ops[0].dtype

    @property
    def n_levels(self):
        return len(self._ops) + self._coarse.n_levels - 1

    hermitian = True

    # -- per-level sharded matvec in the local-slab nd layout -----------
    def _apply(self, level, x_nd):
        from .parallel.grid import ShardedConstStencilOperator

        op = self._ops[level]
        nd = len(op.shape_nd)
        inner_rows = 1
        for s in op.shape_nd[1:-1]:
            inner_rows *= s
        m_local = self._leads[level] * inner_rows
        sh = ShardedConstStencilOperator(op, m_local, axis=self.axis)
        tail = x_nd.shape[nd:]
        y = sh @ x_nd.reshape((m_local, op.shape_nd[-1]) + tail)
        return y.reshape(x_nd.shape)

    def _smooth(self, level, z, r, iters):
        w = self.omega / self._diag
        for _ in range(iters):
            z = z + w * (r - self._apply(level, z))
        return z

    def _vcycle(self, level, r):
        nd = len(self._ops[level].shape_nd)
        if level == len(self._ops) - 1:
            rg = lax.all_gather(r, self.axis, axis=0, tiled=True)
            zg = self._coarse._vcycle(0, rg)
            row0 = lax.axis_index(self.axis) * self._leads[level]
            return lax.dynamic_slice_in_dim(
                zg, row0, self._leads[level], axis=0
            )
        w = self.omega / self._diag
        z = w * r  # first Jacobi sweep from zero, no matvec needed
        z = self._smooth(level, z, r, self.smooth - 1)
        d = r - self._apply(level, z)
        e = self._vcycle(
            level + 1, _sharded_lin_restrict(d, nd, self._r_scale, self.axis)
        )
        z = z + _sharded_lin_prolong(e, nd, self.axis)
        return self._smooth(level, z, r, self.smooth)

    def __matmul__(self, r):
        # r: local collapsed slab (m_local, last)(+tail)
        op = self._ops[0]
        nd = len(op.shape_nd)
        tail = r.shape[2:]
        local_nd = (self._leads[0],) + tuple(op.shape_nd[1:])
        z = self._vcycle(0, r.reshape(local_nd + tail))
        return z.reshape(r.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle

    # -- pytree (all-static) --------------------------------------------
    def tree_flatten(self):
        g = self._ops[0]
        return (), (
            g.shape_nd, g.offsets_nd, g.weights, g.dtype.str,
            self._m_local_fine, self.axis, self.smooth, self.omega,
            len(self._ops), self.coarse_iters,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        (shape_nd, offsets_nd, weights, dtype, m_local, axis, smooth,
         omega, nlev, ci) = aux
        from .parallel.grid import ShardedConstStencilOperator

        A_l = ShardedConstStencilOperator(
            ConstStencilOperator(shape_nd, offsets_nd, weights, dtype),
            m_local, axis=axis,
        )
        return cls(A_l, smooth=smooth, omega=omega, n_levels=nlev,
                   coarse_iters=ci)


@register_pytree_node_class
class ShardedGalerkinMultigrid:
    """Distributed Galerkin V-cycle over a row-sharded VARIABLE-
    coefficient 2-D grid stencil (built inside ``shard_map`` by
    :func:`multigrid_factory`).

    The variable twin of :class:`ShardedMultigridPreconditioner`: every
    level's smoother is the halo-exchanging
    :class:`~krylov_tpu.parallel.grid.ShardedGridStencilOperator` matvec
    (one ``ppermute`` pair per damped-Jacobi sweep, zero allreduces),
    and — the part the constant case never needed — each coarse level's
    COEFFICIENTS are computed shard-locally as the exact Galerkin
    product ``PᵀAP`` by parity sub-sampling the local coefficient slab
    (valid because an even local row count keeps global and local
    parities equal, and each fine coefficient lives with its row, so no
    coefficient communication is needed; cross-shard couplings simply
    become coarse stencil entries served by the coarse halo exchange).
    All of this happens at trace time inside the one compiled SPMD
    program — the coarsening is loop-invariant, so XLA hoists it out of
    the solver's ``while_loop`` and it runs once per solve.

    The coarsest level runs ``coarse_iters`` damped-Jacobi sweeps with
    the halo matvec (no gather; the grid there is a few rows per shard).
    """

    def __init__(self, A_l, smooth=2, omega=0.8, n_levels=None,
                 coarse_iters=40):
        from .parallel.grid import ShardedGridStencilOperator

        if not isinstance(A_l, ShardedGridStencilOperator):
            raise TypeError(
                "ShardedGalerkinMultigrid needs a ShardedGridStencilOperator"
            )
        if not A_l.hermitian:
            raise ValueError(
                "multigrid preconditioning needs a hermitian (SPD) operator"
            )
        lop = A_l._local
        if any(r not in (-1, 0, 1) for r in lop.row_offsets) or any(
            c not in (-1, 0, 1) for c in lop.col_offsets
        ):
            raise ValueError(
                "Galerkin multigrid supports nearest-neighbor 2-D "
                f"stencils; got row/col offsets {lop.row_offsets}/"
                f"{lop.col_offsets}"
            )
        self.axis = A_l.axis
        self.smooth = int(smooth)
        self.omega = float(omega)
        self.coarse_iters = int(coarse_iters)

        cc = lop.coeffs2d
        ro, co = lop.row_offsets, lop.col_offsets
        coeffs, offs_pairs = [cc], [(ro, co)]
        while (
            coeffs[-1].shape[1] % 2 == 0  # local rows halve cleanly
            and coeffs[-1].shape[1] >= 2
            and coeffs[-1].shape[2] % 2 == 0
            and coeffs[-1].shape[2] // 2 >= 4
            and (n_levels is None or len(coeffs) < n_levels)
        ):
            cc, ro, co = _galerkin_coarsen_2d(cc, ro, co)
            coeffs.append(cc)
            offs_pairs.append((ro, co))
        self._coeffs = tuple(coeffs)
        self._offs = tuple(offs_pairs)

        def make_winv(cc, ro, co):
            ctr = list(zip(ro, co)).index((0, 0))
            d = cc[ctr]
            return self.omega / jnp.where(d != 0, d, 1.0)

        self._winv = tuple(
            make_winv(cc, ro, co)
            for cc, (ro, co) in zip(coeffs, offs_pairs)
        )

        # gathered redundant tail: when the shard-local slab can no
        # longer halve, every shard all_gathers the (tiny) coarse
        # coefficient planes, keeps coarsening the GLOBAL problem
        # redundantly, and bottoms out in a dense inverse — all traced
        # once here and hoisted out of the solver's while_loop.
        n_sh = lax.axis_size(self.axis)
        m_loc_c, ny_c = coeffs[-1].shape[1], coeffs[-1].shape[2]
        self._tail_coeffs = ()
        self._tail_offs = ()
        self._tail_winv = ()
        self._tail_inv = None
        if m_loc_c * n_sh * ny_c <= 65536:
            cg = lax.all_gather(coeffs[-1], self.axis, axis=1, tiled=True)
            ro, co = offs_pairs[-1]
            t_c, t_o = [cg], [(ro, co)]
            while (
                t_c[-1].shape[1] * t_c[-1].shape[2] > 256
                and t_c[-1].shape[1] % 2 == 0
                and t_c[-1].shape[1] // 2 >= 1
                and t_c[-1].shape[2] % 2 == 0
                and t_c[-1].shape[2] // 2 >= 4
            ):
                cg, ro, co = _galerkin_coarsen_2d(cg, ro, co)
                t_c.append(cg)
                t_o.append((ro, co))
            self._tail_coeffs = tuple(t_c)
            self._tail_offs = tuple(t_o)
            self._tail_winv = tuple(
                make_winv(cc, ro, co) for cc, (ro, co) in zip(t_c, t_o)
            )
            bottom = t_c[-1]
            if bottom.shape[1] * bottom.shape[2] <= 4096:
                dense = self._plain_op(bottom, t_o[-1]).todense()
                self._tail_inv = jnp.linalg.inv(dense)

    @property
    def dtype(self):
        return self._coeffs[0].dtype

    @property
    def n_levels(self):
        return len(self._coeffs)

    hermitian = True

    @staticmethod
    def _plain_op(cc, ro_co):
        from .ops.stencil import GridStencilOperator

        ro, co = ro_co
        ny = cc.shape[2]
        offs = tuple(r * ny + c for r, c in zip(ro, co))
        return GridStencilOperator(cc, offs, ny, hermitian=True)

    def _op(self, level):
        from .parallel.grid import ShardedGridStencilOperator

        cc = self._coeffs[level]
        ro, co = self._offs[level]
        ny = cc.shape[2]
        offs = tuple(r * ny + c for r, c in zip(ro, co))
        return ShardedGridStencilOperator(
            cc, offs, ny, axis=self.axis, hermitian=True
        )

    @staticmethod
    def _bcast(w, r):
        return w.reshape(w.shape + (1,) * (r.ndim - w.ndim)) * r

    def _wmul(self, level, r):
        return self._bcast(self._winv[level], r)

    def _smooth(self, level, z, r, iters):
        op = self._op(level)
        for _ in range(iters):
            z = z + self._wmul(level, r - op @ z)
        return z

    # -- gathered redundant tail (plain, no halo exchange) ---------------
    def _tail_apply(self, level, x):
        op = self._plain_op(self._tail_coeffs[level], self._tail_offs[level])
        if x.ndim == 3:
            return jax.vmap(op._apply_grid, in_axes=2, out_axes=2)(x)
        return op._apply_grid(x)

    def _tail_vcycle(self, level, r):
        w = self._tail_winv[level]
        last = level == len(self._tail_coeffs) - 1
        if last and self._tail_inv is not None:
            sh = r.shape
            nc = sh[0] * sh[1]
            z2 = prec.tensordot(
                self._tail_inv, r.reshape((nc,) + sh[2:]), axes=1
            )
            return z2.reshape(sh)
        z = self._bcast(w, r)
        iters = self.coarse_iters - 1 if last else self.smooth - 1
        for _ in range(iters):
            z = z + self._bcast(w, r - self._tail_apply(level, z))
        if last:
            return z
        d = r - self._tail_apply(level, z)
        e = self._tail_vcycle(level + 1, _block_restrict(d, 2, 1.0))
        z = z + _block_prolong(e, 2)
        for _ in range(self.smooth):
            z = z + self._bcast(w, r - self._tail_apply(level, z))
        return z

    def _vcycle(self, level, r):
        if level == len(self._coeffs) - 1:
            if self._tail_coeffs:
                rg = lax.all_gather(r, self.axis, axis=0, tiled=True)
                zg = self._tail_vcycle(0, rg)
                m_loc = r.shape[0]
                row0 = lax.axis_index(self.axis) * m_loc
                return lax.dynamic_slice_in_dim(zg, row0, m_loc, axis=0)
            z = self._wmul(level, r)
            return self._smooth(level, z, r, self.coarse_iters - 1)
        z = self._wmul(level, r)  # first sweep from zero, no matvec
        z = self._smooth(level, z, r, self.smooth - 1)
        d = r - self._op(level) @ z
        e = self._vcycle(level + 1, _block_restrict(d, 2, 1.0))
        z = z + _block_prolong(e, 2)
        return self._smooth(level, z, r, self.smooth)

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle

    def tree_flatten(self):
        return (
            (self._coeffs, self._winv, self._tail_coeffs,
             self._tail_winv, self._tail_inv),
            (self._offs, self._tail_offs, self.axis, self.smooth,
             self.omega, self.coarse_iters),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        offs, t_offs, axis, smooth, omega, ci = aux
        self = object.__new__(cls)
        (self._coeffs, self._winv, self._tail_coeffs,
         self._tail_winv, self._tail_inv) = children
        self._offs, self._tail_offs = offs, t_offs
        self.axis, self.smooth = axis, smooth
        self.omega, self.coarse_iters = omega, ci
        return self


def multigrid_factory(smooth=2, omega=0.8, n_levels=None, coarse_iters=40,
                      coupling="auto"):
    """``M_factory`` for :func:`~krylov_tpu.parallel.sharded_solve`:
    a geometric V-cycle over the row-sharded const-stencil slab.

    * ``coupling="full"`` — :class:`ShardedMultigridPreconditioner`:
      halo-exchanging smoothers at every level, shard-local grid
      transfer, redundant gathered coarse solve.  Iteration counts match
      the single-device V-cycle regardless of shard count (~15 on
      Poisson); an application costs one ppermute pair per smoothing
      sweep and one small all_gather.
    * ``coupling="local"`` — additive Schwarz / block-Jacobi: each shard
      runs a :class:`MultigridPreconditioner` on ITS slab with Dirichlet
      walls at shard boundaries.  Zero cross-device traffic per
      application; iteration counts grow mildly with the shard count
      (~80 at 8 shards on 128² Poisson — still 5x under plain CG).
    * ``coupling="auto"`` (default) — "full" when the partition allows
      it, degrading to "local" for zero-padded grids.  A slab that does
      not tile the inner grid dims supports neither cycle and raises.

    Also accepts a plain (unsharded) :class:`ConstStencilOperator`, so
    the same factory works in single-device `solver(..., M=factory(A))`
    code paths.
    """
    if coupling not in ("auto", "full", "local"):
        raise ValueError(f"unknown coupling {coupling!r}")

    def build(A_l):
        if isinstance(A_l, ConstStencilOperator):
            return MultigridPreconditioner(
                A_l, smooth=smooth, omega=omega, n_levels=n_levels,
                coarse_iters=coarse_iters,
            )
        # sharded stencil slabs (lazy import: parallel -> ops only)
        from .parallel.grid import (
            ShardedConstStencilOperator,
            ShardedGridStencilOperator,
        )

        if isinstance(A_l, ShardedGridStencilOperator):
            # variable coefficients: distributed Galerkin cycle (the
            # shard-local Schwarz variant would need host-side setup,
            # which is unavailable inside the traced factory)
            if coupling == "local":
                raise ValueError(
                    "coupling='local' needs host-side subdomain setup, "
                    "which variable-coefficient slabs cannot do inside "
                    "shard_map; use coupling='full' (the default route)"
                )
            return ShardedGalerkinMultigrid(
                A_l, smooth=smooth, omega=omega, n_levels=n_levels,
                coarse_iters=coarse_iters,
            )
        if not isinstance(A_l, ShardedConstStencilOperator):
            raise TypeError(
                "multigrid_factory needs a (Sharded)ConstStencilOperator "
                "or ShardedGridStencilOperator; got "
                f"{type(A_l).__name__} (general sparsity: "
                "AMGPreconditioner)"
            )
        g = A_l._op
        m_local = A_l.m_local
        # the shard's rows slice the COLLAPSED leading grid axis
        # (vector_shape = (prod(shape_nd[:-1]), shape_nd[-1])); the slab
        # is a clean n-D sub-grid iff m_local splits the inner dims
        inner_rows = 1
        for s in g.shape_nd[1:-1]:
            inner_rows *= s
        aligned = m_local % inner_rows == 0
        if coupling == "full" or (coupling == "auto" and aligned
                                  and A_l.m_valid is None):
            return ShardedMultigridPreconditioner(
                A_l, smooth=smooth, omega=omega, n_levels=n_levels,
                coarse_iters=coarse_iters,
            )
        if not aligned:
            raise ValueError(
                f"shard slab of {m_local} grid rows does not tile the "
                f"inner grid dims {g.shape_nd[1:-1]} — choose a mesh "
                "whose rows axis divides the leading grid dimension"
            )
        local_nd = (m_local // inner_rows,) + tuple(g.shape_nd[1:])
        local = ConstStencilOperator(
            local_nd, g.offsets_nd, g.weights, g.dtype
        )
        mg = MultigridPreconditioner(
            local, smooth=smooth, omega=omega, n_levels=n_levels,
            coarse_iters=coarse_iters,
        )
        return _ShardLocalMG(mg, m_local, A_l.axis, A_l.m_valid)

    return build


@register_pytree_node_class
class _ShardLocalMG:
    """Shard-local V-cycle with padded-row masking.

    When the grid was zero-padded to the shard multiple, the sharded
    matvec keeps padded vector entries exactly zero; the local V-cycle
    would leak nonzeros into them (its slab operator couples padded and
    real rows), and real rows near the pad boundary read those entries
    back through the stencil — so mask the output rows >= m_valid to
    keep trajectories identical to the unpadded problem.
    """

    def __init__(self, mg, m_local, axis, m_valid):
        self._mg = mg
        self.m_local = int(m_local)
        self.axis = axis
        self.m_valid = None if m_valid is None else int(m_valid)

    @property
    def shape(self):
        return self._mg.shape

    @property
    def dtype(self):
        return self._mg.dtype

    hermitian = True

    def __matmul__(self, r):
        z = self._mg @ r
        if self.m_valid is not None:
            row0 = lax.axis_index(self.axis) * self.m_local
            keep = (row0 + jnp.arange(self.m_local)) < self.m_valid
            z = jnp.where(keep.reshape((-1,) + (1,) * (z.ndim - 1)), z, 0)
        return z

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x

    def tree_flatten(self):
        return (self._mg,), (self.m_local, self.axis, self.m_valid)

    @classmethod
    def tree_unflatten(cls, aux, children):
        m_local, axis, m_valid = aux
        return cls(children[0], m_local, axis, m_valid)
