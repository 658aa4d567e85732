"""Small dense triangular solves, vectorized over trailing RHS dimensions.

The reference calls scipy's ``solve_triangular`` once per RHS column in a
Python loop (reference: src/krylov/gmres.py:24-38) — a LAPACK FFI crossing
per column.  Here the solve is a single on-device ``lax``-backed call vmapped
over columns, usable inside compiled solver loops.
"""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax import lax
from jax.tree_util import register_pytree_node_class


def multi_solve_triangular(A, B, lower=False):
    """Solve ``A[:, :, t] @ y[:, t] = B[:, t]`` for every trailing index t.

    ``A`` has shape ``(k, k, *tail)``, ``B`` has ``(k, *tail)``.  Columns of B
    that are entirely zero yield zero solutions (guarding the singular-R case
    for already-converged RHS columns, same contract as the reference).
    """
    k = A.shape[0]
    tail = B.shape[1:]
    a = A.reshape(k, k, -1)
    bb = B.reshape(k, -1)

    zero_col = jnp.all(bb == 0.0, axis=0)  # (t,)
    eye = jnp.eye(k, dtype=A.dtype)
    a_safe = jnp.where(zero_col[None, None, :], eye[:, :, None], a)

    sol = jax.vmap(
        lambda aa, bbb: jsl.solve_triangular(aa, bbb, lower=lower),
        in_axes=(2, 1),
        out_axes=1,
    )(a_safe, bb)
    sol = jnp.where(zero_col[None, :], jnp.zeros_like(sol), sol)
    return sol.reshape((k,) + tail)


def grid_lower_sweep(coeffs2d, row_offsets, col_offsets, b2, omega=1.0):
    """Forward substitution for the lower triangle of a grid stencil.

    Solves ``(D/omega + L) x = b`` where ``D + L`` is the lower-triangular
    part of a :class:`~krylov_tpu.ops.stencil.GridStencilOperator` whose
    within-row coupling is first-order (``col_offsets`` subset of {0, -1} on
    the ``dr == 0`` bands) — true for all the grid Laplacians here.  This is
    the scalable data-parallel substitute for scipy's sequential
    ``spsolve_triangular`` (SURVEY.md §2.2): a ``lax.scan`` over grid rows
    (the inherently sequential direction) with the within-row first-order
    recurrence solved in parallel depth O(log ny) by
    ``jax.lax.associative_scan``:

        x[j] = a[j] * x[j-1] + c[j],  a = -l/d,  c = rhs/d.

    ``coeffs2d``: (ndiag, M, ny) with matching row/col offsets (upper bands
    may be present; they are ignored).  Returns x2 of shape (M, ny).
    """
    ndiag, M, ny = coeffs2d.shape
    dtype = jnp.result_type(coeffs2d, b2)

    diag = None
    sub = None  # within-row (0, -1) band
    row_bands = []  # (dr < 0, dc, plane)
    for d in range(ndiag):
        dr, dc = row_offsets[d], col_offsets[d]
        if dr == 0 and dc == 0:
            diag = coeffs2d[d]
        elif dr == 0 and dc == -1:
            sub = coeffs2d[d]
        elif dr == 0 and dc < -1:
            raise NotImplementedError(
                "grid_lower_sweep supports within-row coupling of order 1"
            )
        elif dr < 0:
            row_bands.append((dr, dc, coeffs2d[d]))
        # dr > 0 or dc > 0: upper triangle, ignored

    if diag is None:
        raise ValueError("stencil has no diagonal band")
    diag = diag / omega
    h = max((-dr for dr, _, _ in row_bands), default=1)

    def assoc(e1, e2):
        a1, c1 = e1
        a2, c2 = e2
        return a2 * a1, a2 * c1 + c2

    def row_solve(rhs_row, d_row, s_row):
        # x[j] = (rhs[j] - s[j] x[j-1]) / d[j] via parallel prefix
        a = jnp.where(d_row != 0, -s_row / jnp.where(d_row != 0, d_row, 1.0), 0.0)
        c = rhs_row / jnp.where(d_row != 0, d_row, 1.0)
        a = a.at[0].set(0.0)
        aa, cc = jax.lax.associative_scan(assoc, (a, c))
        return cc

    def step(carry, inputs):
        # carry: (h, ny) buffer of the previous h solved rows (carry[-1] is
        # row i-1)
        b_row, d_row, s_row, bands_rows = inputs
        rhs = b_row
        for k, (dr, dc, _) in enumerate(row_bands):
            prev = carry[h + dr]  # row i + dr
            if dc:
                # shift within the row; out-of-range killed by zero coeffs
                prev = jnp.roll(prev, -dc)
            rhs = rhs - bands_rows[k] * prev
        x_row = row_solve(rhs, d_row, s_row)
        new_carry = jnp.concatenate([carry[1:], x_row[None]], axis=0)
        return new_carry, x_row

    sub_arr = (
        jnp.zeros((M, ny), dtype) if sub is None else sub.astype(dtype)
    )
    bands_stack = (
        jnp.stack([p for _, _, p in row_bands], axis=0).astype(dtype)
        if row_bands
        else jnp.zeros((0, M, ny), dtype)
    )
    carry0 = jnp.zeros((h, ny), dtype)
    _, x2 = jax.lax.scan(
        step,
        carry0,
        (
            b2.astype(dtype),
            diag.astype(dtype),
            sub_arr,
            jnp.moveaxis(bands_stack, 1, 0),  # (M, nbands, ny)
        ),
    )
    return x2


def grid_upper_sweep(coeffs2d, row_offsets, col_offsets, b2, omega=1.0):
    """Backward substitution for the upper triangle of a grid stencil.

    Reversing both grid axes maps the upper triangle onto a lower one
    (band ``(dr, dc)`` becomes ``(-dr, -dc)`` with its coefficient plane
    flipped), so this reuses :func:`grid_lower_sweep`.
    """
    flipped = coeffs2d[:, ::-1, ::-1]
    ro = tuple(-r for r in row_offsets)
    co = tuple(-c for c in col_offsets)
    x2 = grid_lower_sweep(flipped, ro, co, b2[::-1, ::-1], omega=omega)
    return x2[::-1, ::-1]


def level_arrays(sp_tri, lower=True, max_levels=1024):
    """Host-side dependency-level decomposition of a triangular factor.

    Returns ``(n, [(rows, diag, dat, col, lrow), ...])`` as numpy arrays,
    one tuple per level — the raw material for
    :class:`LevelScheduledTriangularSolve` and for the stacked multi-shard
    sweeps in :mod:`krylov_tpu.parallel.schwarz`."""
    import numpy as np
    import scipy.sparse

    sp = scipy.sparse.csr_matrix(sp_tri)
    sp.sort_indices()
    n = sp.shape[0]
    indptr, indices, data = sp.indptr, sp.indices, sp.data

    from ._native import tri_levels_native

    level = tri_levels_native(sp, lower)
    if level is None:
        order = range(n) if lower else range(n - 1, -1, -1)
        level = np.zeros(n, np.int64)
        for i in order:
            cols = indices[indptr[i]: indptr[i + 1]]
            cols = cols[cols < i] if lower else cols[cols > i]
            if len(cols):
                level[i] = level[cols].max() + 1
    nlev = int(level.max()) + 1 if n else 1
    if nlev > max_levels:
        raise NotImplementedError(
            f"triangular factor has {nlev} dependency levels "
            f"(> {max_levels}); use the banded/grid scan sweeps or a "
            "Krylov method for deep chains"
        )

    diag = sp.diagonal()
    if np.any(diag == 0):
        raise ValueError("triangular factor has zeros on the diagonal")

    # group rows and entries by level in one stable sort each (a per-level
    # flatnonzero scan would be O(nlev * nnz) — quadratic on wavefront
    # factors at 1M rows)
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    off = indices < row_of if lower else indices > row_of
    rorder = np.argsort(level, kind="stable")
    rsplit = np.split(rorder, np.cumsum(np.bincount(level, minlength=nlev))[:-1])
    ent = np.flatnonzero(off)
    elev = level[row_of[ent]]
    eorder = ent[np.argsort(elev, kind="stable")]
    esplit = np.split(
        eorder, np.cumsum(np.bincount(elev, minlength=nlev))[:-1]
    )
    levels = []
    for l in range(nlev):
        rows = rsplit[l]
        sel = esplit[l]
        lrow = np.searchsorted(rows, row_of[sel])
        levels.append((rows, diag[rows], data[sel], indices[sel], lrow))
    return n, levels


def make_triangular_solve(sp_tri, lower=True, max_levels=4096,
                          unroll_threshold=64):
    """Pick the right level-scheduled solve for a factor's depth.

    Shallow factors (<= ``unroll_threshold`` levels) get the unrolled
    :class:`LevelScheduledTriangularSolve` (no scan overhead, XLA fuses
    across stages); deeper ones get the scan-based
    :class:`StackedTriangularSweep`, whose compiled program is O(1) in
    the level count (a deep unrolled factor inside a solver while_loop
    costs tens of seconds of compile time)."""
    n, levels = level_arrays(sp_tri, lower=lower, max_levels=max_levels)
    if len(levels) <= unroll_threshold:
        return LevelScheduledTriangularSolve(
            sp_tri, lower=lower, max_levels=max_levels
        )
    rows, diag, dat, col, lrow = stacked_level_arrays(
        [sp_tri], n, lower=lower, max_levels=max_levels
    )
    return StackedTriangularSweep(
        jnp.asarray(rows[0]), jnp.asarray(diag[0]), jnp.asarray(dat[0]),
        jnp.asarray(col[0]), jnp.asarray(lrow[0]), n,
    )


def stacked_level_arrays(factors, n, lower=True, max_levels=4096,
                         dtype=None):
    """Pad the dependency levels of one or more same-size triangular
    factors to a common ``(nlev, mr/mn)`` shape (leading axis = factor).

    The padding is exact, not approximate: padded rows write the dummy
    slot ``n`` of the extended vector with unit diagonal, padded entries
    carry zero data and segment-sum into the dummy segment ``mr``, and
    factors with fewer levels get identity tail steps.  Feed one factor's
    slice to :class:`StackedTriangularSweep`."""
    import numpy as np

    per = [
        level_arrays(f, lower=lower, max_levels=max_levels)[1]
        for f in factors
    ]
    if dtype is None:
        dtype = per[0][0][1].dtype if per and per[0] else np.float64
    S = len(per)
    nlev = max(len(p) for p in per)
    mr = max((len(lv[0]) for p in per for lv in p), default=0) or 1
    mn = max((len(lv[2]) for p in per for lv in p), default=0) or 1
    rows = np.full((S, nlev, mr), n, np.int32)
    diag = np.ones((S, nlev, mr), dtype)
    dat = np.zeros((S, nlev, mn), dtype)
    col = np.full((S, nlev, mn), n, np.int32)
    lrow = np.full((S, nlev, mn), mr, np.int32)
    for s, p in enumerate(per):
        for l, (r_, d_, v_, c_, lr_) in enumerate(p):
            rows[s, l, : len(r_)] = r_
            diag[s, l, : len(r_)] = d_
            dat[s, l, : len(v_)] = v_
            col[s, l, : len(v_)] = c_
            lrow[s, l, : len(v_)] = lr_
    return rows, diag, dat, col, lrow


@register_pytree_node_class
class StackedTriangularSweep:
    """Triangular solve as ONE ``lax.scan`` over padded dependency levels.

    Same mathematics as :class:`LevelScheduledTriangularSolve`, different
    compilation shape: that class unrolls one XLA stage per level (best
    for few levels), this one pads levels to a common shape
    (:func:`stacked_level_arrays`) and scans — the compiled program is
    O(1) in the level count, which turns a ~30 s solver-with-ILU compile
    at wavefront depth ~2·sqrt(N) into ~2 s."""

    def __init__(self, rows, diag, dat, col, lrow, n_local):
        self.rows, self.diag = rows, diag
        self.dat, self.col, self.lrow = dat, col, lrow
        self.n_local = int(n_local)

    @property
    def nlevels(self):
        return self.rows.shape[0]

    def __call__(self, b):
        tail = b.shape[1:]
        pad1 = jnp.zeros((1,) + tail, b.dtype)
        b_ext = jnp.concatenate([b, pad1], axis=0)
        mr = self.rows.shape[1]

        def step(x, lv):
            rows, diag, dat, col, lrow = lv
            rhs = b_ext[rows]
            prod = dat.reshape(dat.shape + (1,) * len(tail)) * x[col]
            # dummy segment mr collects the padded entries; dropped below
            acc = jax.ops.segment_sum(prod, lrow, num_segments=mr + 1)
            rhs = rhs - acc[:mr]
            x = x.at[rows].set(
                rhs / diag.reshape(diag.shape + (1,) * len(tail))
            )
            return x, None

        x0 = jnp.zeros_like(b_ext)
        x, _ = lax.scan(
            step, x0, (self.rows, self.diag, self.dat, self.col, self.lrow)
        )
        return x[: self.n_local]

    def tree_flatten(self):
        return (self.rows, self.diag, self.dat, self.col, self.lrow), (
            self.n_local,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


@register_pytree_node_class
class LevelScheduledTriangularSolve:
    """Level-scheduled sparse triangular solve (the general-sparsity path).

    The reference handles sparse Gauss-Seidel/SOR sweeps with scipy's
    sequential ``spsolve_triangular`` (reference:
    src/krylov/stationary.py:33-38).  A sequential row loop would serialize
    the device; instead rows are grouped host-side into dependency *levels* (row i
    is in level ``1 + max(level of its strictly-triangular neighbors)``),
    and the solve executes one fused data-parallel step per level:

        x[rows_l] = (b[rows_l] - segment_sum(data_l * x[cols_l])) / diag_l

    Each level step is an XLA gather + segment-sum over that level's
    entries, so the compiled program has one static-shape stage per level.
    Unstructured FEM/graph matrices typically have tens of levels; deep
    dependency chains (e.g. pure banded) should use the grid-stencil scan
    sweeps instead, and construction refuses above ``max_levels`` to keep
    the unrolled program bounded.
    """

    def __init__(self, sp_tri, lower=True, max_levels=1024):
        n, levels = level_arrays(sp_tri, lower=lower, max_levels=max_levels)
        self.n = n
        self.lower = lower
        self.nlevels = len(levels)
        self._levels = [
            tuple(jnp.asarray(a) for a in lv) for lv in levels
        ]

    def __call__(self, b):
        x = jnp.zeros_like(b)
        for rows, d, dat, col, lrow in self._levels:
            rhs = b[rows]
            if dat.shape[0]:
                prod = dat.reshape(dat.shape + (1,) * (b.ndim - 1)) * x[col]
                rhs = rhs - jax.ops.segment_sum(
                    prod, lrow, num_segments=rows.shape[0]
                )
            x = x.at[rows].set(rhs / d.reshape(d.shape + (1,) * (b.ndim - 1)))
        return x

    # -- pytree (so preconditioners built on it cross jit boundaries) ----
    def tree_flatten(self):
        return (tuple(self._levels),), (self.n, self.lower, self.nlevels)

    @classmethod
    def tree_unflatten(cls, aux, children):
        self = object.__new__(cls)
        self.n, self.lower, self.nlevels = aux
        self._levels = list(children[0])
        return self
