"""Row-wise banded (stencil) operators and grid-Laplacian generators.

The benchmark family of BASELINE.json (2D/3D Poisson at 1M-100M rows) is
banded: every row reads a fixed set of column offsets.  Row-wise banded
storage ``coeffs[d, i] = A[i, i + offsets[d]]`` makes the matvec a sum of
*shifted elementwise products* — no index traffic at all, one fused
streaming pass over memory, and the natural format for halo-exchange row
partitioning (each shard only needs ``max|offset|`` remote entries per side).

This is the structured answer to the reference's implicit reliance on scipy
CSR matvecs (SURVEY.md §2.2): keep CSR for general sparsity, use banded
storage where the structure allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_pytree_node_class


@register_pytree_node_class
class BandedOperator:
    """Row-wise banded operator: ``y[i] = sum_d coeffs[d, i] * x[i + offsets[d]]``.

    ``coeffs`` has shape ``(ndiag, N)``; entries whose column index would fall
    outside [0, N) must be zero (enforced by the constructors here).
    """

    def __init__(self, coeffs, offsets, hermitian=False):
        self.coeffs = coeffs
        self.offsets = tuple(int(o) for o in offsets)
        self.hermitian = bool(hermitian)

    @property
    def shape(self):
        n = self.coeffs.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def nnz(self):
        n = self.coeffs.shape[1]
        return sum(n - abs(o) for o in self.offsets)

    def __matmul__(self, x):
        n = self.coeffs.shape[1]
        y = jnp.zeros(x.shape, jnp.result_type(self.coeffs, x))
        for d, off in enumerate(self.offsets):
            c = self.coeffs[d]
            if off >= 0:
                contrib = (
                    c[: n - off].reshape((n - off,) + (1,) * (x.ndim - 1))
                    * x[off:]
                )
                y = y.at[: n - off].add(contrib)
            else:
                contrib = (
                    c[-off:].reshape((n + off,) + (1,) * (x.ndim - 1))
                    * x[: n + off]
                )
                y = y.at[-off:].add(contrib)
        return y

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        n = self.coeffs.shape[1]
        y = jnp.zeros(x.shape, jnp.result_type(self.coeffs, x))
        for d, off in enumerate(self.offsets):
            c = jnp.conj(self.coeffs[d])
            if off >= 0:
                contrib = (
                    c[: n - off].reshape((n - off,) + (1,) * (x.ndim - 1))
                    * x[: n - off]
                )
                y = y.at[off:].add(contrib)
            else:
                contrib = (
                    c[-off:].reshape((n + off,) + (1,) * (x.ndim - 1)) * x[-off:]
                )
                y = y.at[: n + off].add(contrib)
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.coeffs[self.offsets.index(0)]
        return jnp.zeros(self.coeffs.shape[1], self.dtype)

    def toscipy(self):
        """Host-side scipy CSR twin (setup/analysis paths only)."""
        import scipy.sparse

        n = self.coeffs.shape[1]
        rows, cols, vals = [], [], []
        cf = np.asarray(self.coeffs)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(cf[d, i])
        return scipy.sparse.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n),
        )

    def tocsr(self):
        from .sparse import CSROperator

        return CSROperator.from_scipy(self.toscipy())

    def todense(self):
        n = self.coeffs.shape[1]
        out = jnp.zeros((n, n), self.dtype)
        for d, off in enumerate(self.offsets):
            i = jnp.arange(max(0, -off), min(n, n - off))
            out = out.at[i, i + off].set(self.coeffs[d, i])
        return out

    def tree_flatten(self):
        return (self.coeffs,), (self.offsets, self.hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, hermitian = aux
        return cls(children[0], offsets, hermitian=hermitian)


@register_pytree_node_class
class GridStencilOperator(BandedOperator):
    """Banded operator whose bands decompose over a grid with last dim ``ny``.

    Same flat ``(N,)``-vector interface and semantics as
    :class:`BandedOperator`, plus a grid factorization ``offset = dr * ny +
    dc`` (``|dc| < ny/2``): the matvec runs as a 2-D stencil on the
    ``(M, ny)`` grid view — row shifts as slices of a halo-extended window,
    column shifts as padded slices — which XLA fuses into one elementwise
    pass (no flattened 1-D shifted-slice scatter-adds).

    Contract: coefficients must be zero wherever the 2-D neighbor
    ``(i + dr, j + dc)`` leaves the grid (the constructors here guarantee
    it); the kernel's wrapped/zero halo reads are then unobservable.

    Coefficients are stored in the 2-D ``(ndiag, M, ny)`` device layout
    (so no per-iteration reshape of the coefficients); the flat ``(ndiag, N)``
    view used by the inherited utility methods is exposed as a property.
    Vectors may be flat ``(N,)`` or grid-shaped ``(M, ny)``; grid-shaped
    vectors avoid the per-iteration vector relayout entirely and are the
    fast path for whole solves (inner products and axpys are shape-agnostic,
    so every solver works on them with a full-contraction ``inner``).
    """

    def __init__(self, coeffs, offsets, ny, hermitian=False):
        self.offsets = tuple(int(o) for o in offsets)
        self.hermitian = bool(hermitian)
        self.ny = int(ny)
        if coeffs.ndim == 2:
            n = coeffs.shape[1]
            if n % self.ny:
                raise ValueError(f"N={n} not a multiple of grid last-dim {ny}")
            coeffs = coeffs.reshape(coeffs.shape[0], n // self.ny, self.ny)
        self.coeffs2d = coeffs  # (ndiag, M, ny)
        self.row_offsets = tuple(
            int(round(o / self.ny)) for o in self.offsets
        )
        self.col_offsets = tuple(
            int(o - r * self.ny) for o, r in zip(self.offsets, self.row_offsets)
        )
        if any(abs(c) >= self.ny for c in self.col_offsets):
            raise ValueError(
                f"offsets {self.offsets} do not decompose over ny={ny}"
            )

    @property
    def coeffs(self):
        """Flat row-aligned view (ndiag, N) — utility paths only."""
        nd, M, ny = self.coeffs2d.shape
        return self.coeffs2d.reshape(nd, M * ny)

    @property
    def grid(self):
        """(M, ny) collapsed grid shape of this operator's vector space."""
        return self.coeffs2d.shape[1:]

    # solvers accept grid-shaped vectors for this operator (solvers/_common.py)
    vector_shape = grid

    def _apply_grid(self, x2, top_halo=None, bot_halo=None):
        """Padded-shift matvec on the (M, ny) grid view.

        Optional ``top_halo``/``bot_halo`` ``(h, ny)`` splice in neighbor
        rows for the row-partitioned distributed operator (zeros otherwise).
        """
        M = x2.shape[0]
        h = max(
            (max(0, -min(self.row_offsets)), max(0, max(self.row_offsets)), 1)
        )
        if top_halo is not None:
            assert top_halo.shape[0] == h, (top_halo.shape, h)
        if bot_halo is not None:
            assert bot_halo.shape[0] == h, (bot_halo.shape, h)
        top = (
            jnp.zeros((h,) + x2.shape[1:], x2.dtype)
            if top_halo is None
            else top_halo.astype(x2.dtype)
        )
        bot = (
            jnp.zeros((h,) + x2.shape[1:], x2.dtype)
            if bot_halo is None
            else bot_halo.astype(x2.dtype)
        )
        x_ext = jnp.concatenate([top, x2, bot], axis=0)
        y = None
        for d, (dr, dc) in enumerate(zip(self.row_offsets, self.col_offsets)):
            seg = jax.lax.slice_in_dim(x_ext, h + dr, h + dr + M, axis=0)
            if dc > 0:
                seg = jnp.pad(seg[:, dc:], ((0, 0), (0, dc)))
            elif dc < 0:
                seg = jnp.pad(seg[:, :dc], ((0, 0), (-dc, 0)))
            term = self.coeffs2d[d] * seg
            y = term if y is None else y + term
        return y

    def __matmul__(self, x):
        M, ny = self.grid
        if x.ndim == 2 and x.shape == (M, ny):
            return self._apply_grid(x)  # grid-shaped vector: no relayout
        if x.ndim == 2:
            # multi-RHS (N, k): vmap the grid kernel over columns
            xb = x.T.reshape(x.shape[1], M, ny)
            yb = jax.vmap(self._apply_grid)(xb)
            return yb.reshape(x.shape[1], M * ny).T
        if x.ndim == 3 and x.shape[:2] == (M, ny):
            # grid-shaped blocked RHS (M, ny, k)
            return jax.vmap(self._apply_grid, in_axes=2, out_axes=2)(x)
        if x.ndim != 1:
            return BandedOperator.__matmul__(self, x)
        return self._apply_grid(x.reshape(M, ny)).reshape(x.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        return BandedOperator.rmatvec(self, x)

    def tree_flatten(self):
        return (self.coeffs2d,), (self.offsets, self.ny, self.hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, ny, hermitian = aux
        return cls(children[0], offsets, ny, hermitian=hermitian)


def _laplacian_coeffs(shape_nd, dtype):
    """Row-wise banded coefficients of the (2*d)-point Laplacian on an
    n-D grid with natural (last-axis-fastest) ordering and Dirichlet BCs."""
    nd = len(shape_nd)
    N = int(np.prod(shape_nd))
    idx = np.arange(N)
    coords = np.stack(np.unravel_index(idx, shape_nd), axis=0)  # (nd, N)

    strides = [int(np.prod(shape_nd[k + 1 :])) for k in range(nd)]
    offsets = []
    coeff_rows = []

    # center
    offsets.append(0)
    coeff_rows.append(np.full(N, 2.0 * nd, dtype=dtype))

    for k in range(nd):
        s = strides[k]
        # +s neighbor exists when coord < n_k - 1
        mask_p = (coords[k] < shape_nd[k] - 1).astype(dtype)
        mask_m = (coords[k] > 0).astype(dtype)
        offsets.append(s)
        coeff_rows.append(-mask_p)
        offsets.append(-s)
        coeff_rows.append(-mask_m)

    order = np.argsort(offsets)
    offsets = [offsets[i] for i in order]
    coeffs = np.stack([coeff_rows[i] for i in order], axis=0)
    return coeffs, offsets


def poisson_1d(n, dtype=np.float64):
    """Tridiagonal 1-D Laplacian (Dirichlet)."""
    coeffs, offsets = _laplacian_coeffs((n,), np.dtype(dtype))
    return BandedOperator(jnp.asarray(coeffs), offsets, hermitian=True)


def poisson_2d(nx, ny=None, dtype=np.float64):
    """5-point 2-D Laplacian (Dirichlet) on an (nx, ny) grid."""
    ny = nx if ny is None else ny
    coeffs, offsets = _laplacian_coeffs((nx, ny), np.dtype(dtype))
    return GridStencilOperator(jnp.asarray(coeffs), offsets, ny, hermitian=True)


def diffusion_2d(a, dtype=None):
    """SPD 5-point FV discretization of ``-div(a grad u)`` with Dirichlet
    walls on the grid of cell coefficients ``a`` (shape ``(nx, ny)``).

    Face conductivities are arithmetic means of the adjacent cells;
    boundary faces use the boundary cell's own coefficient, so the
    center includes the wall links and the matrix is honestly positive
    definite (a center built from interior row sums alone would be a
    singular Neumann operator).  ``a = ones`` reproduces ``poisson_2d``.
    """
    a = np.asarray(a, dtype=dtype)
    nx, ny = a.shape
    axf = np.zeros((nx + 1, ny), a.dtype)
    axf[1:nx] = 0.5 * (a[1:, :] + a[:-1, :])
    axf[0], axf[nx] = a[0, :], a[-1, :]
    ayf = np.zeros((nx, ny + 1), a.dtype)
    ayf[:, 1:ny] = 0.5 * (a[:, 1:] + a[:, :-1])
    ayf[:, 0], ayf[:, ny] = a[:, 0], a[:, -1]
    c = np.zeros((5, nx, ny), a.dtype)
    c[0, 1:, :] = -axf[1:nx]
    c[4, :-1, :] = -axf[1:nx]
    c[1, :, 1:] = -ayf[:, 1:ny]
    c[3, :, :-1] = -ayf[:, 1:ny]
    c[2] = axf[:-1] + axf[1:] + ayf[:, :-1] + ayf[:, 1:]
    return GridStencilOperator(
        jnp.asarray(c), (-ny, -1, 0, 1, ny), ny, hermitian=True
    )


def poisson_3d(nx, ny=None, nz=None, dtype=np.float64):
    """7-point 3-D Laplacian (Dirichlet) on an (nx, ny, nz) grid.

    Grid-collapsed to 2-D ``(nx * ny, nz)``: offsets ±1 are column shifts,
    ±nz and ±ny*nz are row shifts.
    """
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    coeffs, offsets = _laplacian_coeffs((nx, ny, nz), np.dtype(dtype))
    return GridStencilOperator(jnp.asarray(coeffs), offsets, nz, hermitian=True)


@register_pytree_node_class
class ConstStencilOperator:
    """Constant-coefficient n-D stencil with Dirichlet boundaries.

    The lightest format for the Poisson/Laplacian benchmark family: the
    operator carries only static scalar weights — no coefficient arrays —
    so a matvec's memory traffic is just x-read + y-write (~2N words,
    against 7N for the 5-point variable-coefficient operator and
    ~(ndiag+2)/2 x less than CSR).  Boundary (Dirichlet) masking is
    computed from element indices inside the fused roll+mask expression.

    ``shape_nd`` is the n-D grid shape (n >= 2); ``offsets_nd`` is a tuple of
    n-D integer offset vectors, ``weights`` the matching static scalars.  The
    grid collapses to ``(M, ny) = (prod(shape[:-1]), shape[-1])``; vectors
    may be flat ``(N,)`` or grid-shaped ``(M, ny)`` (the fast path, avoiding
    a reshape per matvec).
    """

    def __init__(self, shape_nd, offsets_nd, weights, dtype=np.float64):
        self.shape_nd = tuple(int(s) for s in shape_nd)
        if len(self.shape_nd) < 2:
            raise ValueError("use BandedOperator for 1-D stencils")
        self.offsets_nd = tuple(tuple(int(o) for o in off) for off in offsets_nd)
        self.weights = tuple(float(w) for w in weights)
        self.dtype = np.dtype(dtype)

        self.ny = self.shape_nd[-1]
        M = 1
        for s in self.shape_nd[:-1]:
            M *= s
        self._M = M

        # collapse: row strides (in rows) for each leading axis
        row_axes = self.shape_nd[:-1]
        strides = []
        for k in range(len(row_axes)):
            st = 1
            for s in row_axes[k + 1 :]:
                st *= s
            strides.append(st)

        bands = []
        for off, w in zip(self.offsets_nd, self.weights):
            if len(off) != len(self.shape_nd):
                raise ValueError(f"offset {off} rank != grid rank")
            dc = off[-1]
            dr = sum(o * st for o, st in zip(off[:-1], strides))
            if abs(dc) >= self.ny:
                raise ValueError(f"offset {off}: |last-dim step| must be < ny")
            constraints = tuple(
                (st, n, o)
                for o, st, n in zip(off[:-1], strides, row_axes)
                if o != 0
            )
            bands.append((dr, dc, w, constraints))
        self.bands = tuple(bands)
        self.hermitian = set(
            (tuple(-o for o in off), w) for off, w in zip(self.offsets_nd, self.weights)
        ) == set(zip(self.offsets_nd, self.weights))

    @property
    def shape(self):
        n = self._M * self.ny
        return (n, n)

    @property
    def grid(self):
        return (self._M, self.ny)

    vector_shape = grid

    @property
    def nnz(self):
        # valid positions per band = prod over axes of (n_k - |off_k|)
        total = 0
        for off in self.offsets_nd:
            cnt = 1
            for o, n in zip(off, self.shape_nd):
                cnt *= max(0, n - abs(o))
            total += cnt
        return total

    def _apply_grid(self, x2, row0=None, top_halo=None, bot_halo=None):
        """Matvec on the (M_local, ny) grid view.

        ``row0``/``top_halo``/``bot_halo`` support the row-partitioned
        distributed operator: ``row0`` is this shard's first global row
        (the boundary masks are defined on global coordinates) and the
        halos are the neighbor shards' boundary rows.
        """
        M, ny = x2.shape
        row_offsets = tuple(b[0] for b in self.bands)
        # halo-extended window + slices + boundary masks
        h = max(
            (max(0, -min(row_offsets)), max(0, max(row_offsets)), 1)
        )
        top = (
            jnp.zeros((h, ny), x2.dtype) if top_halo is None
            else top_halo.astype(x2.dtype)
        )
        bot = (
            jnp.zeros((h, ny), x2.dtype) if bot_halo is None
            else bot_halo.astype(x2.dtype)
        )
        x_ext = jnp.concatenate([top, x2, bot], axis=0)
        r0 = 0 if row0 is None else row0
        rows = jnp.arange(M, dtype=jnp.int32)[:, None] + jnp.asarray(
            r0, jnp.int32
        )
        cols = jnp.arange(ny, dtype=jnp.int32)[None, :]
        y = None
        for dr, dc, w, constraints in self.bands:
            seg = jax.lax.slice_in_dim(x_ext, h + dr, h + dr + M, axis=0)
            if dc:
                # column shift with wrap (mask below kills the wrap)
                seg = jnp.roll(seg, -dc, axis=1)
            m = None
            for stride, size, step in constraints:
                c = (rows // stride) % size
                mm = (c + step >= 0) & (c + step < size)
                m = mm if m is None else m & mm
            if dc:
                mc = (cols + dc >= 0) & (cols + dc < ny)
                m = mc if m is None else m & mc
            term = w * seg
            if m is not None:
                term = jnp.where(m, term, 0)
            y = term if y is None else y + term
        return y

    def __matmul__(self, x):
        M, ny = self.grid
        if x.ndim == 2 and x.shape == (M, ny):
            return self._apply_grid(x)
        if x.ndim == 2:
            # multi-RHS (N, k): vmap the grid kernel over columns
            xb = x.T.reshape(x.shape[1], M, ny)
            yb = jax.vmap(self._apply_grid)(xb)
            return yb.reshape(x.shape[1], M * ny).T
        if x.ndim == 3 and x.shape[:2] == (M, ny):
            # grid-shaped blocked RHS (M, ny, k)
            return jax.vmap(self._apply_grid, in_axes=2, out_axes=2)(x)
        if x.ndim != 1:
            raise ValueError(f"unsupported vector shape {x.shape}")
        return self._apply_grid(x.reshape(M, ny)).reshape(x.shape)

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        adj = ConstStencilOperator(
            self.shape_nd,
            tuple(tuple(-o for o in off) for off in self.offsets_nd),
            tuple(np.conj(w) for w in self.weights),
            dtype=self.dtype,
        )
        return adj @ x

    def diagonal(self):
        w0 = 0.0
        for off, w in zip(self.offsets_nd, self.weights):
            if all(o == 0 for o in off):
                w0 += w
        return jnp.full(self.shape[0], w0, self.dtype)

    def toscipy(self):
        """Host-side scipy CSR twin (setup/analysis paths only)."""
        import scipy.sparse

        nd = self.shape_nd
        N = self._M * self.ny
        idx = np.arange(N)
        coords = np.stack(np.unravel_index(idx, nd), axis=0)
        rows, cols, vals = [], [], []
        strides = [int(np.prod(nd[k + 1 :])) for k in range(len(nd))]
        for off, w in zip(self.offsets_nd, self.weights):
            valid = np.ones(N, dtype=bool)
            for k, o in enumerate(off):
                valid &= (coords[k] + o >= 0) & (coords[k] + o < nd[k])
            j = idx + sum(o * s for o, s in zip(off, strides))
            rows.append(idx[valid])
            cols.append(j[valid])
            vals.append(np.full(valid.sum(), w))
        return scipy.sparse.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(N, N),
        )

    def tocsr(self):
        from .sparse import CSROperator

        return CSROperator.from_scipy(self.toscipy())

    def tree_flatten(self):
        return (), (self.shape_nd, self.offsets_nd, self.weights, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape_nd, offsets_nd, weights, dtype = aux
        return cls(shape_nd, offsets_nd, weights, dtype=dtype)


def _laplace_offsets(nd):
    offs = [tuple([0] * nd)]
    ws = [2.0 * nd]
    for k in range(nd):
        for s in (+1, -1):
            o = [0] * nd
            o[k] = s
            offs.append(tuple(o))
            ws.append(-1.0)
    return tuple(offs), tuple(ws)


def poisson_2d_const(nx, ny=None, dtype=np.float32):
    """5-point 2-D Laplacian as a constant-coefficient stencil (no
    coefficient arrays: ~2N words of traffic per matvec)."""
    ny = nx if ny is None else ny
    offs, ws = _laplace_offsets(2)
    return ConstStencilOperator((nx, ny), offs, ws, dtype=dtype)


def poisson_3d_const(nx, ny=None, nz=None, dtype=np.float32):
    """7-point 3-D Laplacian as a constant-coefficient stencil."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    offs, ws = _laplace_offsets(3)
    return ConstStencilOperator((nx, ny, nz), offs, ws, dtype=dtype)
