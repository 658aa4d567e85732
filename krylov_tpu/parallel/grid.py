"""Row-partitioned grid-stencil operator: the fast distributed SpMV path.

:class:`~krylov_tpu.parallel.banded.ShardedBandedOperator` is the generic
row-slab operator, but its local matvec uses flat shifted slices with
scatter-adds.  For operators that factor over a grid
(:class:`~krylov_tpu.ops.stencil.GridStencilOperator`) this operator keeps
everything in the 2-D ``(M_local, ny)`` device layout: the shard exchanges
``h = max|row_offset|`` *grid rows* with its mesh neighbors via two
``lax.ppermute``s, then runs the exact same single-device grid stencil
with the neighbor rows spliced in as halo planes (``_apply_grid``'s
``top_halo``/``bot_halo``).  Per iteration, the only cross-device traffic is
``2 * h * ny`` elements each way plus the solver's psum scalars.

Vectors are grid-shaped ``(M_local, ny)`` locally; use a full-contraction
psum inner product (see :func:`krylov_tpu.parallel.solve.sharded_solve`,
which wires this automatically for GridStencilOperator inputs).
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class

from ..ops.stencil import GridStencilOperator
from .banded import _identity_perm_shift
from .mesh import ROWS


@register_pytree_node_class
class ShardedGridStencilOperator:
    """Local grid-row slab of a :class:`GridStencilOperator` (inside shard_map).

    ``coeffs2d``: local ``(ndiag, M_local, ny)`` block — a plain slice of the
    global coefficient array along the grid-row axis.
    """

    def __init__(self, coeffs2d, offsets, ny, axis=ROWS, hermitian=False):
        self._local = GridStencilOperator(
            coeffs2d, offsets, ny, hermitian=hermitian
        )
        self.axis = axis

    @property
    def coeffs2d(self):
        return self._local.coeffs2d

    @property
    def offsets(self):
        return self._local.offsets

    @property
    def ny(self):
        return self._local.ny

    @property
    def hermitian(self):
        return self._local.hermitian

    @property
    def dtype(self):
        return self.coeffs2d.dtype

    @property
    def grid(self):
        return self._local.grid

    vector_shape = grid

    @property
    def shape(self):
        n_local = self.grid[0] * self.grid[1]
        return (n_local, n_local)

    @property
    def halo_rows(self):
        ro = self._local.row_offsets
        return max((max(0, -min(ro)), max(0, max(ro)), 1))

    def exchange_halo(self, x2):
        """Fetch ``h`` grid rows from each mesh neighbor (zeros at edges)."""
        h = self.halo_rows
        if h > x2.shape[0]:
            raise ValueError(
                f"halo {h} grid rows exceeds local rows {x2.shape[0]}"
            )
        n_ax = lax.axis_size(self.axis)
        top = lax.ppermute(x2[-h:], self.axis, _identity_perm_shift(n_ax, +1))
        bot = lax.ppermute(x2[:h], self.axis, _identity_perm_shift(n_ax, -1))
        return top, bot

    def _strip_rows(self, x_win, r0, r1):
        """y rows [r0, r1) from an x window covering rows [r0-h, r1+h)."""
        h = self.halo_rows
        n = r1 - r0
        c2 = self._local.coeffs2d
        # column wrap-around values are killed by the zero boundary
        # coefficients, exactly as in the main kernel
        y = None
        for d, (dr, dc) in enumerate(
            zip(self._local.row_offsets, self._local.col_offsets)
        ):
            seg = jax.lax.slice_in_dim(x_win, h + dr, h + dr + n, axis=0)
            if dc:
                seg = jnp.roll(seg, -dc, axis=1)
            term = jax.lax.slice_in_dim(c2[d], r0, r1, axis=0) * seg
            y = term if y is None else y + term
        return y

    def __matmul__(self, x2):
        """Halo exchange overlapped with the local SpMV.

        The full-shard kernel runs with ZERO shard-edge halos — it has no
        data dependency on the ``ppermute``s, so XLA schedules it while the
        halos are in flight.  Only the ``h`` boundary rows on each
        side are then recomputed from the received halos (O(h * ny) work).

        Blocked multi-RHS ``(M_local, ny, k)`` vmaps the grid kernel over
        the trailing axis (the collectives batch under vmap), preserving
        the reference's blocked-solve capability on the fast sharded path.
        """
        if x2.ndim == 3:
            yb = jax.vmap(self._matvec_grid, in_axes=2, out_axes=2)(x2)
            return yb
        return self._matvec_grid(x2)

    def _matvec_grid(self, x2):
        h = self.halo_rows
        M = x2.shape[0]
        top, bot = self.exchange_halo(x2)
        if 2 * h >= M:
            # shard too thin to split: dependent path
            return self._local._apply_grid(x2, top_halo=top, bot_halo=bot)

        y = self._local._apply_grid(x2)  # overlaps with the halo ppermutes
        # fix rows [0, h): window covers rows [-h, 2h)
        top_win = jnp.concatenate([top, x2[: 2 * h]], axis=0)
        y_top = self._strip_rows(top_win, 0, h)
        # fix rows [M-h, M): window covers rows [M-2h, M+h)
        bot_win = jnp.concatenate([x2[M - 2 * h :], bot], axis=0)
        y_bot = self._strip_rows(bot_win, M - h, M)
        return jnp.concatenate([y_top, y[h : M - h], y_bot], axis=0)

    matvec = __matmul__

    def rmatvec(self, x2):
        if self.hermitian:
            return self @ x2
        raise NotImplementedError(
            "sharded grid-stencil adjoint matvec: only hermitian operators "
            "are supported (CG/MINRES/GMRES need no rmatvec)"
        )

    def diagonal(self):
        return self._local.diagonal()

    def tree_flatten(self):
        return (self.coeffs2d,), (
            self.offsets,
            self.ny,
            self.axis,
            self.hermitian,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, ny, axis, hermitian = aux
        return cls(children[0], offsets, ny, axis=axis, hermitian=hermitian)


@register_pytree_node_class
class ShardedConstStencilOperator:
    """Local grid-row slab of a :class:`ConstStencilOperator` (inside
    shard_map).

    No arrays at all: the operator is static weights + the shard's global
    row offset (``axis_index * M_local``, computed per call).  Halo rows
    travel by ``ppermute`` exactly like the variable-coefficient grid
    operator; the in-kernel Dirichlet masks use global row coordinates.
    """

    def __init__(self, op, m_local, axis=ROWS, m_valid=None):
        # op: the GLOBAL ConstStencilOperator (weights/bands are static).
        # m_valid: global count of REAL grid rows when the grid was padded
        # to the shard multiple — output rows >= m_valid are masked to
        # zero so padded entries never contaminate residuals/inners.
        self._op = op
        self.m_local = int(m_local)
        self.axis = axis
        self.m_valid = None if m_valid is None else int(m_valid)

    @property
    def dtype(self):
        return self._op.dtype

    @property
    def grid(self):
        return (self.m_local, self._op.ny)

    vector_shape = grid

    @property
    def hermitian(self):
        return self._op.hermitian

    @property
    def shape(self):
        n_local = self.m_local * self._op.ny
        return (n_local, n_local)

    @property
    def halo_rows(self):
        ro = tuple(b[0] for b in self._op.bands)
        return max((max(0, -min(ro)), max(0, max(ro)), 1))

    def __matmul__(self, x2):
        if x2.ndim == 3:
            return jax.vmap(self._matvec_grid, in_axes=2, out_axes=2)(x2)
        return self._matvec_grid(x2)

    def _matvec_grid(self, x2):
        h = self.halo_rows
        if h > x2.shape[0]:
            raise ValueError(
                f"halo {h} grid rows exceeds local rows {x2.shape[0]}"
            )
        n_ax = lax.axis_size(self.axis)
        top = lax.ppermute(x2[-h:], self.axis, _identity_perm_shift(n_ax, +1))
        bot = lax.ppermute(x2[:h], self.axis, _identity_perm_shift(n_ax, -1))
        row0 = lax.axis_index(self.axis) * self.m_local
        y = self._op._apply_grid(x2, row0=row0, top_halo=top, bot_halo=bot)
        if self.m_valid is not None:
            # const weights apply at padded rows too; zero them so the
            # padded entries of every solver vector stay exactly zero
            gidx = row0 + jnp.arange(self.m_local)
            y = jnp.where((gidx < self.m_valid)[:, None], y, 0)
        return y

    matvec = __matmul__

    def rmatvec(self, x2):
        if self.hermitian:
            return self @ x2
        raise NotImplementedError(
            "sharded const-stencil adjoint: only hermitian operators are "
            "supported (CG/MINRES/GMRES need no rmatvec)"
        )

    def diagonal(self):
        d = self._op.diagonal()[0]  # constant diagonal weight
        return jnp.full(self.grid, d, self.dtype)

    def tree_flatten(self):
        return (), (self._op, self.m_local, self.axis, self.m_valid)

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, m_local, axis, m_valid = aux
        return cls(op, m_local, axis=axis, m_valid=m_valid)
