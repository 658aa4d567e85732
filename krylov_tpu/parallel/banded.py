"""Row-partitioned banded (stencil) operator with halo exchange.

The distributed analogue of :class:`krylov_tpu.ops.stencil.BandedOperator`
(no reference counterpart — the reference is single-process, SURVEY.md §2.3).
Each shard owns a contiguous slab of rows; a row ``i`` reads
``x[i + offset]`` for each stored band, so a shard needs at most
``max(-min(offsets), 0)`` entries from its left neighbor and
``max(max(offsets), 0)`` from its right neighbor.  Those halos travel
between neighbor devices as two ``lax.ppermute`` shifts, after which the
matvec is the same streaming shifted-multiply-accumulate as the
single-device operator.

``lax.ppermute`` fills devices that receive nothing with zeros — exactly the
Dirichlet zero boundary the band coefficients already encode, so no masking
is needed at the domain edges.

Used *inside* ``shard_map``: the constructor receives the local coefficient
block ``coeffs[:, r0 : r0 + n_local]`` (row-aligned storage makes the
partition a plain slice along the row axis).
"""

import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node_class

from .mesh import ROWS


def _identity_perm_shift(n, shift):
    """ppermute pairs moving data from device i to device i+shift (no wrap)."""
    if shift > 0:
        return [(i, i + shift) for i in range(n - shift)]
    return [(i, i + shift) for i in range(-shift, n)]


@register_pytree_node_class
class ShardedBandedOperator:
    """Local row-slab of a banded operator, with halo-exchange matvec.

    ``coeffs`` is the local ``(ndiag, n_local)`` row-aligned coefficient
    block: ``coeffs[d, li] = A[r0 + li, r0 + li + offsets[d]]``.
    """

    def __init__(self, coeffs, offsets, axis=ROWS, hermitian=False):
        self.coeffs = coeffs
        self.offsets = tuple(int(o) for o in offsets)
        self.axis = axis
        self.hermitian = bool(hermitian)

    @property
    def shape(self):
        n_local = self.coeffs.shape[1]
        return (n_local, n_local)  # local block shape (square, SPMD view)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def halo(self):
        """(left, right) halo widths in rows."""
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        return lo, hi

    def exchange_halo(self, x, halo=None):
        """Return ``x_ext = [left halo | x | right halo]`` along axis 0.

        Two neighbor ``ppermute`` shifts; edge shards receive zeros
        (Dirichlet).  Requires halo width <= n_local (single-neighbor halos).
        ``halo`` overrides the matvec-oriented ``self.halo`` widths — the
        adjoint matvec needs them swapped (see :meth:`rmatvec`).
        """
        h_lo, h_hi = self.halo if halo is None else halo
        n_local = x.shape[0]
        if max(h_lo, h_hi) > n_local:
            raise ValueError(
                f"halo width {max(h_lo, h_hi)} exceeds local rows {n_local}; "
                "use fewer shards or an all-gather operator"
            )
        n_ax = lax.axis_size(self.axis)
        parts = []
        if h_lo:
            # left halo: my left neighbor's LAST h_lo entries -> me
            parts.append(
                lax.ppermute(x[-h_lo:], self.axis, _identity_perm_shift(n_ax, +1))
            )
        parts.append(x)
        if h_hi:
            # right halo: my right neighbor's FIRST h_hi entries -> me
            parts.append(
                lax.ppermute(x[:h_hi], self.axis, _identity_perm_shift(n_ax, -1))
            )
        return jnp.concatenate(parts, axis=0) if len(parts) > 1 else x

    def __matmul__(self, x):
        h_lo, _ = self.halo
        n_local = x.shape[0]
        x_ext = self.exchange_halo(x)
        y = jnp.zeros(x.shape, jnp.result_type(self.coeffs, x))
        for d, off in enumerate(self.offsets):
            c = self.coeffs[d].reshape((n_local,) + (1,) * (x.ndim - 1))
            seg = lax.dynamic_slice_in_dim(x_ext, h_lo + off, n_local, axis=0)
            y = y + c * seg
        return y

    matvec = __matmul__

    def rmatvec(self, x):
        if self.hermitian:
            return self @ x
        # A^H in row-aligned banded form has bands at -off with coefficients
        # conj(coeffs[d]) shifted by off rows — the shift crosses shard
        # boundaries, so exchange a coefficient halo alongside the x halo.
        # The x halo widths are the MIRROR of the matvec's: y[i] reads
        # x[i - off], so the left halo must cover max(offsets) and the right
        # halo -min(offsets) (matvec uses the opposite pair).
        h_lo = max(0, max(self.offsets))
        h_hi = max(0, -min(self.offsets))
        n_local = x.shape[0]
        x_ext = self.exchange_halo(x, halo=(h_lo, h_hi))
        y = jnp.zeros(x.shape, jnp.result_type(self.coeffs, x))
        n_ax = lax.axis_size(self.axis)
        for d, off in enumerate(self.offsets):
            # y[i] += conj(A[i - off, i]) * x[i - off]
            #       = conj(coeffs[d, i - off]) * x[i - off]
            c_loc = jnp.conj(self.coeffs[d])
            if off > 0:
                halo = lax.ppermute(
                    c_loc[-off:], self.axis, _identity_perm_shift(n_ax, +1)
                )
                c_ext = jnp.concatenate([halo, c_loc[:-off]], axis=0)
                seg = lax.dynamic_slice_in_dim(x_ext, h_lo - off, n_local, axis=0)
            elif off < 0:
                halo = lax.ppermute(
                    c_loc[:-off], self.axis, _identity_perm_shift(n_ax, -1)
                )
                c_ext = jnp.concatenate([c_loc[-off:], halo], axis=0)
                seg = lax.dynamic_slice_in_dim(x_ext, h_lo - off, n_local, axis=0)
            else:
                c_ext = c_loc
                seg = x
            y = y + c_ext.reshape((n_local,) + (1,) * (x.ndim - 1)) * seg
        return y

    def diagonal(self):
        if 0 in self.offsets:
            return self.coeffs[self.offsets.index(0)]
        return jnp.zeros(self.coeffs.shape[1], self.dtype)

    def tree_flatten(self):
        return (self.coeffs,), (self.offsets, self.axis, self.hermitian)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, axis, hermitian = aux
        return cls(children[0], offsets, axis=axis, hermitian=hermitian)
