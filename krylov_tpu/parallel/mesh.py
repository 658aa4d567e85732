"""Mesh construction and mesh-aware reductions.

The reference is a single-process NumPy program with no communication layer
(SURVEY.md §2.3; reference: src/krylov/_helpers.py:101-110 is the only
"parallelism" — multi-RHS einsum blocking).  Here the distribution layer is
device-native from the start:

* a 1-D or 2-D ``jax.sharding.Mesh`` with a ``rows`` axis (row-partitioning of
  the operator and all iterate vectors — the problem-dimension analogue of
  sequence parallelism) and an optional ``rhs`` axis (data-parallel blocking of
  right-hand-side columns),
* inner products and norms become ``jax.lax.psum`` allreduces over ``rows`` —
  which XLA lowers to the platform's collective library (NCCL on GPUs).

Every sharded solve is SPMD: the identical compiled program runs on each
device, reductions are the only cross-device synchronization points (2 per CG
iteration, k+1 per GMRES iteration — SURVEY.md §3.2).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh

from .. import _precision as prec

ROWS = "rows"
RHS = "rhs"


def make_mesh(n_rows=None, n_rhs=1, devices=None):
    """Create a ``(rows, rhs)`` device mesh.

    ``n_rows=None`` uses all available devices on the rows axis.  The ``rows``
    axis partitions the matrix rows / vector entries; the ``rhs`` axis
    partitions right-hand-side columns (pure data parallelism — no
    communication crosses it).
    """
    devices = jax.devices() if devices is None else devices
    if n_rows is None:
        n_rows = len(devices) // n_rhs
    if n_rows * n_rhs > len(devices):
        raise ValueError(
            f"mesh ({n_rows} x {n_rhs}) needs {n_rows * n_rhs} devices, "
            f"have {len(devices)}"
        )
    dev = np.asarray(devices[: n_rows * n_rhs]).reshape(n_rows, n_rhs)
    return Mesh(dev, (ROWS, RHS))


def psum_inner(b_shape, axis=ROWS):
    """Mesh-aware default inner product.

    Same contraction dispatch as :func:`krylov_tpu.get_default_inner`
    (1-D -> conjugated dot, multi-RHS -> leading-axis einsum; capability
    parity with reference src/krylov/_helpers.py:101-110) followed by a
    ``psum`` over the row-partition axis.  Must be called inside
    ``shard_map``; ``b_shape`` is the *local* RHS shape.
    """
    if len(b_shape) == 1:

        def inner_dot(x, y):
            return lax.psum(prec.dot(jnp.conj(x), y), axis)

        return inner_dot

    def inner_einsum(x, y):
        return lax.psum(prec.einsum("i...,i...->...", jnp.conj(x), y), axis)

    return inner_einsum


def psum_fused_inner(axis=ROWS, vector_ndim=1):
    """Fused multi-inner-product: ONE ``psum`` for a whole batch of pairs.

    For solvers that expose a ``fused_inner`` injection point (pipelined
    CG), all of an iteration's scalars travel in a single stacked
    collective instead of one allreduce each — the latency optimization
    that motivates the pipelined recurrences in the first place.  Must be
    called inside ``shard_map``.  Contracts the first ``vector_ndim`` axes
    (1 for flat vectors, 2 for grid-shaped), so blocked multi-RHS solves
    keep their per-column scalars.
    """

    def fused(pairs):
        locs = jnp.stack(
            [
                jnp.sum(jnp.conj(a) * c, axis=tuple(range(vector_ndim)))
                for (a, c) in pairs
            ]
        )
        tot = lax.psum(locs, axis)
        return tuple(tot[i] for i in range(len(pairs)))

    return fused


def psum_batch_inner(axis=ROWS, vector_ndim=1):
    """Mesh-aware batched basis-against-vector inner: ONE psum per sweep.

    The ``batch_inner`` injection point of GMRES's classical-Gram-Schmidt
    orthogonalization (``ortho="cgs"``): contracts the whole stacked
    ``(K+1, n_local, *tail)`` basis buffer against one local vector and
    allreduces the ``(K+1, *tail)`` coefficient block in a single
    collective — where the MGS sweep pays k+1 dependent ``psum`` s.
    ``vector_ndim=2`` contracts grid-shaped vectors.  Must be called
    inside ``shard_map``.
    """
    eq = "kmn...,mn...->k..." if vector_ndim == 2 else "kn...,n...->k..."

    def batch(Vb, w):
        return lax.psum(prec.einsum(eq, jnp.conj(Vb), w), axis)

    return batch


def psum_block_inner(axis=ROWS):
    """Mesh-aware (k, k) block inner product: one psum per contraction."""

    def block(U, V):
        return lax.psum(
            prec.einsum("...k,...l->kl", jnp.conj(U), V), axis
        )

    return block
