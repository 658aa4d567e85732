"""Contractions pinned to full float32 precision.

On a GPU, XLA may run a float32 (or complex64) contraction on the tensor
cores in TF32, which keeps about three decimal digits.  That is far too
coarse for Krylov recurrences: inner products, Gram matrices, basis
updates and dense coarse solves would break convergence at the
tolerances users set.  Every contraction on the solver path goes through
these wrappers, which pass ``precision=lax.Precision.HIGHEST`` per call;
no global configuration is touched.  Elementwise products and plain sums
are not contractions and need nothing.
"""

from functools import partial

import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST

dot = partial(jnp.dot, precision=HIGHEST)
vdot = partial(jnp.vdot, precision=HIGHEST)
einsum = partial(jnp.einsum, precision=HIGHEST)
tensordot = partial(jnp.tensordot, precision=HIGHEST)
matmul = partial(jnp.matmul, precision=HIGHEST)
