"""Complex-safe Householder reflections (L1 primitive).

Constructs ``H`` with ``H x = alpha * ||x||_2 * e_1``, ``|alpha| = 1``,
following Golub & Van Loan (4th ed.) Alg. 5.1.1 + the complex treatment of
Sec. 5.1.13 — the same mathematical variant the reference implements
(reference: src/krylov/householder.py:6-81) — but written entirely branch-free
with ``jnp.where`` guards so a reflector can be constructed and applied inside
compiled (traced) code as well as eagerly.
"""

import jax.numpy as jnp

from ._inner import get_default_inner
from . import _precision as prec


class Householder:
    def __init__(self, x):
        x = jnp.asarray(x)
        assert len(x.shape) == 1 or (len(x.shape) == 2 and x.shape[1] == 1), (
            "Householder only works for quasi-1D vectors. "
            f"Input vector has shape {x.shape}."
        )
        # Householder requires the Euclidean inner product.
        self.inner = get_default_inner(x.shape)

        v_tail = x[1:]
        gamma = x[0]

        sigma2 = self.inner(v_tail, v_tail)
        # sigma2 is exactly real (sum of |.|^2)
        sigma2 = sigma2.real if jnp.iscomplexobj(sigma2) else sigma2
        abs_gamma = jnp.abs(gamma)
        xnorm_full = jnp.sqrt(abs_gamma**2 + sigma2)

        is_e1 = sigma2 == 0  # x is a multiple of the first unit vector
        gamma_zero = abs_gamma == 0

        safe_abs_gamma = jnp.where(gamma_zero, 1.0, abs_gamma)
        sign_gamma = gamma / safe_abs_gamma  # == gamma/|gamma|, or 0 if gamma == 0

        beta = jnp.where(is_e1, 0.0, 2.0)
        xnorm = jnp.where(is_e1, abs_gamma, xnorm_full)

        one = jnp.ones_like(gamma)
        # general case: v0 = gamma + sign(gamma) * ||x||  (v0 = -sqrt(sigma2) if gamma == 0)
        v0_general = jnp.where(
            gamma_zero,
            (-jnp.sqrt(sigma2)).astype(x.dtype) * one,
            gamma + sign_gamma * xnorm_full,
        )
        v0 = jnp.where(is_e1, one, v0_general)

        alpha = jnp.where(
            is_e1,
            jnp.where(gamma_zero, one, gamma / jnp.where(is_e1 & ~gamma_zero, xnorm, 1.0)),
            jnp.where(gamma_zero, one, -sign_gamma),
        )

        v = jnp.concatenate([v0[None] if v0.ndim == x.ndim - 1 else v0, v_tail], axis=0)
        vnorm = jnp.sqrt(jnp.abs(v0) ** 2 + sigma2)

        self.xnorm = xnorm
        self.v = v / vnorm
        self.alpha = alpha
        self.beta = beta

    def __matmul__(self, x):
        """Apply the reflection: ``x - beta * v * <v, x>``."""
        if x.shape != self.v.shape:
            raise ValueError(
                f"Shape mismatch! (v.shape = {self.v.shape} != {x.shape} = x.shape)"
            )
        return x - self.beta * self.v * self.inner(self.v, x)

    def matrix(self):
        """Dense ``I - beta v v^H`` — for testing only."""
        n = self.v.shape[0]
        eye = jnp.zeros([n, n] + list(self.v.shape[1:]), dtype=self.v.dtype)
        idx = jnp.arange(n)
        eye = eye.at[idx, idx].set(1.0)
        vvH = prec.einsum("i...,j...->ij...", self.v, jnp.conj(self.v))
        return eye - self.beta * vvH
