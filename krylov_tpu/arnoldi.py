"""Arnoldi / Lanczos orthogonalization processes (L2).

Builds V (and P with preconditioning) and H with ``A V_n = V_{n+1} H_n``;
if the Krylov subspace becomes A-invariant the relation truncates to
``A V_n = V_n H_n``.  Capability parity with the reference iterators
(reference: src/krylov/arnoldi.py:33-301): three variants --

* :class:`ArnoldiMGS` -- modified Gram-Schmidt with ``num_reorthos`` passes,
  arbitrary inner product and SPD preconditioner M (maintains the dual basis
  ``V = M P``),
* :class:`ArnoldiLanczos` -- three-term recurrence, O(1) state,
* :class:`ArnoldiHouseholder` -- accumulated Householder reflectors,
  Euclidean inner product only.

Design: the numerical content lives in small *functional steps*
(:func:`mgs_sweep`, :func:`lanczos_step`, :func:`normalize_dual`) --
pure jnp functions over explicit state, the same recurrences the compiled
solvers inline over fixed-shape buffers inside ``lax.while_loop``
(solvers/gmres.py, solvers/minres.py).  The iterator classes here are thin
host-side shells around those steps for the eager / parity interface, where
bases may grow as Python lists.  Householder reflectors are kept as
full-length padded vectors so every application is a whole-vector
elementwise op (no suffix slicing) -- the vmappable formulation a
compiled loop favors.

Invariant-subspace semantics match the reference: the breakdown flag is
raised when the new subdiagonal entry falls below 1e-14, and iterating past
an invariant subspace raises :class:`~krylov_tpu.errors.ArgumentError`.
"""

import jax.numpy as jnp
import numpy as np

from ._inner import get_default_inner
from ._operators import Identity, as_operator
from .errors import ArgumentError
from .householder import Householder
from . import _precision as prec

_BREAKDOWN_TOL = 1.0e-14


# ---------------------------------------------------------------------------
# functional steps (pure; shared conceptually with the compiled solvers)
# ---------------------------------------------------------------------------


def normalize_dual(inner, M, p, v=None, norm=None):
    """Normalize the dual pair ``(p, v = M p)`` in the M-inner product.

    Returns ``(p_hat, v_hat, norm)`` with a division guard: a zero norm
    leaves the vectors untouched instead of producing NaNs (the caller's
    breakdown flag handles that case).
    """
    if v is None:
        v = M @ p
    if norm is None:
        norm = jnp.sqrt(inner(p, v))
    safe = jnp.where(norm != 0.0, norm, 1.0)
    return p / safe, v / safe, norm


def mgs_sweep(inner, V, P, w, coeffs):
    """One modified-Gram-Schmidt pass of ``w`` against the bases.

    Subtracts the ``P``-directions using ``V``-side inner products and
    accumulates the projection coefficients into ``coeffs`` (so repeated
    sweeps sum into the same Hessenberg column).
    """
    for j, (vj, pj) in enumerate(zip(V, P)):
        c = inner(vj, w)
        coeffs = coeffs.at[j].add(c)
        w = w - c * pj
    return w, coeffs


def cgs_sweep(inner, V, P, w, coeffs):
    """One classical-Gram-Schmidt pass of ``w`` against the bases.

    All projection coefficients are measured against the SAME incoming
    ``w`` (unlike :func:`mgs_sweep`, which updates ``w`` between
    projections), so the whole sweep is two batched contractions: one
    basis-sized inner product and one basis combination.  On device meshes
    this is the reduction-batching orthogonalization: the compiled GMRES
    path evaluates it as a single Gram matvec — ONE ``psum`` per sweep
    when sharded, against MGS's k+1 sequential allreduces.  A single pass
    is less stable than MGS; two passes (CGS2, "twice is enough" —
    Giraud/Langou/Rozložník 2005) restores MGS-level orthogonality.
    """
    cs = [inner(vj, w) for vj in V]
    for j, c in enumerate(cs):
        coeffs = coeffs.at[j].add(c)
    w = w - sum(c * pj for c, pj in zip(cs, P))
    return w, coeffs


def lanczos_step(A, M, inner, v, p, p_old, beta_prev):
    """One three-term Lanczos recurrence step.

    Returns ``(w, Mw, alpha, beta)`` where ``w`` is the unnormalized next
    direction ``A v - alpha p - beta_prev p_old`` and ``beta`` its M-norm.
    """
    w = jnp.asarray(A @ v)
    if p_old is not None:
        w = w - beta_prev * p_old
    alpha = inner(v, w)
    w = w - alpha * p
    Mw = M @ w
    beta = jnp.sqrt(inner(w, Mw))
    return w, Mw, alpha, beta


def _padded_reflector(w, k):
    """Householder reflector of ``w[k:]`` stored as a full-length vector.

    The reflector annihilates ``w[k+1:]``; entries below ``k`` of the
    stored direction are zero, so applying it is a whole-vector operation.
    """
    house = Householder(w[k:])
    u = jnp.zeros_like(w).at[k:].set(house.v)
    return u, house.beta, house.alpha, house.xnorm


def _apply_reflector(u, beta, x):
    return x - beta * u * prec.vdot(u, x) if x.ndim == 1 else (
        x - beta * u * prec.tensordot(jnp.conj(u), x, axes=(0, 0))
    )


def padded_reflector_at(w, pivot):
    """Householder reflector of ``w[pivot:]`` with a TRACED pivot index.

    The mask-based twin of :func:`_padded_reflector` (same Golub–Van Loan
    branch-free construction as :class:`~krylov_tpu.householder.Householder`)
    for use inside ``lax.while_loop``/``fori_loop`` where ``pivot`` is a
    traced integer and suffix slicing is unavailable.  Entries above the
    pivot of the returned direction are exactly zero, so applying the
    reflector stays a whole-vector operation.

    Returns ``(u, beta, alpha, xnorm)`` with ``u`` unit-norm full length,
    ``H w = alpha * xnorm * e_pivot`` on the suffix.  Supports trailing
    per-RHS dims (masks broadcast along them).
    """
    w = jnp.asarray(w)
    n = w.shape[0]
    tail = w.shape[1:]
    idx = jnp.arange(n).reshape((n,) + (1,) * len(tail))
    on_pivot = idx == pivot
    below = idx > pivot

    gamma = jnp.sum(jnp.where(on_pivot, w, 0), axis=0)       # w[pivot]
    sigma2 = jnp.sum(jnp.where(below, jnp.abs(w) ** 2, 0.0), axis=0)
    abs_gamma = jnp.abs(gamma)
    xnorm_full = jnp.sqrt(abs_gamma**2 + sigma2)

    is_e1 = sigma2 == 0
    gamma_zero = abs_gamma == 0
    sign_gamma = gamma / jnp.where(gamma_zero, 1.0, abs_gamma)

    beta = jnp.where(is_e1, 0.0, 2.0)
    xnorm = jnp.where(is_e1, abs_gamma, xnorm_full)
    one = jnp.ones_like(gamma)
    v0 = jnp.where(
        is_e1,
        one,
        jnp.where(
            gamma_zero,
            (-jnp.sqrt(sigma2)).astype(w.dtype) * one,
            gamma + sign_gamma * xnorm_full,
        ),
    )
    alpha = jnp.where(
        is_e1,
        jnp.where(
            gamma_zero, one, gamma / jnp.where(is_e1 & ~gamma_zero, xnorm, 1.0)
        ),
        jnp.where(gamma_zero, one, -sign_gamma),
    )
    v = jnp.where(on_pivot, v0, jnp.where(below, w, 0))
    vnorm = jnp.sqrt(jnp.abs(v0) ** 2 + sigma2)
    return v / vnorm, beta, alpha, xnorm


# ---------------------------------------------------------------------------
# eager iterator shells
# ---------------------------------------------------------------------------


class _Process:
    """Shared iteration shell: breakdown guard + counter."""

    def __init__(self):
        self.iter = 0
        self.is_invariant = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.is_invariant:
            raise ArgumentError(
                "Krylov subspace was found to be invariant in the previous "
                "iteration."
            )
        out = self._advance()
        self.iter += 1
        return out

    def _flag_breakdown(self, subdiag):
        if bool(np.all(np.asarray(subdiag) <= _BREAKDOWN_TOL)):
            self.is_invariant = True
            return True
        return False

    @staticmethod
    def _result_dtype(*objs):
        return np.result_type(*(getattr(o, "dtype", o) for o in objs))


class ArnoldiMGS(_Process):
    """Arnoldi via (re-orthogonalized) modified Gram-Schmidt.

    With a preconditioner M, maintains the dual bases ``P`` and ``V = M P``
    (capability parity: reference src/krylov/arnoldi.py:107-200).
    """

    def __init__(self, A, v, num_reorthos=1, M=None, Mv=None, Mv_norm=None,
                 inner=None):
        super().__init__()
        self.A = A
        self.M = Identity() if M is None else as_operator(M)
        self.inner = get_default_inner(v.shape) if inner is None else inner
        self.num_reorthos = num_reorthos
        v = jnp.asarray(v)
        self.dtype = self._result_dtype(A, self.M, v)
        # per-RHS scalar shape comes from the inner product itself (a
        # full-contraction inner on grid-shaped vectors yields tail == ());
        # evaluated concretely because user inners may be numpy-based
        self.tail = tuple(jnp.shape(self.inner(v, v)))

        p0, v0, self.vnorm = normalize_dual(
            self.inner, self.M, v, v=Mv, norm=Mv_norm
        )
        self.P = [p0]
        self.V = [v0]

    def _advance(self):
        k = self.iter
        w = jnp.asarray(self.A @ self.V[k])
        hcol = jnp.zeros((k + 2,) + self.tail, dtype=self.dtype)
        for _ in range(self.num_reorthos):
            w, hcol = mgs_sweep(self.inner, self.V, self.P, w, hcol)

        Mw = self.M @ w
        subdiag = jnp.sqrt(self.inner(w, Mw))
        hcol = hcol.at[k + 1].set(subdiag)

        if self._flag_breakdown(subdiag):
            return None, hcol
        p_new, v_new, _ = normalize_dual(
            self.inner, self.M, w, v=Mw, norm=subdiag
        )
        self.P.append(p_new)
        self.V.append(v_new)
        return v_new, hcol


class ArnoldiCGS(_Process):
    """Arnoldi via (re-orthogonalized) classical Gram-Schmidt.

    A build-side extension beyond the reference (which offers mgs/mgsN/
    householder, reference src/krylov/arnoldi.py:107-200): every sweep is
    two batched contractions instead of k+1 dependent inner products, so
    the distributed GMRES pays one allreduce per sweep.  ``num_passes=2``
    (CGS2) is the recommended stable setting.
    """

    def __init__(self, A, v, num_passes=2, M=None, Mv=None, Mv_norm=None,
                 inner=None):
        super().__init__()
        self.A = A
        self.M = Identity() if M is None else as_operator(M)
        self.inner = get_default_inner(v.shape) if inner is None else inner
        self.num_passes = num_passes
        v = jnp.asarray(v)
        self.dtype = self._result_dtype(A, self.M, v)
        self.tail = tuple(jnp.shape(self.inner(v, v)))

        p0, v0, self.vnorm = normalize_dual(
            self.inner, self.M, v, v=Mv, norm=Mv_norm
        )
        self.P = [p0]
        self.V = [v0]

    def _advance(self):
        k = self.iter
        w = jnp.asarray(self.A @ self.V[k])
        hcol = jnp.zeros((k + 2,) + self.tail, dtype=self.dtype)
        for _ in range(self.num_passes):
            w, hcol = cgs_sweep(self.inner, self.V, self.P, w, hcol)

        Mw = self.M @ w
        subdiag = jnp.sqrt(self.inner(w, Mw))
        hcol = hcol.at[k + 1].set(subdiag)

        if self._flag_breakdown(subdiag):
            return None, hcol
        p_new, v_new, _ = normalize_dual(
            self.inner, self.M, w, v=Mw, norm=subdiag
        )
        self.P.append(p_new)
        self.V.append(v_new)
        return v_new, hcol


class ArnoldiLanczos(_Process):
    """Three-term Lanczos recurrence; O(1) state ``(p_old, p, v)``.

    (capability parity: reference src/krylov/arnoldi.py:203-281)
    """

    def __init__(self, A, v, M=None, Mv=None, Mv_norm=None, inner=None):
        super().__init__()
        self.A = A
        self.M = Identity() if M is None else as_operator(M)
        self.inner = get_default_inner(v.shape) if inner is None else inner
        v = jnp.asarray(v)
        self.dtype = self._result_dtype(A, self.M, v)
        self.tail = tuple(jnp.shape(self.inner(v, v)))

        self.p_old = None
        self.p, self.v, self.vnorm = normalize_dual(
            self.inner, self.M, v, v=Mv, norm=Mv_norm
        )
        # current tridiagonal column (upper, diagonal, lower)
        self.h = jnp.zeros((3,) + self.tail, dtype=self.dtype)

    # the reference exposes the step count as num_iter on this variant
    @property
    def num_iter(self):
        return self.iter

    def _advance(self):
        beta_prev = self.h[2] if self.iter > 0 else None
        w, Mw, alpha, beta = lanczos_step(
            self.A, self.M, self.inner, self.v, self.p,
            self.p_old if self.iter > 0 else None, beta_prev,
        )
        h = jnp.stack(
            [
                jnp.asarray(
                    beta_prev if self.iter > 0 else jnp.zeros_like(beta)
                ),
                jnp.asarray(alpha),
                jnp.asarray(beta),
            ]
        ).astype(self.dtype)
        self.h = h

        if self._flag_breakdown(beta):
            self.v = None
            self.p = None
            return self.v, self.h, self.p
        self.p_old = self.p
        self.p, self.v, _ = normalize_dual(
            self.inner, self.M, w, v=Mw, norm=beta
        )
        return self.v, self.h, self.p


class ArnoldiHouseholder(_Process):
    """Arnoldi via accumulated full-length Householder reflectors.

    Euclidean inner product only (capability parity: reference
    src/krylov/arnoldi.py:33-104).  Reflector ``j`` is padded with zeros
    below index ``j`` so both the forward projection sweep and the basis
    reconstruction are chains of whole-vector updates.
    """

    def __init__(self, A, v):
        super().__init__()
        self.A = A
        self.inner = get_default_inner(v.shape)
        self.v = jnp.asarray(v)
        self.dtype = self._result_dtype(A, self.v)

        u0, b0, a0, self.vnorm = _padded_reflector(self.v, 0)
        self._reflectors = [(u0, b0, a0)]
        safe = jnp.where(self.vnorm != 0.0, self.vnorm, 1.0)
        self.V = [self.v / safe]

    def _project(self, w, upto):
        """Apply reflectors 0..upto, fixing the phase of entry j each step."""
        for j in range(upto + 1):
            u, beta, alpha = self._reflectors[j]
            w = _apply_reflector(u, beta, w)
            w = w.at[j].multiply(jnp.conj(alpha))
        return w

    def _reconstruct(self, k):
        """Basis vector k: reflectors applied to e_k in reverse order."""
        e = jnp.zeros_like(self.v).at[k].set(1)
        for u, beta, _ in reversed(self._reflectors):
            e = _apply_reflector(u, beta, e)
        return e * self._reflectors[-1][2]

    def _advance(self):
        k = self.iter
        w = self._project(jnp.asarray(self.A @ self.V[k]), k)
        n = self.v.shape[0]

        if k + 1 >= n:
            hcol = jnp.zeros((n + 1,) + self.v.shape[1:], w.dtype).at[:n].set(w)
            self.is_invariant = True
            return None, hcol

        u, beta, alpha, xnorm = _padded_reflector(w, k + 1)
        self._reflectors.append((u, beta, alpha))
        w = _apply_reflector(u, beta, w).at[k + 1].multiply(jnp.conj(alpha))
        hcol = w[: k + 2].at[-1].set(jnp.abs(w[k + 1]))

        if self._flag_breakdown(hcol[-1]):
            return None, hcol
        v_new = self._reconstruct(k + 1)
        self.V.append(v_new)
        return v_new, hcol


def arnoldi_res(A, V, H, inner=None):
    """Arnoldi residual ``|| A V_n - V_{n+1} H_n ||`` (diagnostic).

    (capability parity: reference src/krylov/arnoldi.py:284-301)
    """
    invariant = H.shape[0] == H.shape[1]
    V1 = V if invariant else V[:, :-1]
    res = A @ V1 - prec.dot(V, H)
    if inner is None:
        inner = get_default_inner(res.shape)
    return jnp.sqrt(inner(res, res))
