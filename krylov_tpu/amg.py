"""Algebraic multigrid (smoothed-aggregation) preconditioner for general
sparse SPD/HPD matrices.

Extension beyond the reference (which ships no preconditioners — ``M``
is always user-supplied, reference: src/krylov/cg.py:33-36).  Where
:class:`~krylov_tpu.multigrid.MultigridPreconditioner` needs a
constant-coefficient grid stencil, AMG builds its coarse hierarchy from
the MATRIX alone, so it covers variable coefficients, unstructured
meshes, and any symmetric sparsity.

Split of labor:

* **Setup** (once, on host, numpy/scipy, fully vectorized): strength
  graph -> two passes of strongest-neighbor pairwise matching (the
  argmax "best-friend" graph's connected components — Notay-style
  double pairwise, ~4x coarsening per level) -> tentative piecewise-
  constant prolongator -> one damped-Jacobi smoothing pass
  ``P = (I - w D^-1 A) P_hat`` (classic smoothed aggregation) ->
  Galerkin coarse matrix ``A_c = P^H A P``.  No Python-per-row loops:
  everything is scipy sparse algebra plus ``connected_components``.
* **Apply** (every iteration, on device): a static-depth V(s,s) cycle of
  damped-Jacobi smoothing; each level's matvec goes through
  a device :class:`~krylov_tpu.ops.CSROperator` (gather +
  segment-sum).  The coarsest level applies a precomputed dense inverse —
  one dense matrix product instead of a serial direct solve.  The whole cycle is a pytree
  of device arrays and inlines into the compiled ``while_loop`` solver.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from . import _precision as prec

__all__ = ["AMGPreconditioner"]


def _strength_graph(A, theta):
    """Symmetric strength-of-connection: keep off-diagonal (i, j) with
    |a_ij| >= theta * sqrt(|a_ii| |a_jj|); entries hold the normalized
    strength."""
    import scipy.sparse

    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    off = C.row != C.col
    r, c, v = C.row[off], C.col[off], C.data[off]
    s = np.abs(v) / np.sqrt(d[r] * d[c])
    keep = s >= theta
    return scipy.sparse.csr_matrix(
        (s[keep], (r[keep], c[keep])), shape=A.shape
    )


def _first_valid_per_row(n, row_sorted, col_sorted, valid):
    """``best[i]`` = first valid col of row ``i`` in a (row asc, strength
    desc)-sorted COO stream; -1 where a row has none.  O(nnz), no sort."""
    rv = row_sorted[valid]
    best = np.full(n, -1, dtype=np.int64)
    if rv.size:
        cv = col_sorted[valid]
        first = np.ones(rv.size, dtype=bool)
        first[1:] = rv[1:] != rv[:-1]  # rv is non-decreasing
        best[rv[first]] = cv[first]
    return best


def _pairwise_labels(A, theta, rounds=8):
    """One pass of strongest-neighbor pairwise matching.

    Luby-style rounds: every unmatched node points at its strongest
    still-unmatched neighbor; MUTUAL pairs match (a deterministic
    symmetric jitter breaks strength ties, otherwise uniform stencils
    degenerate into long chains).  Leftover nodes then join their
    strongest matched neighbor's pair, so aggregates are size 1-4.
    The strength stream is sorted ONCE; each round is a linear scan.
    Returns (labels, n_agg).

    The hot path is the native C++ twin (``csrc/amg_agg.cpp``,
    label-identical by construction — same strength values, jitter, and
    stable sort; tests assert equality); this numpy implementation is
    the fallback and ground truth (``KRYLOV_TPU_NO_NATIVE=1``)."""
    from .ops import _native

    if A.has_sorted_indices:
        native = _native.amg_pairwise_labels_native(A, theta, rounds)
        if native is not None:
            return native
    n = A.shape[0]
    S = _strength_graph(A, theta).tocoo()
    r, c, s = S.row.astype(np.int64), S.col.astype(np.int64), S.data
    if s.size:
        u, v = np.minimum(r, c), np.maximum(r, c)
        jitter = ((u * 2654435761 + v * 40503) % (1 << 20)) / float(1 << 20)
        s = s * (1.0 + 1e-6 * jitter)
        # sort by (row asc, strength desc): rows are 2 apart, strengths
        # mapped into (0, 1), so rows never interleave
        key = r * 2.0 - (s / (abs(s.max()) + 1.0)) * 0.5
        order = np.argsort(key, kind="stable")
        r, c = r[order], c[order]

    unmatched = np.ones(n, dtype=bool)
    mate = np.full(n, -1, dtype=np.int64)
    i = np.arange(n)
    for _ in range(rounds):
        if not unmatched.any() or s.size == 0:
            break
        best = _first_valid_per_row(n, r, c, unmatched[r] & unmatched[c])
        ok = (best >= 0) & unmatched
        mutual = ok & (best[np.clip(best, 0, n - 1)] == i) & (i < best)
        a, b_ = i[mutual], best[mutual]
        if a.size == 0:
            break
        mate[a], mate[b_] = b_, a
        unmatched[a] = unmatched[b_] = False

    # label matched pairs
    labels = np.full(n, -1, dtype=np.int64)
    pair_lead = (mate >= 0) & (i < mate)
    leads = np.flatnonzero(pair_lead)
    labels[leads] = np.arange(leads.size)
    labels[mate[leads]] = labels[leads]
    # leftovers join their strongest already-labeled neighbor
    if unmatched.any() and s.size:
        best = _first_valid_per_row(n, r, c, unmatched[r] & ~unmatched[c])
        join = unmatched & (best >= 0)
        labels[join] = labels[np.clip(best, 0, n - 1)][join]
        unmatched[join] = False
    # true isolates become singletons
    singles = np.flatnonzero(labels < 0)
    labels[singles] = leads.size + np.arange(singles.size)
    return labels, leads.size + singles.size


def _aggregate(A, theta):
    """Double pairwise matching (two rounds -> ~4x coarsening).

    The composed labels are renumbered by FIRST OCCURRENCE along the
    fine ordering — a pure renumbering of the same partition that keeps
    the coarse unknowns (and hence the Galerkin coarse matrix and the
    tentative prolongator's columns) in fine-row order, so P_hat and the
    coarse levels keep the fine ordering's locality (matching labels
    pairs and singleton ids otherwise interleave across the whole index
    range)."""
    import scipy.sparse

    l1, n1 = _pairwise_labels(A, theta)
    # A1 = Q1^T A Q1 with Q1 the tentative (one unit nonzero per row)
    # aggregation operator is a pure relabel-and-sum of A's entries:
    # A1[l1[i], l1[j]] += A[i, j] — exactly the native RAP with no
    # prolongator smoothing; one coo->csr pass (duplicate summation in
    # C) is the fallback/ground truth.
    A1 = None
    if A.has_sorted_indices and not np.iscomplexobj(A.data):
        from .ops import _native

        A1 = _native.amg_rap_native(A, l1, n1, None)
    if A1 is None:
        C = A.tocoo()
        A1 = scipy.sparse.csr_matrix(
            (C.data, (l1[C.row], l1[C.col])), shape=(n1, n1)
        )
        A1.sort_indices()  # canonical for both matching paths
    l2, n2 = _pairwise_labels(A1, theta)
    labels = l2[l1]
    first_pos = np.sort(np.unique(labels, return_index=True)[1])
    rank = np.empty(n2, np.int64)
    rank[labels[first_pos]] = np.arange(n2)
    return rank[labels], n2


def _lmax_dinv_a(Al, iters=12):
    """``lmax(D^-1 A)`` by a short host-side power iteration (matrix-free:
    ``y = (A x) / d`` — forming the scaled matrix would copy O(nnz); the
    iterate stays in ``Al.dtype``, otherwise scipy silently promotes the
    whole matrix per matvec — measured 5x on f32 hierarchies)."""
    d = Al.diagonal()
    d = np.where(d != 0, d, 1.0)
    rdtype = np.empty(0, Al.dtype).real.dtype
    x = np.random.default_rng(0).standard_normal(
        Al.shape[0]
    ).astype(rdtype)
    x /= np.linalg.norm(x)
    lmax = 1.0
    for _ in range(iters):
        y = (Al @ x) / d
        lmax = float(np.linalg.norm(y))
        if lmax == 0.0:
            return 1.0
        x = y / lmax
    return lmax


def _lmax_gershgorin(Al):
    """Gershgorin bound ``lmax(D^-1 A) <= max_i sum_j |a_ij| / |d_i|``.

    One vectorized O(nnz) pass — no matvecs.  Always an OVERestimate,
    which is the safe direction everywhere it is used: the SA prolongator
    weight ``4/(3 lmax)`` and the Jacobi/Chebyshev smoother weights only
    get (slightly) more conservative.  Exact for the Poisson family
    (both sides equal 2)."""
    if Al.nnz == 0:
        return 1.0
    d = np.abs(Al.diagonal())
    d = np.where(d > 0, d, 1.0)
    row_ids = np.repeat(np.arange(Al.shape[0]), np.diff(Al.indptr))
    rowsum = np.bincount(
        row_ids, weights=np.abs(Al.data), minlength=Al.shape[0]
    )
    return float(np.max(rowsum / d))


def _lmax_estimate(Al, lmax_method):
    if lmax_method == "gershgorin":
        return _lmax_gershgorin(Al)
    if lmax_method == "power":
        return _lmax_dinv_a(Al)
    raise ValueError(f"unknown lmax_method {lmax_method!r}")


def _smoothed_prolongator(Al, theta, smooth_prolongator,
                          lmax_method="power", need_P=True):
    """One coarsening step: aggregate, build the tentative piecewise-
    constant prolongator ``P_hat``, optionally smooth it (classic SA,
    ``P = (I - w D^-1 A) P_hat`` computed as a row-scaled ``A @ P_hat``
    so the scaled matrix is never materialized), and return
    ``(P, A_coarse, lmax, labels, n_agg)`` — or ``None`` when
    coarsening stalls.

    ``need_P=False`` (the single-device hierarchy, which applies the SA
    transfer implicitly from ``P_hat`` + labels) routes the Galerkin
    triple product through the native marker-accumulator pass
    (``csrc/amg_rap.cpp``, ~6x scipy's three spgemms at 1M rows) and
    returns ``P=None``; this scipy path is its fallback and ground
    truth (tests/test_native_ab.py)."""
    import scipy.sparse

    labels, n_agg = _aggregate(Al, theta)
    if n_agg >= 0.9 * Al.shape[0]:
        return None  # coarsening stalled (e.g. diagonal matrix)
    lmax = _lmax_estimate(Al, lmax_method)
    if not need_P and Al.has_sorted_indices:
        from .ops import _native

        scale = None
        if smooth_prolongator:
            d = Al.diagonal()
            d = np.where(d != 0, d, 1.0)
            scale = (4.0 / (3.0 * lmax)) / np.real(d)
        Ac = _native.amg_rap_native(Al, labels, n_agg, scale)
        if Ac is not None:
            return None, Ac, lmax, labels, n_agg
    P = scipy.sparse.csr_matrix(
        (np.ones(Al.shape[0], Al.dtype),
         (np.arange(Al.shape[0]), labels)),
        shape=(Al.shape[0], n_agg),
    )
    if smooth_prolongator:
        # w = 4/(3 lmax): the classic SA prolongator smoother
        AP = (Al @ P).tocsr()
        d = Al.diagonal()
        d = np.where(d != 0, d, 1.0)
        scale = (4.0 / (3.0 * lmax)) / d
        AP.data *= np.repeat(scale, np.diff(AP.indptr))
        P = (P - AP).tocsr()
    # conjugate(copy=False) returns Al's P unchanged for real dtypes —
    # P.conj() would copy O(nnz) data before the transpose view
    Ac = (P.conjugate(copy=False).T @ Al @ P).tocsr()
    Ac.sort_indices()  # canonical: next level's matching needs it
    return P, Ac, lmax, labels, n_agg


def _device_sparse(sp):
    """A setup-side scipy matrix as a :class:`CSROperator` with HOST
    (numpy) leaves.

    Unlike :func:`as_operator` there is no BSR detection (the O(nnz) block
    probe cost 2 s at 1M rows and Galerkin/SA levels are never
    block-structured), and every array stays on host until the setup
    moves it with ``jax.device_put``."""
    from .ops.sparse import CSROperator

    return CSROperator.from_scipy(sp, to_device=False)


@register_pytree_node_class
class AMGPreconditioner:
    """``z = M @ r`` runs one smoothed-aggregation AMG V-cycle.

    Build with :meth:`from_scipy`; use as the ``M`` of cg/minres (or the
    ``Ml`` of the two-sided family) in either backend — the cycle is a
    pytree of static-depth level operators, so it crosses ``jit`` and
    inlines into the compiled ``while_loop`` drivers.

    Accepts 1-D and blocked ``(N, k)`` right-hand sides.
    """

    def __init__(self, ops, phats, dinvs, coarse_inv, smooth, omega,
                 smoother="jacobi", lmaxs=(), coarse_op=None,
                 coarse_dinv=None, p_w=()):
        self._ops = tuple(ops)
        # the smoothed-aggregation prolongator is applied IMPLICITLY:
        # P = (I - w D^-1 A) P_hat, where P_hat is the TENTATIVE
        # (one-nonzero-per-row) aggregation operator and A is the level
        # operator already on device.  Only P_hat / P_hat^T ship as
        # device operators (N nnz); the smoothed P as an explicit matrix
        # would hold several times P_hat's entries.  A transfer costs one
        # extra level-matvec + a P_hat apply.  p_w[level] is w (None:
        # unsmoothed P_hat — plain aggregation).
        self._phats = tuple(phats)
        self._p_w = tuple(p_w) or (None,) * len(self._phats)
        self._dinvs = tuple(dinvs)
        self._coarse_inv = coarse_inv
        self._coarse_op = coarse_op
        self._coarse_dinv = coarse_dinv
        self.smooth = int(smooth)
        self.omega = float(omega)
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self._lmaxs = tuple(float(v) for v in lmaxs)
        # convergent damped Jacobi needs w * lmax(D^-1 A) < 2; the user
        # omega is calibrated for lmax ~ 2 (M-matrices), so rescale the
        # per-level weight when a level's spectrum reaches higher
        self._jw = tuple(
            self.omega if lm <= 2.0 else self.omega * 2.0 / lm
            for lm in self._lmaxs
        ) or (self.omega,) * len(self._ops)

    @classmethod
    def from_scipy(cls, A, *, theta=0.08, smooth=2, omega=2.0 / 3.0,
                   coarse_size=400, max_levels=12, dtype=None,
                   smooth_prolongator=True, smoother="jacobi",
                   lmax_method="power", fine_operator=None):
        """Build the hierarchy from a scipy sparse (or dense) SPD matrix.

        * ``theta`` — strength threshold on the normalized coupling
          ``|a_ij| / sqrt(a_ii a_jj)``.
        * ``smooth`` / ``omega`` — damped-Jacobi sweeps per level (pre
          and post; symmetric, so CG accepts the cycle).
        * ``coarse_size`` — stop coarsening here and invert densely.
        * ``dtype`` — device dtype for the level operators (defaults to
          the matrix dtype; ``np.float32`` halves the cycle's memory
          traffic).
        * ``smooth_prolongator`` — apply the one-pass Jacobi prolongator
          smoothing of classic SA; turning it off gives plain (pairwise)
          aggregation with sparser coarse levels but more iterations.
        * ``smoother`` — ``"jacobi"`` (``smooth`` damped sweeps) or
          ``"chebyshev"`` (a degree-``smooth+1`` Chebyshev polynomial in
          ``D⁻¹A`` targeting the upper spectrum ``[λmax/30, λmax]`` —
          one extra matvec per application, no inner products, and
          typically a third fewer outer iterations).
        * ``lmax_method`` — per-level ``lmax(D⁻¹A)`` estimate feeding
          the SA prolongator weight and the smoother scaling:
          ``"power"`` (default; 12 host matvecs per level, ~0.7 s at 1M
          rows — its slight underestimate gives the empirically better
          SA weight) or ``"gershgorin"`` (one O(nnz) pass, always a
          safe overestimate — cheaper, typically 1-2 more outer
          iterations).
        * ``fine_operator`` — reuse an existing device operator of the
          SAME matrix as level 0 of the cycle (e.g. the
          ``as_operator(A)`` the solve itself applies).  The fine
          level is the largest operator in the hierarchy; reusing it
          halves fine-level device memory and removes the dominant
          kernel build + host->device transfer from the setup — the
          same sharing the distributed route gets for free
          (``M_partition`` preconditioners wrap the solve's own sharded
          operator).  The caller is responsible for it applying the
          matrix ``A``.
        """
        import scipy.sparse

        # KRYLOV_TPU_AMG_PROFILE=1 prints a per-phase wall-time breakdown
        # (coarsening / operator builds / device_put) to stderr.
        import os as _os
        import sys as _sys
        import time as _time
        _prof = _os.environ.get("KRYLOV_TPU_AMG_PROFILE") == "1"
        _t0 = _time.perf_counter()

        def _mark(label):
            nonlocal _t0
            if _prof:
                t1 = _time.perf_counter()
                print(f"[amg-setup] {label}: {t1 - _t0:.3f}s",
                      file=_sys.stderr, flush=True)
                _t0 = t1

        if not scipy.sparse.issparse(A):
            A = scipy.sparse.csr_matrix(np.asarray(A))
        A = A.tocsr()
        if A.shape[0] != A.shape[1]:
            raise ValueError("AMG needs a square matrix")
        if dtype is not None:
            A = A.astype(dtype, copy=False)  # no-op when already dtype
        if not (A.has_canonical_format and A.has_sorted_indices):
            A = A.copy()  # canonicalize OUR copy, not the user's matrix
            A.sum_duplicates()
            A.sort_indices()

        levels = [A]
        phat_sps = []
        p_ws = []
        lmaxs = []
        while (
            levels[-1].shape[0] > coarse_size
            and len(levels) < max_levels
        ):
            step = _smoothed_prolongator(
                levels[-1], theta, smooth_prolongator,
                lmax_method=lmax_method, need_P=False,
            )
            if step is None:
                break  # coarsening stalled (e.g. diagonal matrix)
            _P, Ac, lmax, labels, n_agg = step
            lmaxs.append(lmax)
            if dtype is not None:
                Ac = Ac.astype(dtype, copy=False)
            p_ws.append(
                float(4.0 / (3.0 * lmax)) if smooth_prolongator else None
            )
            # tentative prolongator (one nonzero per row) — the only
            # transfer matrix that ships to the device; N nnz (labels
            # are near-monotone by construction)
            nf = labels.shape[0]
            phat_sps.append(scipy.sparse.csr_matrix(
                (np.ones(nf, Ac.dtype), (np.arange(nf), labels)),
                shape=(nf, int(n_agg)),
            ))
            levels.append(Ac)
        _mark("coarsening (labels + Galerkin RAP)")

        # level + tentative-prolongator operators build concurrently, and
        # each worker device_puts its operator as soon as it is packed,
        # so host->device transfers overlap the remaining host work.
        # The closing jax.device_put(self) is then a no-op for these
        # leaves and still moves the small host remainder (dinvs,
        # coarse inverse) in one batch.
        from concurrent.futures import ThreadPoolExecutor

        def _build_and_put(m):
            return jax.device_put(_device_sparse(m))

        with ThreadPoolExecutor(max_workers=4) as ex:
            build_levels = levels[:-1]
            if fine_operator is not None and build_levels:
                build_levels = build_levels[1:]
            ops_f = [ex.submit(_build_and_put, m) for m in build_levels]
            ph_f = [
                ex.submit(_build_and_put, p) for p in phat_sps
            ]
            ops = [f.result() for f in ops_f]
            if fine_operator is not None and levels[:-1]:
                ops = [fine_operator] + ops
            phats = [f.result() for f in ph_f]
        _mark("host operator builds (CSR pack)")
        dinvs = []
        for m in levels[:-1]:
            d = m.diagonal()
            d = np.where(d != 0, d, 1.0)
            dinvs.append(np.asarray(1.0 / d))
        n_last = levels[-1].shape[0]
        if n_last <= max(coarse_size, 4096):
            coarse_inv = np.linalg.inv(levels[-1].toarray())
            coarse_op = None
            coarse_dinv = None
        else:
            # coarsening stalled while the level is still too large to
            # densify (e.g. diagonally dominant matrices with an empty
            # strength graph): fall back to damped-Jacobi sweeps — on
            # exactly such matrices Jacobi is a near-exact solver
            coarse_inv = None
            coarse_op = _device_sparse(levels[-1])
            d = levels[-1].diagonal()
            d = np.where(d != 0, d, 1.0)
            lmax_c = _lmax_estimate(levels[-1], lmax_method)
            # fold the convergence-safe Jacobi weight into the vector:
            # the coarse fallback is only ever used by Jacobi sweeps
            scale = omega if lmax_c <= 2.0 else omega * 2.0 / lmax_c
            coarse_dinv = np.asarray(scale / d)
        self = cls(ops, phats, dinvs, coarse_inv, smooth, omega,
                   smoother=smoother, lmaxs=lmaxs[: len(ops)],
                   coarse_op=coarse_op, coarse_dinv=coarse_dinv,
                   p_w=p_ws)
        _mark("coarse inverse + assembly")
        # the rest of the hierarchy (Jacobi vectors, coarse inverse) was
        # assembled on host; ONE batched put moves it
        out = jax.device_put(self)
        if _prof:
            jax.block_until_ready(jax.tree_util.tree_leaves(out))
        _mark("device_put (hierarchy -> device)")
        return out

    # -- observables ----------------------------------------------------
    @property
    def _coarse_n(self):
        return (
            self._coarse_inv.shape[0]
            if self._coarse_inv is not None
            else self._coarse_dinv.shape[0]
        )

    @property
    def shape(self):
        n = self._dinvs[0].shape[0] if self._dinvs else self._coarse_n
        return (n, n)

    @property
    def dtype(self):
        return (
            self._coarse_inv.dtype
            if self._coarse_inv is not None
            else self._coarse_dinv.dtype
        )

    @property
    def n_levels(self):
        return len(self._ops) + 1

    @property
    def level_sizes(self):
        return tuple(d.shape[0] for d in self._dinvs) + (self._coarse_n,)

    hermitian = True

    # -- the cycle -------------------------------------------------------
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
        spectrum [λmax/30, λmax]: one matvec per degree, no inner
        products (the classic multigrid smoother of Adams et al. 2003).
        """
        A = self._ops[level]
        lmax = 1.1 * self._lmaxs[level]  # safety margin on the estimate
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

    def _vcycle(self, level, r):
        if level == len(self._ops):
            if self._coarse_inv is not None:
                return prec.tensordot(self._coarse_inv, r, axes=1)
            # stalled-coarsening fallback: damped-Jacobi sweeps (the
            # weight is folded into coarse_dinv at setup)
            w = self._coarse_dinv.reshape(
                self._coarse_dinv.shape + (1,) * (r.ndim - 1)
            )
            z = w * r
            for _ in range(max(8, 2 * self.smooth)):
                z = z + w * (r - self._coarse_op @ z)
            return z
        z = self._smooth_level(level, None, r, from_zero=True)
        d = r - self._ops[level] @ z
        e = self._vcycle(level + 1, self._restrict_level(level, d))
        z = z + self._prolong_level(level, e)
        return self._smooth_level(level, z, r)

    # -- implicit smoothed-aggregation transfer --------------------------
    # P^H d = P_hat^T (I - w A D^-1) d   (A hermitian, D real positive)
    def _restrict_level(self, level, d):
        w = self._p_w[level]
        if w is not None:
            d = d - w * (self._ops[level] @ self._dinv_mul(level, d))
        return self._phats[level].rmatvec(d)

    # P e = (I - w D^-1 A) P_hat e
    def _prolong_level(self, level, e):
        z = self._phats[level] @ e
        w = self._p_w[level]
        if w is not None:
            z = z - w * self._dinv_mul(level, self._ops[level] @ z)
        return z

    def __matmul__(self, r):
        return self._vcycle(0, r)

    matvec = __matmul__

    def rmatvec(self, x):
        return self @ x  # symmetric cycle

    # -- pytree -----------------------------------------------------------
    def tree_flatten(self):
        return (
            (self._ops, self._phats, self._dinvs, self._coarse_inv,
             self._coarse_op, self._coarse_dinv),
            (self.smooth, self.omega, self.smoother, self._lmaxs,
             self._p_w),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        ops, phats, dinvs, coarse_inv, coarse_op, coarse_dinv = children
        smooth, omega, smoother, lmaxs, p_w = aux
        return cls(ops, phats, dinvs, coarse_inv, smooth, omega,
                   smoother=smoother, lmaxs=lmaxs, coarse_op=coarse_op,
                   coarse_dinv=coarse_dinv, p_w=p_w)
