"""Generic iteration drivers (shared by all solvers).

The reference duplicates one hand-written ``while True`` host loop per solver
(reference: src/krylov/cg.py:155, gmres.py:179, minres.py:168, ...), each with
the same control-flow idioms:

* convergence criterion ``max(tol * resnorms[0], atol)`` fixed up-front,
* an **explicit-residual double check**: when the recurrence residual norm
  dips below the criterion, the true residual is recomputed and *overwrites*
  the last history entry; success is declared only if the explicit value also
  passes (and the overwritten value persists even if it does not),
* ``maxiter`` bail-out, per-iteration ``callback``, absolute resnorm history.

Here that loop exists exactly once, in two interchangeable backends over the
same functional solver core (``step: state -> state`` on a pytree):

* ``eager``  — host loop; supports arbitrary Python callbacks, custom inner
  products and the float64 parity mode,
* ``while_loop`` — one ``lax.while_loop`` compiled by XLA: the entire solve
  (SpMV, reductions, breakdown guards, residual history) runs on-device with
  zero host round-trips per iteration; the residual history lives in a fixed
  ``(maxiter + 1, *rhs)`` buffer with a valid-length counter.  User
  callbacks fire via ordered ``jax.debug.callback`` — the reference's
  per-iteration ``callback(x, r)`` contract (called ``numsteps + 1``
  times, reference: src/krylov/cg.py:119-120, 202-204) holds on BOTH
  backends.

Solver-specific state is an arbitrary pytree carrying at least ``resnorm``;
solvers with a mid-iteration exit (BiCGSTAB) also carry ``early_success``.
"""


from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

EAGER = "eager"
WHILE_LOOP = "while_loop"


class ShardMonitor:
    """Per-iteration observability hook for SPMD (``shard_map``) solves.

    The reference fires ``callback(x, r)`` every iteration on its only
    execution path (reference: src/krylov/cg.py:119-120, 202-204).  Inside
    an SPMD program that exact contract would be misleading — ``x`` and
    ``r`` are shard-local slabs, and a host callback would fire once PER
    SHARD.  ``ShardMonitor`` is the honest flagship-path analogue: the
    drivers recognize it and fire ``fn(k, resnorm)`` on the rank-0 shard
    of ``axis`` only, where ``k`` is the iteration index (0 for the
    initial residual) and ``resnorm`` the GLOBAL recurrence residual
    norm appended to ``info.resnorms`` at step ``k`` (already ``psum``-
    reduced, hence replicated across shards; the explicit-residual
    double-check may later overwrite history entries — the hook reports
    the recurrence value, matching the reference's callback-vs-history
    semantics).  ``fn`` is called
    ``numsteps + 1`` times, the reference count.  Delivery uses an
    unordered ``jax.debug.callback``; ``k`` identifies the iteration, so
    host-side arrival order never matters.
    """

    def __init__(self, fn, axis=None):
        self.fn = fn
        self.axis = axis

    def __call__(self, *args):
        # solvers' pre-loop ``callback(x0, r0)`` lands here with traced
        # shard-local vectors; the driver fires the (0, resnorm0) monitor
        # call itself — nothing to do
        return None

    def fire(self, k, resnorm):
        def _go(_):
            jax.debug.callback(self.fn, k, resnorm)
            return jnp.int32(0)

        if self.axis is not None:
            lax.cond(
                lax.axis_index(self.axis) == 0, _go, lambda _: jnp.int32(0), 0
            )
        else:
            _go(0)


class Method(NamedTuple):
    """Hooks describing one Krylov method to the generic drivers."""

    step: Callable[[Any, Any], Any]  # (state, criterion) -> state
    xk: Callable[[Any], Any]  # state -> current solution iterate
    # recompute the true residual norm of an iterate; None disables the
    # double-check (stationary methods, reference: src/krylov/stationary.py:138)
    explicit_resnorm: Optional[Callable[[Any], Any]] = None
    # state -> args tuple for the user callback (both backends; the
    # compiled driver fires it through jax.debug.callback)
    callback_args: Optional[Callable[[Any], tuple]] = None
    # eager-only bookkeeping hook, e.g. cg's return_arnoldi basis collection
    on_step: Optional[Callable[[Any, Any], None]] = None


def run(
    state0,
    method: Method,
    *,
    tol: float,
    atol: float,
    maxiter: int,
    callback: Optional[Callable] = None,
    backend: str = EAGER,
):
    """Drive ``method`` to convergence.

    Returns ``(state, success, numsteps, resnorms)`` where ``resnorms`` is a
    host ndarray of shape ``(numsteps + 1, *rhs)`` (eager and concrete
    while_loop) or a ``(buffer, numsteps)`` pair when traced.
    """
    if backend == EAGER:
        return _run_eager(
            state0, method, tol=tol, atol=atol, maxiter=maxiter, callback=callback
        )
    if backend == WHILE_LOOP:
        if method.on_step is not None:
            raise ValueError("on_step bookkeeping requires backend='eager'")
        return _run_while(
            state0, method, tol=tol, atol=atol, maxiter=maxiter,
            callback=callback,
        )
    raise ValueError(f"unknown backend {backend!r}")


def _run_eager(state, method: Method, *, tol, atol, maxiter, callback):
    monitor = callback if isinstance(callback, ShardMonitor) else None
    resnorms = [state.resnorm]
    criterion = jnp.maximum(tol * resnorms[0], atol)
    if monitor is not None:
        monitor.fn(0, np.asarray(state.resnorm))
    success = False
    k = 0
    while True:
        if bool(jnp.all(resnorms[-1] <= criterion)):
            if method.explicit_resnorm is None:
                success = True
                break
            rn = method.explicit_resnorm(method.xk(state))
            resnorms[-1] = rn  # overwrite persists even if the check fails
            if bool(jnp.all(rn <= criterion)):
                success = True
                break
        if k == maxiter:
            break

        new_state = method.step(state, criterion)
        if method.on_step is not None:
            method.on_step(state, new_state)
        state = new_state

        early = getattr(state, "early_success", None)
        if early is not None and bool(early):
            resnorms[-1] = state.resnorm
            success = True
            break

        if monitor is not None:
            monitor.fn(k + 1, np.asarray(state.resnorm))
        elif callback is not None and method.callback_args is not None:
            callback(*method.callback_args(state))

        resnorms.append(state.resnorm)
        k += 1

    resnorms = np.stack([np.asarray(r) for r in resnorms])
    return state, success, k, resnorms


def _run_while(state0, method: Method, *, tol, atol, maxiter,
               callback=None):
    # NESTED loop structure, for in-place buffer aliasing: the INNER
    # ``lax.while_loop`` body is nothing but ``step`` + a scalar history
    # write — no ``lax.cond`` ever touches the solver state, so XLA
    # aliases the state's large buffers in place across iterations.  A
    # single body-level ``lax.cond`` around the step (the previous
    # structure) gave every large array a second consumer, and with it
    # a copy of every large buffer per iteration.  The OUTER loop runs once per
    # convergence EVENT (recurrence residual dips below the criterion,
    # early success, maxiter): it performs the explicit-residual
    # double-check — its ``lax.cond`` executes O(1) times per solve, not
    # per iteration.  Semantics (trajectories, history overwrites,
    # numsteps, callback counts) are identical to the flat loop.
    monitor = callback if isinstance(callback, ShardMonitor) else None
    resnorm0 = state0.resnorm
    rdtype = jnp.asarray(resnorm0).dtype
    buf = jnp.zeros((maxiter + 1,) + jnp.shape(resnorm0), rdtype).at[0].set(resnorm0)
    criterion = jnp.maximum(tol * resnorm0, atol)
    has_early = hasattr(state0, "early_success")
    if monitor is not None:
        monitor.fire(jnp.asarray(0, jnp.int32), resnorm0)
    mi = jnp.asarray(maxiter, jnp.int32)

    def inner_cond(carry):
        return ~carry[3]

    def inner_body(carry):
        s, k, buf, stop = carry
        s2 = method.step(s, criterion)
        if monitor is not None:
            # (k+1, global resnorm) from the rank-0 shard only; an
            # early-success exit overwrites entry k without advancing
            # the count, so it fires no call — same skip as the
            # callback path below, keeping the numsteps+1 total
            def _mfire(a):
                k_, rn_ = a
                monitor.fire(k_ + 1, rn_)
                return jnp.int32(0)

            marg = (k, jnp.asarray(s2.resnorm).astype(rdtype))
            if has_early:
                lax.cond(
                    s2.early_success,
                    lambda a: jnp.int32(0), _mfire, marg,
                )
            else:
                _mfire(marg)
        elif callback is not None and method.callback_args is not None:
            # per-iteration user callback from inside the compiled
            # loop (SURVEY §5; reference contract: called once per
            # iteration, reference: src/krylov/cg.py:202-204).  The
            # values arrive on host as numpy arrays; an early-success
            # exit skips the call, matching the eager driver's
            # break-before-callback ordering.
            cb_args = method.callback_args(s2)

            def _fire(a):
                jax.debug.callback(callback, *a, ordered=True)
                return 0

            if has_early:
                lax.cond(
                    s2.early_success, lambda a: 0, _fire, cb_args
                )
            else:
                _fire(cb_args)
        rn = jnp.asarray(s2.resnorm).astype(rdtype)
        if has_early:
            # mid-iteration exit overwrites the last entry, no append
            early = s2.early_success
            write_at = jnp.where(early, k, k + 1)
            k2 = write_at
        else:
            early = jnp.asarray(False)
            write_at = k + 1
            k2 = write_at
        buf2 = lax.dynamic_update_index_in_dim(buf, rn, write_at, 0)
        below = jnp.all(rn <= criterion)
        return s2, k2, buf2, early | below | (k2 >= mi)

    def outer_cond(carry):
        return ~carry[3]

    def outer_body(carry):
        s, k, buf, done, success = carry
        early_prev = s.early_success if has_early else jnp.asarray(False)
        last = lax.dynamic_index_in_dim(buf, k, 0, keepdims=False)
        # an early-success exit declares success WITHOUT the explicit
        # recheck (the mid-iteration exit already recomputed its value)
        below = jnp.all(last <= criterion) & ~early_prev

        if method.explicit_resnorm is not None:

            def _recheck(args):
                s, buf = args
                rn = method.explicit_resnorm(method.xk(s)).astype(rdtype)
                buf2 = lax.dynamic_update_index_in_dim(buf, rn, k, 0)
                return buf2, jnp.all(rn <= criterion)

            def _pass(args):
                return args[1], jnp.asarray(False)

            buf, ok = lax.cond(below, _recheck, _pass, (s, buf))
        else:
            ok = below

        success = ok | early_prev
        done = success | (k >= mi)
        # a False ``done`` seeds the inner stop flag, so the inner loop
        # runs steps exactly while unconverged; a True one skips it
        s, k, buf, _ = lax.while_loop(
            inner_cond, inner_body, (s, k, buf, done)
        )
        return s, k, buf, done, success

    carry0 = (
        state0,
        jnp.asarray(0, jnp.int32),
        buf,
        jnp.asarray(False),
        jnp.asarray(False),
    )
    state, k, buf, _, success = lax.while_loop(outer_cond, outer_body, carry0)

    if isinstance(k, jax.core.Tracer):
        # inside user jit: hand back the raw buffer + count
        return state, success, k, buf

    if callback is not None:
        jax.effects_barrier()  # all debug callbacks have landed
    k = int(k)
    return state, bool(success), k, np.asarray(buf)[: k + 1]
