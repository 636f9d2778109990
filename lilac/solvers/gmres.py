"""Restarted GMRES (SparseBench semantics).

Faithful re-derivation of /root/reference/SparseBench/SRC/reference/
iter.f:106-280: Arnoldi with modified Gram-Schmidt, an incremental QR of
the Hessenberg matrix maintained in (U, Q) columns, the cheap residual
ESTIMATE est = ||r_cycle|| * |q[0, it+1]| used for convergence (tested
against tol * ||r_0||), solution reconstruction by U-backsolve + Krylov
combination at cycle end, and explicit true-residual restart.

Implemented as fixed-shape dense updates inside lax loops: H/Q/U live in
[m+2, m+2] buffers (m = restart), every inner step is O(m·n) vector work +
O(m²) scalar work, so the whole solver jits into one XLA program. Dots are
multiply + reduce-sum (see algebra.FloatAlg.dot).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def gmres_solve(
    matvec: Callable,
    A,
    rhs,
    x0,
    *,
    restart: int = 20,
    maxit: int = 100,
    rtol: float = 1e-6,
    psolve: Callable | None = None,
    dtype=jnp.float64,
):
    """Returns (x, its, hist, true_error).

    `its` counts inner iterations across cycles at the estimate-based stop
    (matching the reference's hist indexing); hist[k] is the residual
    estimate of inner iteration k (1-based k stored at hist[k-1]).
    """
    m = restart
    n = rhs.shape[0]
    precond = psolve is not None

    def mdot(u, v):
        return jnp.sum(u * v)  # see algebra.FloatAlg.dot

    r0 = rhs - matvec(A, x0)
    err0 = jnp.sqrt(mdot(r0, r0))

    ncycles = maxit // m + 1

    def cycle_body(cyc, state):
        x, r, its_done, done, hist, true_err = state
        err1 = jnp.sqrt(mdot(r, r))
        V0 = jnp.zeros((m + 1, n), dtype)
        V0 = V0.at[0].set(r / err1)

        def inner(it, inner_state):
            # it: 0-based inner index (reference it-1)
            x, r, V, H, Q, U, its_done, done, hist, true_err = inner_state

            v_it = V[it]
            mv = psolve(A, v_it) if precond else v_it
            av = matvec(A, mv)

            # modified Gram-Schmidt against v_0..v_it
            def mgs(i, carry):
                av, H = carry
                h = mdot(V[i], av)
                H = H.at[i, it].set(h)
                av = av - h * V[i]
                return (av, H)

            av, H = jax.lax.fori_loop(0, it + 1, mgs, (av, H))
            hnorm = jnp.sqrt(mdot(av, av))
            H = H.at[it + 1, it].set(hnorm)
            V = V.at[it + 1].set(av / hnorm)

            # incremental QR of H's new column into U, Q
            hcol = H[:, it]

            def qr_step(i, carry):
                hcol, U = carry
                s = jnp.sum(Q[:, i] * hcol)  # q rows beyond i+1 are zero
                U = U.at[i, it].set(s)
                hcol = hcol - s * Q[:, i]
                return (hcol, U)

            hcol, U = jax.lax.fori_loop(0, it, qr_step, (hcol, U))
            unorm = jnp.sqrt(jnp.sum(hcol * hcol))
            U = U.at[it, it].set(unorm)
            Q = Q.at[:, it].set(hcol / unorm)

            # orthonormal last column trick (iter.f:206-224): e1
            # orthogonalised against q_0..q_it; only component 0 is used.
            e1 = jnp.zeros(m + 2, dtype).at[0].set(1.0)

            def orth(i, q1):
                s = jnp.sum(Q[:, i] * q1)
                return q1 - s * Q[:, i]

            q1 = jax.lax.fori_loop(0, it + 1, orth, e1)
            qnorm = jnp.sqrt(jnp.sum(q1 * q1))
            q1_0 = q1[0] / qnorm

            est = err1 * jnp.abs(q1_0)
            k = cyc * m + it  # global inner count (0-based)
            hist = hist.at[k].set(est.astype(jnp.float32))

            conv = est < rtol * err0
            last = jnp.logical_or(it == m - 1, k == maxit - 1)
            do_solve = jnp.logical_and(
                jnp.logical_or(conv, last), jnp.logical_not(done)
            )

            def solve(args):
                x, r, true_err = args
                # coefficients: usolve on tmp1[i] = q[0, i] * err1
                b = Q[0, : m + 1] * err1
                # mask to first it+1 entries
                idxs = jnp.arange(m + 1)
                b = jnp.where(idxs <= it, b, 0.0)

                # back substitution U y = b over rows it..0
                def backsub(j, y):
                    row = it - j
                    s = b[row] - jnp.sum(U[row, : m + 1] * y)
                    return y.at[row].set(s / U[row, row])

                y = jax.lax.fori_loop(0, it + 1, backsub, jnp.zeros(m + 1, dtype))
                # HIGHEST: a float32 product must not drop to TF32
                comb = jnp.einsum("k,kn->n", y, V[: m + 1],
                                  precision=jax.lax.Precision.HIGHEST)
                mvv = psolve(A, comb) if precond else comb
                # The reference pairs `x -= z` with `r -= A z`
                # (iter.f:258-262) — consistent only if x ACCUMULATES z, so
                # its returned x is the negated solution (never consumed in
                # the benchmark). The production solver returns the honest
                # x = x0 + corrections, matching the residual it reports.
                x_new = x + mvv
                r_new = r - matvec(A, mvv)
                te = jnp.sqrt(mdot(r_new, r_new))
                return (x_new, r_new, te)

            x, r, true_err = jax.lax.cond(
                do_solve, solve, lambda a: a, (x, r, true_err)
            )
            newly_done = jnp.logical_and(
                do_solve, jnp.logical_or(conv, k == maxit - 1)
            )
            its_done = jnp.where(
                jnp.logical_and(newly_done, jnp.logical_not(done)), k + 1, its_done
            )
            done = jnp.logical_or(done, newly_done)
            return (x, r, V, H, Q, U, its_done, done, hist, true_err)

        H0 = jnp.zeros((m + 2, m + 2), dtype)
        Q0 = jnp.zeros((m + 2, m + 2), dtype)
        U0 = jnp.zeros((m + 2, m + 2), dtype)

        def inner_guarded(it, istate):
            return jax.lax.cond(
                istate[7],  # done
                lambda s: s,
                lambda s: inner(it, s),
                istate,
            )

        x, r, V, H, Q, U, its_done, done, hist, true_err = jax.lax.fori_loop(
            0,
            m,
            inner_guarded,
            (x, r, V0, H0, Q0, U0, its_done, done, hist, true_err),
        )
        return (x, r, its_done, done, hist, true_err)

    hist0 = jnp.zeros(ncycles * m, jnp.float32)
    state = (
        x0,
        r0,
        jnp.int32(0),
        jnp.bool_(False),
        hist0,
        jnp.asarray(0.0, dtype),
    )

    def cycle_guarded(cyc, st):
        return jax.lax.cond(st[3], lambda s: s, lambda s: cycle_body(cyc, s), st)

    x, r, its, done, hist, true_err = jax.lax.fori_loop(
        0, ncycles, cycle_guarded, state
    )
    its = jnp.where(done, its, -maxit)
    return x, its, hist[:maxit], true_err
