"""BiConjugate Gradient solver (SparseBench semantics).

Reproduces the SparseBench bicg algorithm exactly
(/root/reference/SparseBench/SRC/reference/iter.f:18-104) so that iteration
counts and residual histories match `reference_results`:

* initial residual r = A·x − rhs (their sign convention), rl = r;
* convergence test at the TOP of the loop: stop when ||r|| < rtol·||r0||,
  reporting `its` = the iteration index at which the test fired;
* rr = (r, zl); β = rr/rr_prev; p = z + β·p (and the shadow sequence);
* α = rr / (pl, A·p); x ← x − α·p; r ← r − α·A·p; rl ← rl − α·Aᵀ·pl;
* non-convergence encoded as negative its.

Uses the TRUE transpose product Aᵀ·pl — the harnessed reference silently
substituted A for Aᵀ (random.f:50-88 at :72, SURVEY.md section 3.5); the
clean semantics (also what the Fortran baseline computes) is implemented.

Preconditioning: psolve(A, v, 'n'|'t') applies M⁻¹ / M⁻ᵀ.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def bicg_solve(
    matvec: Callable,
    matvec_t: Callable,
    alg,
    A,
    rhs,
    x0,
    *,
    maxit: int = 100,
    rtol: float = 1e-6,
    psolve: Callable | None = None,
    state: tuple | None = None,
    stop_at: int | None = None,
):
    """Returns (x, its, hist, rn_final, state) — hist is the [maxit]
    residual-norm history (zeros past convergence); its > 0 iff converged,
    matching the reference's sign convention.

    `state`/`stop_at` support CHUNKED dispatch: pass stop_at=k to pause
    after iteration k and feed the returned state back in (keeps single
    device programs short at multi-million-row sizes). The iterate path is
    identical to an unchunked run."""
    precond = psolve is not None

    r0vec = alg.sub(matvec(A, x0), rhs)

    def zl_pair(r, rl):
        if precond:
            return psolve(A, r, "n"), psolve(A, rl, "t")
        return r, rl

    dtype = r0vec.hi.dtype if hasattr(r0vec, "hi") else r0vec.dtype

    def body(state):
        (x, r, rl, p, pl, rr, it, done, rn0, hist) = state
        rn = alg.ssqrt(alg.dot(r, r))
        hist = hist.at[it].set(_scal(alg, rn))
        first = it == 0
        rn0_new = jax.tree.map(lambda a, b: jnp.where(first, a, b), rn, rn0)
        # convergence threshold in the algebra's native precision
        thresh = alg.smul(alg.scalar(rtol), rn0_new)
        converged = _lt(alg, rn, thresh)

        z, zl = zl_pair(r, rl)
        rr_new = alg.dot(r, zl)
        beta = alg.sdiv(rr_new, rr)

        def upd(v, zv, first):
            scaled = alg.smul(beta, v)
            return jax.tree.map(
                lambda a, b: jnp.where(first, a, b), zv, alg.add(scaled, zv)
            )

        p_new = upd(p, z, first)
        pl_new = upd(pl, zl, first)

        ap = matvec(A, p_new)
        apl = matvec_t(A, pl_new)
        alpha = alg.sdiv(rr_new, alg.dot(pl_new, ap))
        x_new = alg.sub(x, alg.smul(alpha, p_new))
        r_new = alg.sub(r, alg.smul(alpha, ap))
        rl_new = alg.sub(rl, alg.smul(alpha, apl))

        # freeze updates once converged (the reference exits the loop)
        def sel(new, old):
            return jax.tree.map(lambda a, b: jnp.where(converged, b, a), new, old)

        return (
            sel(x_new, x), sel(r_new, r), sel(rl_new, rl),
            sel(p_new, p), sel(pl_new, pl),
            sel(rr_new, rr),
            it + 1,
            jnp.logical_or(done, converged),
            rn0_new,
            hist,
        )

    # stop_at may be a traced value so chunked callers compile ONE program
    limit = maxit if stop_at is None else jnp.minimum(stop_at, maxit)

    def cond(state):
        it, done = state[6], state[7]
        return jnp.logical_and(it < limit, jnp.logical_not(done))

    if state is None:
        hist0 = jnp.zeros(maxit, jnp.float32)
        state = (
            x0, r0vec, r0vec,
            alg.zeros_like(x0), alg.zeros_like(x0),
            alg.scalar(1.0),
            jnp.int32(0), jnp.bool_(False), alg.scalar(0.0), hist0,
        )
    out = jax.lax.while_loop(cond, body, state)
    x, r, rl, p, pl, rr, it, done, rn0, hist = out
    rn_final = alg.ssqrt(alg.dot(r, r))
    its = jnp.where(done, it, -it)
    return x, its, hist, rn_final, out


def _scal(alg, s):
    from lilac.ops.dfloat import DF

    if isinstance(s, DF):
        return s.hi.astype(jnp.float32)
    return s.astype(jnp.float32)


def _lt(alg, a, b):
    """a < b on algebra scalars via their comparable f32 views."""
    return _scal(alg, a) < _scal(alg, b)
