"""Conjugate-gradient solvers.

`npb_conj_grad` reproduces the NPB CG inner solve exactly — same update
order, fixed 25 iterations, explicit final residual
(/root/reference/NPB3.3.1/CG/cg.f:447-639). `npb_power_method` is the outer
inverse-power iteration with the ζ update (cg.f:299-349). `cg_solve` is the
general residual-tolerance CG used by SparseBench-style workloads
(/root/reference/SparseBench/SRC/reference/iter_symm.f:18).

All solvers are pure functions of (A, x) built to jit as one program: inner
iterations via lax.fori_loop / lax.while_loop, outer via lax.scan, so a
whole benchmark run is a single XLA executable (no per-iteration host
dispatch — the answer here to the reference's per-call .so hop).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def npb_conj_grad(matvec: Callable, alg, A, x, cgitmax: int = 25):
    """One NPB conj_grad call: returns (z, rnorm) per cg.f:447-639."""
    z = alg.zeros_like(x)
    r = x
    p = r
    rho = alg.dot(r, r)

    def body(_, carry):
        z, r, p, rho = carry
        q = matvec(A, p)
        d = alg.dot(p, q)
        alpha = alg.sdiv(rho, d)
        z = alg.add(z, alg.smul(alpha, p))
        r = alg.sub(r, alg.smul(alpha, q))
        rho_new = alg.dot(r, r)
        beta = alg.sdiv(rho_new, rho)
        p = alg.add(r, alg.smul(beta, p))
        return (z, r, p, rho_new)

    z, r, p, rho = jax.lax.fori_loop(0, cgitmax, body, (z, r, p, rho))

    az = matvec(A, z)
    d = alg.sub(x, az)
    rnorm = alg.ssqrt(alg.dot(d, d))
    return z, rnorm


def npb_power_method(
    matvec: Callable, alg, A, x0, shift: float, niter: int, cgitmax: int = 25
):
    """NPB CG outer loop (cg.f:299-349): niter inverse-power iterations.

    Returns (zeta_history, rnorm_history, x_final) — zeta/rnorm as the
    algebra's scalar type, stacked over iterations.
    """

    def step(x, _):
        shift_s = alg.scalar(shift)
        one = alg.scalar(1.0)
        z, rnorm = npb_conj_grad(matvec, alg, A, x, cgitmax)
        norm1 = alg.dot(x, z)
        norm2 = alg.dot(z, z)
        zeta = alg.add(shift_s, alg.sdiv(one, norm1))
        inv = alg.sdiv(one, alg.ssqrt(norm2))
        x_new = alg.smul(inv, z)
        return x_new, (zeta, rnorm)

    x_final, (zetas, rnorms) = jax.lax.scan(step, x0, None, length=niter)
    return zetas, rnorms, x_final


def cg_solve(
    matvec: Callable,
    alg,
    A,
    b,
    x0=None,
    *,
    maxit: int = 100,
    rtol: float = 1e-6,
    precond: Callable | None = None,
):
    """Preconditioned CG with SparseBench's stopping rule (iter_symm.f:18):
    iterate until ||r||_2 <= rtol * ||r0||_2 or maxit.

    Returns (x, iterations, final_residual_norm). Runs as one jitted
    while_loop; `precond(A, r)` applies M^-1 (identity if None).
    """
    if x0 is None:
        x0 = alg.zeros_like(b)
    psolve = precond if precond is not None else (lambda A, r: r)

    r = alg.sub(b, matvec(A, x0))
    z = psolve(A, r)
    p = z
    rho = alg.dot(r, z)
    rnorm0 = alg.ssqrt(alg.dot(r, r))
    tol = alg.smul(alg.scalar(rtol), rnorm0)

    def cond(carry):
        x, r, p, rho, rnorm, it = carry
        return jnp.logical_and(
            it < maxit, _as_f32(alg, rnorm) > _as_f32(alg, tol)
        )

    def body(carry):
        x, r, p, rho, rnorm, it = carry
        q = matvec(A, p)
        d = alg.dot(p, q)
        alpha = alg.sdiv(rho, d)
        x = alg.add(x, alg.smul(alpha, p))
        r = alg.sub(r, alg.smul(alpha, q))
        z = psolve(A, r)
        rho_new = alg.dot(r, z)
        beta = alg.sdiv(rho_new, rho)
        p = alg.add(z, alg.smul(beta, p))
        rnorm = alg.ssqrt(alg.dot(r, r))
        return (x, r, p, rho_new, rnorm, it + 1)

    x, r, p, rho, rnorm, it = jax.lax.while_loop(
        cond, body, (x0, r, p, rho, rnorm0, jnp.int32(0))
    )
    return x, it, rnorm


def _as_f32(alg, s):
    """Comparable f32 view of an algebra scalar (for loop predicates)."""
    from lilac.ops.dfloat import DF

    if isinstance(s, DF):
        return s.hi
    return s.astype(jnp.float32)
