"""Double-word float32 ("df64") arithmetic for f64-grade precision.

The NPB CG verification needs ~1e-10 relative accuracy
(/root/reference/NPB3.3.1/CG/cg.f:363-368), beyond f32. This module
implements error-free-transformation (Dekker/Knuth) double-word arithmetic:
a value is (hi, lo) with value = hi + lo and |lo| <= ulp(hi)/2, giving
~2^-48 relative precision — comfortably inside the 1e-10 tolerance while
computing entirely in vectorized f32. It is the alternative to native f64
for every value policy that offers both (dtype='df64' vs 'f64').

All functions are shape-polymorphic and jit-compatible. A DF is a plain
(hi, lo) tuple of equal-shaped f32 arrays (a pytree).

References: Dekker 1971; Hida/Li/Bailey QD.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DF(NamedTuple):
    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


_SPLIT = 4097.0  # 2^12 + 1 for f32 (24-bit mantissa -> 12+12 split)

# Error-free transformations are numerically load-bearing: every
# intermediate must be the exactly-rounded f32 result. Two compiler layers
# can silently break that:
#
#  1. XLA's HLO algebraic simplifier cancels patterns like `s - a` after
#     `s = a + b` (measured: jitted df64 CG stalled at residual 6e-6 while
#     op-by-op execution of the SAME code reached 2.6e-12). An
#     optimization_barrier on each EFT intermediate blocks this.
#  2. Backends generate fused code through LLVM (XLA:CPU; NVPTX on the
#     GPU), where optimization_barriers are gone and a product such as
#     two_prod's `p = a*b` can be contracted into an FMA with the add that
#     consumes it. XLA also duplicates a producer into several consumer
#     fusions, so p can be exact inside one fusion's fma and rounded in
#     another — hi and lo of one value then come from different
#     arithmetic, which voids the Dekker/Knuth identities at ulp level
#     (measured on XLA:CPU: a jitted factored df64 matvec lost 8.8e-9
#     relative and NPB class S missed 1e-10; disabling the `fusion` HLO
#     pass restored 6e-15). lax.reduce_precision(x, 8, 23) did not stop
#     it. A select is opaque to contraction: `where(x != x, nan, x)`
#     returns x unchanged (NaN stays NaN), but an FMA cannot reach
#     through it, so every EFT intermediate is the rounded f32 value in
#     every fusion. It is applied on every backend.
def _eft_barrier(x):
    x = jax.lax.optimization_barrier(x)
    return jnp.where(x != x, jnp.float32(jnp.nan), x)


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly.

    Every intermediate difference is barriered, not just the sum: the
    simplifier pattern-matches pure algebra — sub(s, sub(s, a)) -> a fires
    even when s is opaque, because the rewrite needs only structural
    equality of the two s uses. Round 2 found exactly that: a 15-iteration
    jitted df64 CG stalled at true residual 8.6e-8 while the op-by-op
    execution of the same code reached 4e-14, with the divergence
    appearing only once >= 2 iterations compiled together (larger graphs
    reach the rewrite's fuel/threshold). Barriers on each EFT difference
    make every cancellation-bearing value opaque.
    """
    s = _eft_barrier(a + b)
    bb = _eft_barrier(s - a)
    e = (a - _eft_barrier(s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b|."""
    s = _eft_barrier(a + b)
    e = b - _eft_barrier(s - a)
    return s, e


def _split(a):
    t = _eft_barrier(_SPLIT * a)
    ahi = t - _eft_barrier(t - a)
    alo = a - _eft_barrier(ahi)
    return ahi, alo


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (no FMA dependence)."""
    p = _eft_barrier(a * b)
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = (_eft_barrier(ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


# ---------------------------------------------------------------------------
# construction / conversion
# ---------------------------------------------------------------------------


def from_f64(x) -> DF:
    """Split host float64 data into an exact (hi, lo) f32 pair (on host)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def from_f32(x) -> DF:
    x = jnp.asarray(x, jnp.float32)
    return DF(x, jnp.zeros_like(x))


def to_f64(d: DF) -> np.ndarray:
    return np.asarray(d.hi, dtype=np.float64) + np.asarray(d.lo, dtype=np.float64)


def zeros(shape, dtype=jnp.float32) -> DF:
    z = jnp.zeros(shape, dtype)
    return DF(z, z)


def full(shape, value: float, dtype=jnp.float32) -> DF:
    v = np.float64(value)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return DF(jnp.full(shape, hi, dtype), jnp.full(shape, lo, dtype))


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def add(a: DF, b: DF) -> DF:
    """Accurate (QD 'ieee') double-word addition.

    The cheaper 'sloppy' variant (e = e + a.lo + b.lo in one step) loses
    relative accuracy under heavy cancellation — exactly what CG residual
    updates do — and cost NPB classes W/A their 1e-10 ζ tolerance
    (measured ~4.5e-8 with the sloppy add). This version keeps ~2^-48
    relative error even when hi components cancel.
    """
    s1, s2 = _two_sum(a.hi, b.hi)
    t1, t2 = _two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(s1, s2)
    return DF(hi, lo)


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    p, e = _two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def mul_f32(a: DF, b) -> DF:
    p, e = _two_prod(a.hi, b)
    e = e + a.lo * b
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def div(a: DF, b: DF) -> DF:
    q1 = a.hi / b.hi
    r = sub(a, mul_f32(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f32(b, q2))
    q3 = r.hi / b.hi
    hi, lo = _quick_two_sum(q1, q2)
    return add(DF(hi, lo), from_f32(q3))


def sqrt(a: DF) -> DF:
    s = jnp.sqrt(a.hi)
    # one Newton step in df: s' = s + (a - s^2) / (2 s)
    s_df = from_f32(s)
    diff = sub(a, mul(s_df, s_df))
    corr = diff.hi / (2.0 * s)
    return add(s_df, from_f32(corr))


def rsqrt(a: DF) -> DF:
    one = full((), 1.0)
    return div(one, sqrt(a))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sum_df(a: DF, axis: int = -1) -> DF:
    """Accurate reduction along an axis by pairwise df-addition halving.

    O(log n) vectorized df-add steps; each step is exact-compensated, so the
    final error is O(log n * 2^-48) relative — effectively f64 quality.
    """
    hi = jnp.moveaxis(a.hi, axis, -1)
    lo = jnp.moveaxis(a.lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        pad = half * 2 - n
        if pad:
            hi = jnp.pad(hi, [(0, 0)] * (hi.ndim - 1) + [(0, pad)])
            lo = jnp.pad(lo, [(0, 0)] * (lo.ndim - 1) + [(0, pad)])
        x = DF(hi[..., :half], lo[..., :half])
        y = DF(hi[..., half:], lo[..., half:])
        r = add(x, y)
        hi, lo = r.hi, r.lo
        n = half
    return DF(hi[..., 0], lo[..., 0])


def dot(a: DF, b: DF) -> DF:
    """Accurate dot product of two df vectors (TwoProd + pairwise df-sum)."""
    prods = mul(a, b)
    return sum_df(prods, axis=-1)
