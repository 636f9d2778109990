"""Vector-algebra adapters so solvers are generic over the value dtype.

One CG/BiCG/GMRES implementation serves plain float (f32/f64/bf16) and
double-word f32 (df64) values: solvers call through this small protocol and
never touch dtype-specific arithmetic. Vectors and scalars are pytrees, so
the same solver code jits, scans, and shard_maps unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

from lilac.ops import dfloat as df


class FloatAlg:
    """Plain jnp arithmetic in a fixed dtype."""

    def __init__(self, dtype=jnp.float32):
        self.dtype = dtype

    def dot(self, u, v):
        # multiply + reduce-sum, not jnp.dot: XLA fuses it into one
        # reduction, and a float32 dot_general may run in TF32 on the GPU
        return jnp.sum(u * v)

    def add(self, u, v):
        return u + v

    def sub(self, u, v):
        return u - v

    def smul(self, s, u):  # scalar * vector (or scalar * scalar)
        return s * u

    def sdiv(self, a, b):  # scalar / scalar
        return a / b

    def ssqrt(self, a):
        return jnp.sqrt(a)

    def scalar(self, v):
        return jnp.asarray(v, self.dtype)

    def zeros_like(self, u):
        return jnp.zeros_like(u)

    def to_f64(self, s):
        import numpy as np

        return np.float64(s)


class DF64Alg:
    """Double-word f32 arithmetic (see lilac.ops.dfloat)."""

    dtype = "df64"

    def dot(self, u, v):
        return df.dot(u, v)

    def add(self, u, v):
        return df.add(u, v)

    def sub(self, u, v):
        return df.sub(u, v)

    def smul(self, s, u):
        # scalar DF times vector DF: broadcast through mul
        return df.mul(df.DF(jnp.broadcast_to(s.hi, u.hi.shape),
                            jnp.broadcast_to(s.lo, u.lo.shape)), u)

    def sdiv(self, a, b):
        return df.div(a, b)

    def ssqrt(self, a):
        return df.sqrt(a)

    def scalar(self, v):
        return df.full((), float(v))

    def zeros_like(self, u):
        return df.DF(jnp.zeros_like(u.hi), jnp.zeros_like(u.lo))

    def to_f64(self, s):
        return float(df.to_f64(s))


def get_algebra(dtype: str):
    if dtype == "df64":
        return DF64Alg()
    m = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}
    return FloatAlg(m[dtype])
