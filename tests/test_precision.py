"""Precision regression tests for the findings that cost us ζ verification.

1. algebra.FloatAlg.dot must be sum(u*v), never jnp.dot: a float32
   dot_general may run in TF32 on the GPU (locked in here as source
   formulation; the numerics show only on the card).
2. Sloppy double-word addition loses relative accuracy under cancellation;
   df.add must be the accurate QD variant.
3. NPB class W must verify end-to-end in f64 and df64 (class S alone is
   too well-conditioned to catch either bug).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lilac.ops import dfloat as df
from lilac.solvers.algebra import FloatAlg


def test_float_dot_is_sum_formulation():
    # guard against regressions back to jnp.dot (TF32 hazard on the GPU)
    import inspect

    code_lines = [
        l.split("#")[0]
        for l in inspect.getsource(FloatAlg.dot).splitlines()
        if not l.strip().startswith("#")
    ]
    src = "\n".join(code_lines)
    assert "jnp.dot" not in src and "jnp.sum" in src


def test_df_add_cancellation():
    # a + b with massive hi cancellation: result must stay ~2^-48 accurate
    a64 = np.float64(1.0) + np.float64(2.0) ** -30
    b64 = -np.float64(1.0) + np.float64(2.0) ** -31
    a = df.from_f64(np.array([a64]))
    b = df.from_f64(np.array([b64]))
    got = df.to_f64(df.add(a, b))[0]
    want = a64 + b64  # = 2^-30 + 2^-31, exactly representable
    assert abs(got - want) / abs(want) < 1e-12


def test_df_cg_style_residual_update():
    # emulate CG's r -= alpha*q cancellation chain in df64 vs f64
    rng = np.random.default_rng(7)
    r = rng.normal(size=256)
    q = rng.normal(size=256)
    alpha = float(np.dot(r, q) / np.dot(q, q))  # makes r shrink
    r_df = df.from_f64(r)
    q_df = df.from_f64(q)
    a_df = df.full(q.shape, alpha)
    got = df.to_f64(df.sub(r_df, df.mul(a_df, q_df)))
    want = r - alpha * q
    denom = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / denom < 1e-11


@pytest.mark.slow
def test_npb_class_w_verifies_f64():
    from lilac.workloads import npb_cg

    res = npb_cg.run("W", dtype="f64")
    assert res.verified, f"rel={res.rel_err:.3e}"


@pytest.mark.slow
def test_npb_class_w_verifies_df64():
    from lilac.workloads import npb_cg

    res = npb_cg.run("W", dtype="df64")
    assert res.verified, f"rel={res.rel_err:.3e}"


def test_f64_plan_refused_without_x64():
    """A plan asked for f64 with jax_enable_x64 off would store float32;
    it must raise instead."""
    import jax

    from lilac.plan import FactoredNPBPlan, SpmvPlan
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(np.random.default_rng(0), 20, 20)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="jax_enable_x64"):
            SpmvPlan(indptr, indices, data, shape, dtype="f64")
        with pytest.raises(ValueError, match="jax_enable_x64"):
            FactoredNPBPlan("S", dtype="f64")
        # f32 and df64 need no x64
        SpmvPlan(indptr, indices, data, shape, dtype="f32")
    finally:
        jax.config.update("jax_enable_x64", True)
