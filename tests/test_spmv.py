"""SpMV kernels vs dense/scipy oracle (the parboil-style tolerance compare,
/root/reference/parboil/benchmarks/spmv/tools/compare-output:17-25, but
tighter since we control the arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from lilac.formats import convert
from lilac.kernels import xla as kx
from lilac.ops import dfloat as df
from lilac.ops.spmv import spmv, spmv_t, spmm
from lilac.plan import SpmvPlan


def _oracle(small_csr, rng):
    (indptr, indices, data), shape = small_csr
    x = rng.normal(size=shape[1])
    xt = rng.normal(size=shape[0])
    A = sp.csr_matrix((data, indices, indptr), shape=shape)
    return (indptr, indices, data), shape, x, xt, A @ x, A.T @ xt


def test_csr_spmv(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    A = convert.csr_device(*arrs, shape)
    y = kx.csr_spmv(A, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12)
    yt = kx.csr_spmv_t(A, jnp.asarray(xt))
    np.testing.assert_allclose(np.asarray(yt), yt_ref, rtol=1e-12)


def test_ell_spmv(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    A = convert.ell_device(*arrs, shape)
    y = kx.ell_spmv(A, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12)
    yt = kx.ell_spmv_t(A, jnp.asarray(xt))
    np.testing.assert_allclose(np.asarray(yt), yt_ref, rtol=1e-12)


def test_coo_spmv(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    indptr, indices, data = arrs
    counts = np.diff(indptr)
    row = np.repeat(np.arange(shape[0]), counts)
    A = convert.coo_device(row, indices, data, shape)
    np.testing.assert_allclose(np.asarray(kx.coo_spmv(A, jnp.asarray(x))), y_ref, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(kx.coo_spmv_t(A, jnp.asarray(xt))), yt_ref, rtol=1e-12
    )


def test_bsr_spmv(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    A = convert.bsr_device(*arrs, shape, block_shape=(8, 16))
    y = kx.bsr_spmv(A, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-10)


def test_ell_spmv_df64(small_csr, rng):
    """df64 SpMV must reach ~1e-13 relative accuracy vs the f64 oracle."""
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    indptr, indices, data = arrs
    hi = data.astype(np.float32)
    lo = (data - hi.astype(np.float64)).astype(np.float32)
    vals = np.stack([hi, lo], axis=-1)
    v, c = convert.csr_to_ell_arrays(indptr, indices, vals, shape, row_pad=8)
    from lilac.formats.sparse import ELL

    A = ELL(data=jnp.asarray(v), indices=jnp.asarray(c), shape=shape)
    y = kx.ell_spmv_df(A, df.from_f64(x))
    np.testing.assert_allclose(df.to_f64(y), y_ref, rtol=5e-13, atol=1e-13)


def test_spmv_dispatch_and_spmm(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    A = convert.csr_device(*arrs, shape)
    np.testing.assert_allclose(np.asarray(spmv(A, jnp.asarray(x))), y_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(spmv_t(A, jnp.asarray(xt))), yt_ref, rtol=1e-12)
    X = rng.normal(size=(shape[1], 3))
    Y = spmm(A, jnp.asarray(X))
    ref = sp.csr_matrix((arrs[2], arrs[1], arrs[0]), shape=shape) @ X
    np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-12)


def test_spmv_under_jit(small_csr, rng):
    arrs, shape, x, _, y_ref, _ = _oracle(small_csr, rng)
    A = convert.csr_device(*arrs, shape)
    y = jax.jit(spmv)(A, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12)


def test_dfloat_primitives():
    a = df.from_f64(np.array([1.0 / 3.0, 1e8, -2.5e-7]))
    b = df.from_f64(np.array([2.0 / 7.0, 3.7e-8, 1e9]))
    np.testing.assert_allclose(
        df.to_f64(df.add(a, b)),
        np.array([1 / 3 + 2 / 7, 1e8 + 3.7e-8, -2.5e-7 + 1e9]),
        rtol=1e-14,
    )
    np.testing.assert_allclose(
        df.to_f64(df.mul(a, b)),
        np.array([(1 / 3) * (2 / 7), 1e8 * 3.7e-8, -2.5e-7 * 1e9]),
        rtol=1e-13,
    )
    np.testing.assert_allclose(
        df.to_f64(df.div(a, b)),
        np.array([(1 / 3) / (2 / 7), 1e8 / 3.7e-8, -2.5e-7 / 1e9]),
        rtol=1e-13,
    )
    s = df.from_f64(np.array(2.0))
    np.testing.assert_allclose(df.to_f64(df.sqrt(s)), np.sqrt(2.0), rtol=1e-14)


def test_dfloat_dot_accuracy(rng):
    x = rng.normal(size=4096)
    y = rng.normal(size=4096)
    got = df.to_f64(df.dot(df.from_f64(x), df.from_f64(y)))
    np.testing.assert_allclose(got, np.dot(x, y), rtol=1e-12, atol=1e-12)


def test_bucket_ell_matches_dense(rng):
    """Degree-bucketed sliced ELL == dense product on a skewed matrix."""
    import numpy as np
    import jax.numpy as jnp

    from lilac.plan import SpmvPlan
    from tests.conftest import random_csr

    # power-law-ish row lengths: concatenate a dense block over random rows
    (indptr, indices, data), shape = random_csr(rng, 120, 120, 0.05)
    plan = SpmvPlan(indptr, indices, data, shape, dtype="f64", kernel="xla_sell")
    x = rng.normal(size=shape[1])
    y = plan.vec_out(plan.matvec(plan.vec_in(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_bucket_ell_df_matches_dense(rng):
    import numpy as np

    from lilac.plan import SpmvPlan
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 90, 90, 0.07)
    plan = SpmvPlan(indptr, indices, data, shape, dtype="df64", kernel="xla_sell_df")
    x = rng.normal(size=shape[1])
    y = plan.vec_out(plan.matvec(plan.vec_in(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-13, atol=1e-13)


def test_spgemm_gustavson_matches_dense(rng):
    import numpy as np

    from lilac.ops import spgemm
    from tests.conftest import random_csr

    (ap, ai, av), sa = random_csr(rng, 40, 30, 0.15)
    (bp, bi, bv), sb = random_csr(rng, 30, 50, 0.15)
    cp, ci, cv, sc = spgemm.gustavson((ap, ai, av), (bp, bi, bv), sa, sb)
    A = np.zeros(sa)
    A[np.repeat(np.arange(sa[0]), np.diff(ap)), ai] = av
    B = np.zeros(sb)
    B[np.repeat(np.arange(sb[0]), np.diff(bp)), bi] = bv
    C = np.zeros(sc)
    C[np.repeat(np.arange(sc[0]), np.diff(cp)), ci] = cv
    np.testing.assert_allclose(C, A @ B, rtol=1e-12, atol=1e-12)

    cp2, ci2, cv2, _ = spgemm.masked_dense((ap, ai, av), (bp, bi, bv), sa, sb)
    C2 = np.zeros(sc)
    C2[np.repeat(np.arange(sc[0]), np.diff(cp2)), ci2] = cv2
    np.testing.assert_allclose(C2, A @ B, rtol=1e-5, atol=1e-5)


def test_spgemm_expand_and_esc_match_oracle(rng):
    import numpy as np

    from lilac.ops import spgemm
    from tests.conftest import random_csr

    (ap, ai, av), sa = random_csr(rng, 120, 70, 0.08)
    (bp, bi, bv), sb = random_csr(rng, 70, 90, 0.08)
    ref = spgemm.gustavson((ap, ai, av), (bp, bi, bv), sa, sb)

    # vectorized host expansion: exactly the oracle's CSR (same dup-sum)
    got = spgemm.expand_csr((ap, ai, av), (bp, bi, bv), sa, sb)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-13)

    # device ESC: f32 values, structure must match exactly, values to f32
    # accuracy; row_chunk smaller than n exercises the chunk loop
    esc = spgemm.esc_spgemm((ap, ai, av), (bp, bi, bv), sa, sb, row_chunk=32)
    np.testing.assert_array_equal(esc[0], ref[0])
    np.testing.assert_array_equal(esc[1], ref[1])
    np.testing.assert_allclose(esc[2], ref[2], rtol=2e-5, atol=2e-6)


def test_seg_bucket_ell_matches_dense(rng):
    import numpy as np

    from lilac.formats.convert import csr_to_seg_bucket_ell
    from lilac.kernels.xla import seg_bucket_ell_spmv
    from tests.conftest import random_csr
    import jax.numpy as jnp

    (indptr, indices, data), shape = random_csr(rng, 200, 200, 0.05)
    A = csr_to_seg_bucket_ell(indptr, indices, data, shape, seg_size=64)
    x = rng.normal(size=shape[1])
    y = np.asarray(seg_bucket_ell_spmv(A, jnp.asarray(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_seg_bucket_ell_df_matches_dense(rng):
    import numpy as np
    import jax.numpy as jnp

    from lilac.formats.convert import csr_to_seg_bucket_ell
    from lilac.kernels.xla import seg_bucket_ell_spmv_df
    from lilac.ops import dfloat as df
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 150, 150, 0.06)
    hi = data.astype(np.float32)
    lo = (data - hi.astype(np.float64)).astype(np.float32)
    vals = np.stack([hi, lo], axis=-1)
    A = csr_to_seg_bucket_ell(indptr, indices, vals, shape, seg_size=50)
    x = rng.normal(size=shape[1])
    y = df.to_f64(seg_bucket_ell_spmv_df(A, df.from_f64(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-13, atol=1e-13)


def test_seg_ell_scan_matches_dense(rng):
    from lilac.formats.convert import csr_to_seg_ell_scan
    from lilac.kernels.xla import seg_ell_scan_spmv
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 200, 200, 0.05)
    # small segment + low quantile forces multi-segment AND a tail
    A = csr_to_seg_ell_scan(indptr, indices, data, shape, seg_size=64, seg_quantile=70.0)
    assert A.nseg == 4
    assert A.tail_data is not None
    x = rng.normal(size=shape[1])
    y = np.asarray(seg_ell_scan_spmv(A, jnp.asarray(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_seg_ell_scan_no_tail(rng):
    from lilac.formats.convert import csr_to_seg_ell_scan
    from lilac.kernels.xla import seg_ell_scan_spmv
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 100, 100, 0.05)
    A = csr_to_seg_ell_scan(indptr, indices, data, shape, seg_size=40, seg_quantile=100.0)
    assert A.tail_data is None
    x = rng.normal(size=shape[1])
    y = np.asarray(seg_ell_scan_spmv(A, jnp.asarray(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_seg_ell_scan_df_matches_dense(rng):
    from lilac.formats.convert import csr_to_seg_ell_scan
    from lilac.kernels.xla import seg_ell_scan_spmv_df
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 150, 150, 0.06)
    hi = data.astype(np.float32)
    lo = (data - hi.astype(np.float64)).astype(np.float32)
    vals = np.stack([hi, lo], axis=-1)
    A = csr_to_seg_ell_scan(indptr, indices, vals, shape, seg_size=50, seg_quantile=80.0)
    x = rng.normal(size=shape[1])
    y = df.to_f64(seg_ell_scan_spmv_df(A, df.from_f64(x)))
    dense = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-13, atol=1e-13)


def test_factored_scan_mode_matches_single_seg(monkeypatch):
    """Factored NPB operator: scan-segmented build == single-segment build."""
    from lilac.kernels import factored as kf

    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")
    A1, _ = kf.build_factored("S", dtype="f64")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "scan")
    monkeypatch.setattr(kf, "SEG_SIZE", 500)  # force multi-segment on class S
    A2, _ = kf.build_factored("S", dtype="f64")
    from lilac.formats.sparse import SegELLScan

    assert isinstance(A2.V, SegELLScan) and A2.V.nseg > 1
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=A1.s.shape[0]))
    y1 = np.asarray(kf.factored_spmv(A1, x))
    y2 = np.asarray(kf.factored_spmv(A2, x))
    np.testing.assert_allclose(y1, y2, rtol=1e-12, atol=1e-12)


def test_bucket_ell_transpose(small_csr, rng):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    A = convert.bucket_ell_device(*arrs, shape)
    yt = kx.bucket_ell_spmv_t(A, jnp.asarray(xt))
    np.testing.assert_allclose(np.asarray(yt), yt_ref, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["xla_ell", "xla_csr", "xla_sell"])
def test_plan_matvec_t_via_registry(small_csr, rng, kernel):
    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    plan = SpmvPlan(*arrs, shape, dtype="f64", kernel=kernel)
    yt = plan.matvec_t(jnp.asarray(xt))
    np.testing.assert_allclose(np.asarray(yt), yt_ref, rtol=1e-12)


def test_transposed_plan_matches_oracle(small_csr, rng):
    from lilac.plan import transposed_plan

    arrs, shape, x, xt, y_ref, yt_ref = _oracle(small_csr, rng)
    # df64 has no registered transpose: the first-class route is a
    # transposed forward plan
    plan = SpmvPlan(*arrs, shape, dtype="df64", kernel="xla_ell_df")
    with pytest.raises(ValueError, match="transposed_plan"):
        plan.matvec_t(plan.vec_in(xt))
    pt = transposed_plan(*arrs, shape, dtype="df64", kernel="xla_ell_df")
    yt = pt.vec_out(pt.matvec(pt.vec_in(xt)))
    np.testing.assert_allclose(yt, yt_ref, rtol=1e-13)


# -- plan oracle: every SpmvPlan kernel x every value policy it supports x
# four matrix families, against scipy in f64. Tolerances are normwise
# (max |y - y_ref| / max |y_ref|) and follow the storage precision: f64
# and df64 agree with f64 to summation-order rounding; f32 keeps ~7
# digits; bf16 stores 8 significand bits (a few ulps on the gathered sum).
PLAN_POLICIES = [
    ("xla_ell", "f32"), ("xla_ell", "f64"), ("xla_ell", "bf16"),
    ("xla_csr", "f32"), ("xla_csr", "f64"), ("xla_csr", "bf16"),
    ("xla_sell", "f32"), ("xla_sell", "f64"), ("xla_sell", "bf16"),
    ("xla_ell_df", "df64"), ("xla_sell_df", "df64"),
]
PLAN_TOL = {"f64": 1e-13, "df64": 1e-13, "f32": 1e-5, "bf16": 3e-2}


def _plan_matrix(family):
    from lilac.formats.convert import coo_to_csr_arrays
    from lilac.generate.graphs import powerlaw_graph
    from lilac.generate.random_crs import random_crs
    from lilac.generate.stencil import seven_point_csr

    if family == "stencil":
        return seven_point_csr(7, 6, 5)
    if family == "banded":
        n, bw = 300, 9
        offs = np.arange(-(bw // 2), bw // 2 + 1)
        rows = np.repeat(np.arange(n), bw)
        cols = (rows.reshape(n, bw) + offs).clip(0, n - 1).ravel()
        vals = np.random.default_rng(3).normal(size=n * bw)
        return coo_to_csr_arrays(rows, cols, vals, (n, n)) + ((n, n),)
    if family == "big_gen":
        return random_crs(7, seed=2)
    ip, ix, dv, shape = powerlaw_graph(600, avg_deg=6.0, seed=5)
    return ip, ix, np.random.default_rng(4).uniform(0.5, 1.5, len(dv)), shape


@pytest.mark.parametrize("family", ["stencil", "banded", "big_gen", "powerlaw"])
@pytest.mark.parametrize("kernel,dtype", PLAN_POLICIES)
def test_plan_matches_scipy_oracle(kernel, dtype, family):
    indptr, indices, data, shape = _plan_matrix(family)
    x = np.random.default_rng(0).normal(size=shape[1])
    y_ref = sp.csr_matrix((data, indices, indptr), shape=shape) @ x
    plan = SpmvPlan(indptr, indices, data, shape, dtype=dtype, kernel=kernel)
    assert plan.kernel == kernel
    y = plan.vec_out(jax.jit(plan.matvec_with)(plan.A, plan.vec_in(x)))
    err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert err <= PLAN_TOL[dtype], (kernel, dtype, family, err)
