"""Parboil spmv (golden datasets) and sgemm (synthetic oracle) tests."""

import os

import numpy as np
import pytest

REF = "/root/reference/parboil"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_parboil_spmv_small_golden():
    from lilac.workloads import parboil_spmv as pv

    r = pv.run_dataset("small", REF, reps=5)
    assert r.matched is True
    assert r.rows == 1138 and r.nnz == 4054


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_parboil_spmv_medium_golden():
    from lilac.workloads import parboil_spmv as pv

    r = pv.run_dataset("medium", REF, reps=5)
    assert r.matched is True


def test_parboil_output_roundtrip(tmp_path):
    from lilac.workloads import parboil_spmv as pv

    y = np.random.default_rng(0).normal(size=33).astype(np.float32)
    p = tmp_path / "o.out"
    pv.write_output(str(p), y)
    back = pv.read_golden(str(p))
    np.testing.assert_array_equal(y, back)


def test_sgemm_matches_oracle():
    from lilac.workloads import sgemm

    rng = np.random.default_rng(5)
    A = rng.normal(size=(150, 70)).astype(np.float32)
    BT = rng.normal(size=(90, 70)).astype(np.float32)
    ref = A.astype(np.float64) @ BT.astype(np.float64).T
    for precision in ("highest", "default"):
        C, res = sgemm.run_arrays(A, BT, precision=precision)
        assert np.abs(C - ref).max() < 1e-3 * np.abs(ref).max(), precision
        assert res.precision == precision and res.gflops > 0


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (7, 13, 5), (257, 129, 300),
                                   (33, 511, 1000)])
def test_sgemm_highest_odd_shapes(m, n, k):
    """precision='highest' keeps full f32 products: within a few f32 ulps
    of the f64 oracle (normwise 1e-5), the bound parboil's float compare
    never needs to loosen."""
    from lilac.workloads import sgemm

    rng = np.random.default_rng(m * 1000 + n + k)
    A = rng.normal(size=(m, k)).astype(np.float32)
    BT = rng.normal(size=(n, k)).astype(np.float32)
    ref = A.astype(np.float64) @ BT.astype(np.float64).T
    C, _ = sgemm.run_arrays(A, BT, precision="highest", reps=1)
    assert C.shape == (m, n) and C.dtype == np.float32
    assert np.abs(C - ref).max() <= 1e-5 * np.abs(ref).max()


def test_sgemm_col_major_roundtrip(tmp_path):
    from lilac.workloads import sgemm

    M = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = tmp_path / "m.txt"
    sgemm.write_col_major(str(p), M)
    back = sgemm.read_col_major(str(p))
    np.testing.assert_array_equal(M, back)
