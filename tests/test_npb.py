"""NPB CG end-to-end: generator properties + the prime ζ verification
(SURVEY.md section 4: the ζ check doubles as the integration test of every
SpMV backend — a wrong kernel wrecks ζ)."""

import numpy as np
import pytest
import scipy.sparse as sp

from lilac.generate.npb import CLASSES, Randlc, _generate_triples_py, make_cg_matrix
from lilac.workloads import npb_cg


def test_randlc_matches_reference_semantics():
    r = Randlc()
    seq = [r.next() for _ in range(5)]
    # recompute by definition: x_{k+1} = 5^13 x_k mod 2^46
    x = 314159265
    ref = []
    for _ in range(5):
        x = (x * 1220703125) % (1 << 46)
        ref.append(x * 0.5**46)
    np.testing.assert_allclose(seq, ref, rtol=0, atol=0)


def test_randlc_stream_matches_scalar():
    r1, r2 = Randlc(), Randlc()
    bulk = r1.stream_ints(1000)
    scal = np.array([r2.next_int() for _ in range(1000)], dtype=np.uint64)
    np.testing.assert_array_equal(bulk, scal)


def test_triples_structure():
    nzv, ivc, vc = _generate_triples_py(200, 5)
    assert nzv.min() >= 5 and nzv.max() <= 6
    off = 0
    for i, k in enumerate(nzv[:50]):
        seg = ivc[off : off + k]
        assert len(set(seg.tolist())) == k  # distinct positions
        assert 1 <= seg.min() and seg.max() <= 200
        # vecset forced the diagonal with value 0.5
        j = np.nonzero(seg == i + 1)[0]
        assert len(j) == 1 and vc[off + j[0]] == 0.5
        off += k


def test_class_s_matrix_properties():
    indptr, indices, data, cls = make_cg_matrix("S")
    n = cls.na
    A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    # symmetric by construction (sum of symmetric outer products + diag)
    diff = (A - A.T).tocoo()
    assert np.abs(diff.data).max() < 1e-12 if diff.nnz else True
    # diagonal fully present and dominated by rcond - shift ~ -9.9
    d = A.diagonal()
    assert np.all(d != 0.0)
    assert abs(d.mean() - (cls.rcond - cls.shift)) < 2.0


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_npb_cg_class_s_verifies(dtype):
    res = npb_cg.run("S", dtype=dtype)
    assert res.verified, f"zeta={res.zeta!r} expected {res.zeta_verify!r} rel={res.rel_err:.3e}"


def test_npb_cg_class_s_f32_close():
    # f32 cannot verify to 1e-10 but must be in the right neighbourhood
    res = npb_cg.run("S", dtype="f32")
    assert abs(res.zeta - res.zeta_verify) / res.zeta_verify < 1e-3


def test_factored_matches_assembled():
    """Factored A·x (kernels/factored.py) equals the assembled-CSR product."""
    import jax.numpy as jnp
    import numpy as np

    from lilac.generate.npb import CLASSES, make_cg_matrix
    from lilac.plan import FactoredNPBPlan, SpmvPlan

    cls = CLASSES["S"]
    indptr, indices, data, _ = make_cg_matrix("S")
    direct = SpmvPlan(indptr, indices, data, (cls.na, cls.na), dtype="f64")
    fact = FactoredNPBPlan("S", dtype="f64")

    x = np.random.default_rng(7).normal(size=cls.na)
    y1 = np.asarray(direct.matvec(direct.vec_in(x)), dtype=np.float64)
    y2 = np.asarray(fact.matvec(fact.vec_in(x)), dtype=np.float64)
    scale = np.abs(y1).max()
    assert np.abs(y1 - y2).max() < 1e-12 * scale


# NPB class S through each operator that can carry the solve, in both
# verified value policies. kernel -> (SpmvPlan kernel or factored layout).
NPB_OPERATORS = {
    "factored single": ("factored", "single"),
    "factored scan": ("factored", "scan"),
    "xla_ell": ("xla_ell", None),
    "xla_sell": ("xla_sell", None),
    "xla_csr": ("xla_csr", None),
}
_DF_KERNEL = {"xla_ell": "xla_ell_df", "xla_sell": "xla_sell_df"}


@pytest.mark.parametrize(
    "op,dtype",
    [(op, "f64") for op in NPB_OPERATORS]
    + [(op, "df64") for op in NPB_OPERATORS if op != "xla_csr"],
)
def test_npb_class_s_verifies_per_operator(op, dtype, monkeypatch):
    """ζ to NPB's 1e-10 through every operator (xla_csr has no df64 form)."""
    kernel, segmode = NPB_OPERATORS[op]
    if segmode is not None:
        monkeypatch.setenv("LILAC_FACTORED_SEGMODE", segmode)
    elif dtype == "df64":
        kernel = _DF_KERNEL[kernel]
    res = npb_cg.run("S", dtype=dtype, kernel=kernel)
    assert res.verified, f"{op} {dtype}: rel err {res.rel_err:.3e}"


def test_factored_class_s_df64():
    """Full factored class-S run in df64 verifies to NPB's 1e-10 (the
    EFT barriers keep fused codegen from contracting the error-free
    transforms, ops/dfloat.py)."""
    from lilac.workloads import npb_cg

    r = npb_cg.run("S", dtype="df64", kernel="factored")
    assert r.verified, r.rel_err
