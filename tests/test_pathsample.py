"""PATHSAMPLE pfold workload tests (synthetic landscape; the reference's
LJ38 min.data/ts.data blobs are stripped, .MISSING_LARGE_BLOBS:10-12)."""

import numpy as np
import pytest

from lilac.workloads import pathsample as ps


@pytest.fixture(scope="module")
def db():
    return ps.synthetic_landscape(nmin=300, nts=1200, seed=3)


def test_branching_matrix_is_stochastic(db):
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=0.05, direction="AB"
    )
    n = db.nmin
    rows = np.repeat(np.arange(n), np.diff(indptr))
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, data)
    # rows out of non-sink minima are (sub)stochastic: sum <= 1 + eps,
    # and = 1 where no transitions were dropped (blocked B entries)
    assert (data > 0).all()
    assert rowsum[has_row].max() <= 1.0 + 1e-12
    assert not has_row[np.nonzero(sink)[0]].any()  # sinks have no escape


@pytest.mark.parametrize("direction", ["AB", "BA"])
def test_committor_matches_dense_solution(db, direction):
    # at a mixing temperature the Jacobi sweeps converge; at low T the
    # relaxation time is exp(barrier/T) and NO sweep count converges — the
    # reference's fixed 10000 sweeps doesn't claim convergence either
    ref = ps.dense_committor(db, temperature=1.0, direction=direction)
    r = ps.pfold(db, temperature=1.0, direction=direction, npfold=4000)
    err = np.abs(r.committor - ref).max()
    # 4000 sweeps of a slowly-contracting chain: iteration-limited accuracy
    assert err < 1e-3, err
    assert 0.0 <= r.committor.min() and r.committor.max() <= 1.0 + 1e-12


def test_device_sweeps_match_host_exactly(db):
    """The device Jacobi iteration is the reference semantics: q <- D q
    with empty rows skipped (spmv.f90:14-21), any sweep count."""
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=0.05, direction="AB"
    )
    n = db.nmin
    q = np.zeros(n)
    q[np.nonzero(sink)[0]] = 1.0
    rows = np.repeat(np.arange(n), np.diff(indptr))
    for _ in range(137):
        y = np.zeros(n)
        np.add.at(y, rows, data * q[indices])
        q = np.where(has_row, y, q)
    r = ps.pfold(db, temperature=0.05, direction="AB", npfold=137)
    np.testing.assert_allclose(r.committor, q, rtol=1e-12, atol=1e-13)


def test_committor_boundary_values(db):
    r = ps.pfold(db, temperature=0.05, direction="AB", npfold=2000)
    np.testing.assert_allclose(r.committor[db.a_set], 1.0)
    # B minima keep their initial 0 (their rows exist but entries into B
    # were dropped from others'; their own value converges toward the
    # chain's value which never feeds back)
    assert r.committor[db.b_set].min() >= 0.0


def test_pathdata_parser(tmp_path):
    p = tmp_path / "pathdata"
    p.write_text(
        "NATOMS 38\nSEED 1\n\nCYCLES 0\nNCONNMIN 0\n"
        "PFOLD 10000 1 1.0\nTEMPERATURE 0.01\nDIRECTION BA\n"
    )
    cfg = ps.read_pathdata(str(p))
    assert cfg["npfold"] == 10000
    assert cfg["temperature"] == 0.01
    assert cfg["direction"] == "BA"
    assert cfg["nconnmin"] == 0


def test_min_data_roundtrip(tmp_path):
    mind = tmp_path / "min.data"
    mind.write_text("-173.9 301.2 2 1 0 0\n-172.1 299.0 1 0 1 0\n")
    e, f, h = ps.read_min_data(str(mind))
    assert e.tolist() == [-173.9, -172.1]
    assert h.tolist() == [2, 1]
    seta = tmp_path / "min.A"
    seta.write_text("2\n1 2\n")
    assert ps.read_min_set(str(seta)).tolist() == [0, 1]


def test_ngt_gt_preserves_committor_and_mfpt(db):
    """GT renormalisation is exact: the reduced network's branching sums
    equal dense first-passage probabilities, and renormalised waiting
    times equal dense mean-first-passage times to A∪B."""
    T = 0.8
    r = ps.ngt(db, temperature=T)
    P, tau0, _ = ps._branching_full(db, T, 0)
    n = db.nmin
    D = np.zeros((n, n))
    for i, row in enumerate(P):
        for j, v in row.items():
            D[i, j] = v
    ab = np.zeros(n, dtype=bool)
    ab[db.a_set] = True
    ab[db.b_set] = True
    inter = ~ab
    in_b = np.zeros(n, dtype=bool)
    in_b[db.b_set] = True
    # hit-B-first probability from each intermediate (A∪B absorbing)
    PII = D[np.ix_(inter, inter)]
    h = np.linalg.solve(np.eye(inter.sum()) - PII, D[np.ix_(inter, in_b)].sum(axis=1))
    hfull = np.zeros(n)
    hfull[inter] = h
    hfull[db.b_set] = 1.0
    for i, a in enumerate(db.a_set):
        expect = float(D[a] @ hfull)
        assert abs(r.p_ba[i] - expect) < 1e-10, (i, r.p_ba[i], expect)
    # MFPT to A∪B
    t = np.linalg.solve(np.eye(inter.sum()) - PII, tau0[inter])
    tfull = np.zeros(n)
    tfull[inter] = t
    for a in db.a_set:
        expect = tau0[a] + float(D[a] @ tfull)
        assert abs(r.tau[a] - expect) < 1e-9 * max(1.0, expect)


def test_ngt_detailed_balance(db):
    """Harmonic TST rates satisfy detailed balance exactly for the kSS
    formula (the reference prints this ratio as its soft check,
    NGT.f:936); the kNSS ratio deviates unless the steady-state
    approximation applies."""
    r = ps.ngt(db, temperature=0.8)
    assert abs(r.detailed_balance - 1.0) < 1e-10, r.detailed_balance
    assert r.kAB > 0 and r.kBA > 0 and np.isfinite(r.detailed_balance_nss)


def test_ngt_seeded_pfold_runs(db):
    r = ps.ngt(db, temperature=0.8, npfold=200, direction="BA")
    assert r.committor is not None
    assert 0.0 <= r.committor.min() and r.committor.max() <= 1.0 + 1e-9


def test_tfold_matches_dense_mfpt(db):
    """Jacobi MFPT sweeps converge to the dense first-step solution."""
    T = 1.2  # fast-mixing so the iteration converges in a few thousand sweeps
    r = ps.tfold(db, temperature=T, direction="AB", ntfold=40000)
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=T, direction="AB", block_opposite=False
    )
    n = db.nmin
    D = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    D[rows, indices] = data
    kplus, kminus = ps.log_rates(db, T)
    lksum = np.zeros(n)
    live = db.plus != db.minus
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    tau = np.where(lksum > 0, 1.0 / lksum, 0.0)
    tau[np.asarray(sink)] = 0.0
    free = has_row & ~sink
    t_ref = np.zeros(n)
    sub = np.ix_(free, free)
    rhs = tau[free] + D[free][:, np.asarray(sink)].sum(axis=1) * 0.0
    # dense: (I - D_ff) t_f = tau_f + D_fs·0
    t_ref[free] = np.linalg.solve(np.eye(free.sum()) - D[sub], tau[free])
    err = np.abs(r.mfpt - t_ref) / np.maximum(1.0, np.abs(t_ref))
    assert err.max() < 1e-10, err.max()
    assert r.kAB > 0
