"""Graph workloads: BFS on the reference's vendored input + PageRank."""

import os

import numpy as np
import pytest

REF_BFS = "/root/reference/bfs/input.mtx"


@pytest.mark.skipif(not os.path.exists(REF_BFS), reason="reference not mounted")
def test_bfs_reference_input_matches_oracle():
    from lilac.io.readers import read_edgelist
    from lilac.plan import SpmvPlan
    from lilac.workloads import bfs

    indptr, indices, data, shape = read_edgelist(REF_BFS)
    assert shape == (14, 14)
    plan = SpmvPlan(indptr, indices, np.ones_like(data), shape, dtype="f32")
    for src in range(14):
        got = bfs.bfs_distances(plan, src)
        ref = bfs.bfs_oracle(indptr, indices, data, shape, src)
        np.testing.assert_array_equal(got, ref)


def test_bfs_random_graph(rng):
    from lilac.plan import SpmvPlan
    from lilac.workloads import bfs
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 80, 80, 0.04)
    plan = SpmvPlan(indptr, indices, np.ones_like(data), shape, dtype="f32")
    for src in (0, 17, 42):
        got = bfs.bfs_distances(plan, src)
        ref = bfs.bfs_oracle(indptr, indices, data, shape, src)
        np.testing.assert_array_equal(got, ref)


def test_pagerank_converges_to_stationary(rng):
    from lilac.workloads import pagerank
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 60, 60, 0.15)
    data = np.abs(data) + 0.1
    r = pagerank.run(indptr, indices, data, shape, iters=300, runs=1, dtype="f64")
    # reference semantics: x_new = d·M_norm·x + (1-d)·mean(x); at the fixed
    # point the step difference vanishes
    assert r.error < 1e-10, r.error
    assert np.all(np.isfinite(r.x))


def test_powerlaw_graph_properties(rng):
    from lilac.generate.graphs import powerlaw_graph

    indptr, indices, data, shape = powerlaw_graph(2000, avg_deg=8.0, seed=3)
    n = shape[0]
    counts = np.diff(indptr)
    assert counts.sum() == len(indices) and (indices < n).all()
    # heavy tail: max out-degree far above the mean
    assert counts.max() > 8 * max(counts.mean(), 1.0)
    # no self loops
    rows = np.repeat(np.arange(n), counts)
    assert (rows != indices).all()


@pytest.mark.parametrize("kernel", ["xla_ell", "xla_csr", "xla_sell"])
def test_pagerank_matches_host_oracle(kernel):
    """PageRank through each gather kernel == the host f64 replica of the
    same iteration (f32 device: normwise 1e-5)."""
    from lilac.generate.graphs import powerlaw_graph
    from lilac.workloads import pagerank

    g = powerlaw_graph(1500, avg_deg=6.0, seed=1)
    r = pagerank.run(*g, iters=30, runs=1, dtype="f32", kernel=kernel)
    ref = pagerank.pagerank_oracle(*g, pagerank.initial_vector(1500, 0), iters=30)
    err = np.abs(r.x - ref).max() / np.abs(ref).max()
    assert err < 1e-5, (kernel, err)


@pytest.mark.parametrize("kernel", ["xla_ell", "xla_csr", "xla_sell"])
def test_bfs_matches_host_oracle(kernel):
    """BFS levels through each gather kernel == the scipy oracle exactly."""
    from lilac.generate.graphs import powerlaw_graph
    from lilac.plan import SpmvPlan
    from lilac.workloads.bfs import bfs_distances, bfs_oracle

    g = powerlaw_graph(1200, avg_deg=5.0, seed=2, symmetric=True)
    plan = SpmvPlan(g[0], g[1], np.ones_like(g[2]), g[3], dtype="f32",
                    kernel=kernel)
    for src in (7, 400, 1111):
        np.testing.assert_array_equal(bfs_distances(plan, src),
                                      bfs_oracle(*g, src))
