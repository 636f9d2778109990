"""File-ingestion round-trips: the readers must survive at-scale use
(the reference's graph benches consume real on-disk matrices,
/root/reference/bfs/run_all:3), so the parsers are vectorized — these
tests pin exact round-trip semantics on representative matrices."""

import numpy as np
import pytest

from lilac.generate.graphs import powerlaw_graph
from lilac.generate.random_crs import random_crs
from lilac.io import readers


def test_matrix_market_roundtrip_real(tmp_path):
    indptr, indices, data, shape = random_crs(8, seed=3)
    p = str(tmp_path / "m.mtx")
    readers.write_matrix_market(p, indptr, indices, data, shape)
    ip2, ix2, v2, sh2 = readers.read_matrix_market(p)
    assert sh2 == shape
    np.testing.assert_array_equal(ip2, indptr)
    np.testing.assert_array_equal(ix2, indices)
    np.testing.assert_allclose(v2, data, rtol=0, atol=0)  # %.17g is exact


def test_matrix_market_roundtrip_pattern(tmp_path):
    indptr, indices, data, shape = powerlaw_graph(500, avg_deg=6, seed=1)
    p = str(tmp_path / "g.mtx")
    readers.write_matrix_market(p, indptr, indices, data, shape, pattern=True)
    ip2, ix2, v2, sh2 = readers.read_matrix_market(p)
    assert sh2 == shape
    np.testing.assert_array_equal(ip2, indptr)
    np.testing.assert_array_equal(ix2, indices)
    np.testing.assert_array_equal(v2, np.ones(len(indices)))


def test_sparsebench_crs_roundtrip(tmp_path):
    indptr, indices, data, shape = random_crs(7, seed=9)
    p = str(tmp_path / "m.crs")
    readers.write_sparsebench_crs(p, indptr, indices, data, shape)
    ip2, ix2, v2, sh2 = readers.read_sparsebench_crs(p)
    assert sh2 == shape
    np.testing.assert_array_equal(ip2, indptr)
    np.testing.assert_array_equal(ix2, indices)
    # the SparseBench text format is fixed-point (%20.17f,
    # big_gen.py:50-57) — decimal round-trip is ~1 ulp, not exact
    np.testing.assert_allclose(v2, data, rtol=1e-14)


def test_sparsebench_crs_token_count_check(tmp_path):
    p = tmp_path / "bad.crs"
    p.write_text("3 2\n1\n2\n3\n3\n1 0.5\n")  # promises 2 entries, has 1
    with pytest.raises(ValueError):
        readers.read_sparsebench_crs(str(p))


def test_edgelist_vectorized_parse(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("4 4 3\n1 2\n2 3\n4 1\n")
    ip, ix, v, sh = readers.read_edgelist(str(p))
    assert sh == (4, 4)
    assert ip.tolist() == [0, 1, 2, 2, 3]
    assert ix.tolist() == [1, 2, 0]
