"""Format construction / conversion round-trips against scipy oracles."""

import numpy as np
import pytest
import scipy.sparse as sp

from lilac.formats import convert
from lilac.formats.sparse import CSR, ELL


def test_coo_to_csr_dedup(rng):
    n, m = 20, 17
    row = rng.integers(0, n, size=200)
    col = rng.integers(0, m, size=200)
    val = rng.normal(size=200)
    indptr, indices, data = convert.coo_to_csr_arrays(row, col, val, (n, m))
    ref = sp.coo_matrix((val, (row, col)), shape=(n, m)).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(indices, ref.indices)
    np.testing.assert_allclose(data, ref.data, rtol=1e-14)


def test_csr_device_todense(small_csr):
    (indptr, indices, data), shape = small_csr
    A = convert.csr_device(indptr, indices, data, shape)
    ref = sp.csr_matrix((data, indices, indptr), shape=shape).toarray()
    np.testing.assert_allclose(np.asarray(A.todense()), ref, rtol=1e-14)


def test_ell_pack_roundtrip(small_csr):
    (indptr, indices, data), shape = small_csr
    A = convert.ell_device(indptr, indices, data, shape, row_pad=8)
    assert A.nrows_pad % 8 == 0
    ref = sp.csr_matrix((data, indices, indptr), shape=shape).toarray()
    np.testing.assert_allclose(np.asarray(A.todense()), ref, rtol=1e-14)


def test_bsr_pack_roundtrip(small_csr):
    (indptr, indices, data), shape = small_csr
    A = convert.bsr_device(indptr, indices, data, shape, block_shape=(8, 16))
    ref = sp.csr_matrix((data, indices, indptr), shape=shape).toarray()
    np.testing.assert_allclose(np.asarray(A.todense()), ref, rtol=1e-12)


def test_sliced_ell_pack(small_csr):
    (indptr, indices, data), shape = small_csr
    vals, cols, starts, perm = convert.csr_to_sliced_ell_arrays(
        indptr, indices, data, shape, slice_height=8
    )
    # reconstruct dense from SELL layout
    dense = np.zeros(shape)
    counts = np.diff(indptr)
    npad = len(perm)
    counts_pad = np.zeros(npad, dtype=np.int64)
    counts_pad[: shape[0]] = counts
    for s in range(len(starts) - 1):
        base = starts[s]
        width = (starts[s + 1] - starts[s]) // 8
        for r in range(8):
            orig = perm[s * 8 + r]
            if orig >= shape[0]:
                continue
            for kk in range(counts_pad[orig]):
                slot = base + r + kk * 8
                dense[orig, cols[slot]] += vals[slot]
    ref = sp.csr_matrix((data, indices, indptr), shape=shape).toarray()
    np.testing.assert_allclose(dense, ref, rtol=1e-14)


def test_pytree_flatten(small_csr):
    import jax

    (indptr, indices, data), shape = small_csr
    A = convert.csr_device(indptr, indices, data, shape)
    leaves, treedef = jax.tree_util.tree_flatten(A)
    A2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(A2, CSR)
    assert A2.shape == A.shape
