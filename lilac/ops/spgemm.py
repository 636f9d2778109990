"""SpGEMM (sparse × sparse) — C = A·B.

The reference never computes a general SpGEMM directly (SparseX's CSX
tuning is the closest analogue), but the north-star capability list names
it (SURVEY.md §7 hard parts). Three paths:

* gustavson(...)   — host reference: row-wise Gustavson (per-row loop),
                     kept as the oracle for tests;
* expand_csr(...) / host vectorized expansion used by both the host
                     fast path and the device staging;
* esc_spgemm(...)  — the device path: ESC (expand / sort / compress).
                     Expansion is a static-shape ELL×ELL row gather, the
                     sort is one lexicographic lax.sort over (row, col)
                     keys, compression is a segment-sum — all XLA ops
                     with static shapes, chunked over A's rows (rows are
                     independent, so row-chunking is exact and bounds
                     the [chunk·Ka·Kb] expansion memory);
* masked_dense(...)— dense matmul over the densified operands, for
                     moderate n; esc_spgemm covers the large-n sparse
                     regime where densifying would O(n·m) OOM.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def gustavson(
    a: Tuple[np.ndarray, np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray, np.ndarray],
    shape_a: Tuple[int, int],
    shape_b: Tuple[int, int],
):
    """Row-wise Gustavson SpGEMM on host. Inputs/outputs canonical CSR."""
    assert shape_a[1] == shape_b[0]
    a_ptr, a_idx, a_val = a
    b_ptr, b_idx, b_val = b
    n, m = shape_a[0], shape_b[1]

    out_ptr = np.zeros(n + 1, dtype=np.int64)
    rows_idx = []
    rows_val = []
    acc = np.zeros(m, dtype=np.float64)
    # occupancy is tracked with a marker array, NOT by testing acc for 0.0:
    # an exact-zero product or a cancelling partial sum must not re-enter
    # `touched` (would emit duplicate CSR entries)
    mark = np.zeros(m, dtype=bool)
    touched = np.empty(m, dtype=np.int64)
    for i in range(n):
        ntouch = 0
        for k_pos in range(a_ptr[i], a_ptr[i + 1]):
            k = a_idx[k_pos]
            av = a_val[k_pos]
            lo, hi = b_ptr[k], b_ptr[k + 1]
            cols = b_idx[lo:hi]
            newcols = cols[~mark[cols]]
            mark[newcols] = True
            touched[ntouch : ntouch + len(newcols)] = newcols
            ntouch += len(newcols)
            acc[cols] += av * b_val[lo:hi]
        cols_i = np.sort(touched[:ntouch])
        rows_idx.append(cols_i.copy())
        rows_val.append(acc[cols_i].copy())
        acc[cols_i] = 0.0
        mark[cols_i] = False
        out_ptr[i + 1] = out_ptr[i] + len(cols_i)
    return (
        out_ptr,
        np.concatenate(rows_idx) if rows_idx else np.empty(0, np.int64),
        np.concatenate(rows_val) if rows_val else np.empty(0),
        (n, m),
    )


def expand_csr(
    a: Tuple[np.ndarray, np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray, np.ndarray],
    shape_a: Tuple[int, int],
    shape_b: Tuple[int, int],
):
    """Host vectorized Gustavson via expansion: emit every partial product
    (i, j, a_ik·b_kj) with one repeat/gather pass (no per-row Python loop),
    then canonicalise (sort + duplicate-sum) through coo_to_csr_arrays.
    This replaces the loop version for at-scale host use."""
    assert shape_a[1] == shape_b[0]
    a_ptr, a_idx, a_val = a
    b_ptr, b_idx, b_val = b
    n, m = shape_a[0], shape_b[1]
    rows_a = np.repeat(np.arange(n, dtype=np.int64), np.diff(a_ptr))
    lens = np.diff(b_ptr)[a_idx]  # B-row length per A entry
    total = int(lens.sum())
    if total == 0:
        return (np.zeros(n + 1, np.int64), np.empty(0, np.int64),
                np.empty(0), (n, m))
    starts = b_ptr[a_idx]
    ends = np.cumsum(lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    pos = np.repeat(starts, lens) + offs
    out_rows = np.repeat(rows_a, lens)
    out_cols = b_idx[pos]
    out_vals = np.repeat(a_val, lens) * b_val[pos]
    from lilac.formats.convert import coo_to_csr_arrays

    ptr, idx, val = coo_to_csr_arrays(out_rows, out_cols, out_vals, (n, m))
    return ptr, idx, val, (n, m)


def _esc_chunk_impl(va, ca, cnt_a, vb, cb, cnt_b, n_sentinel):
    """One row-chunk of ESC on device. va/ca: [R, Ka] ELL chunk of A with
    global column ids; vb/cb: [k_pad, Kb] ELL of B; cnt_*: true row
    lengths. Returns (rowkey, colkey, segsum, first) all [R*Ka*Kb],
    sorted by (rowkey, colkey) with invalid slots keyed to n_sentinel."""
    import jax
    import jax.numpy as jnp

    R, Ka = ca.shape
    Kb = cb.shape[1]
    bcols = cb[ca]  # [R, Ka, Kb]
    bvals = vb[ca]
    prods = va[:, :, None] * bvals
    rows = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None, None],
                            (R, Ka, Kb))
    valid_a = jnp.arange(Ka, dtype=jnp.int32)[None, :] < cnt_a[:, None]
    valid_b = (jnp.arange(Kb, dtype=jnp.int32)[None, None, :]
               < cnt_b[ca][:, :, None])
    valid = valid_a[:, :, None] & valid_b
    rowkey = jnp.where(valid, rows, jnp.int32(n_sentinel))
    rk = rowkey.reshape(-1)
    ck = bcols.reshape(-1)
    pv = prods.reshape(-1)
    rk, ck, pv = jax.lax.sort((rk, ck, pv), num_keys=2)
    prev_r = jnp.concatenate([jnp.full((1,), -1, rk.dtype), rk[:-1]])
    prev_c = jnp.concatenate([jnp.full((1,), -1, ck.dtype), ck[:-1]])
    first = (rk != prev_r) | (ck != prev_c)
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    sums = jnp.zeros(rk.shape[0], pv.dtype).at[seg].add(pv)
    return rk, ck, sums, first


_esc_all_jit = {}


def _esc_all(va, ca, cnt_a, vb, cb, cnt_b, n_sentinel):
    """All row-chunks of ESC in ONE device program: lax.map over the
    [nc, R, ...] chunk axis (compiles one chunk body, scans it), so the
    whole product is a single dispatch with a single result fetch —
    round 2's per-chunk np.asarray round-trips serialized device work
    and made the 'device path' lose to host numpy at every size."""
    global _esc_all_jit
    fn = _esc_all_jit.get(n_sentinel)
    if fn is None:
        import functools

        import jax

        body = functools.partial(_esc_chunk_impl, n_sentinel=n_sentinel)
        fn = jax.jit(
            lambda va, ca, cnt_a, vb, cb, cnt_b: jax.lax.map(
                lambda t: body(t[0], t[1], t[2], vb, cb, cnt_b),
                (va, ca, cnt_a),
            )
        )
        _esc_all_jit[n_sentinel] = fn
    return fn(va, ca, cnt_a, vb, cb, cnt_b)


def esc_spgemm(a_csr, b_csr, shape_a, shape_b, *, row_chunk: int = 16384,
               dtype=np.float32, device_budget_bytes: int = 512 << 20):
    """Device SpGEMM (ESC): returns canonical host CSR of C = A·B.

    Rows of C depend only on the matching rows of A, so chunking A's rows
    is exact; each chunk expands to a static [chunk, Ka, Kb] product
    tensor, lexicographically sorts (row, col) keys on device, and
    segment-sums duplicates. Chunks run through a jitted lax.map in
    SUPER-CHUNK groups sized by device_budget_bytes: the stacked
    (rk, ck, sums, first) result of one group stays ~13-17 bytes per
    ELL-padded partial product, so bounding the group bounds peak device
    residency while keeping dispatch count low (round 2's per-chunk
    fetches serialized device work; round 3's single dispatch made the
    full n·Ka·Kb expansion resident and could OOM large products). The
    host does only the boolean compaction per group."""
    import jax.numpy as jnp

    from lilac.formats.convert import coo_to_csr_arrays, csr_to_ell_arrays

    assert shape_a[1] == shape_b[0]
    n, m = shape_a[0], shape_b[1]
    va, ca_cols = csr_to_ell_arrays(
        a_csr[0], a_csr[1], np.asarray(a_csr[2], dtype=dtype), shape_a
    )
    vb, cb_cols = csr_to_ell_arrays(
        b_csr[0], b_csr[1], np.asarray(b_csr[2], dtype=dtype), shape_b
    )
    cnt_a_full = np.diff(a_csr[0]).astype(np.int32)
    cnt_b = np.diff(b_csr[0]).astype(np.int32)
    # pad cnt arrays to the ELL row padding
    cnt_a_full = np.pad(cnt_a_full, (0, va.shape[0] - n))
    cnt_b = np.pad(cnt_b, (0, vb.shape[0] - shape_b[0]))

    # pad A's rows to a whole number of chunks and stack [nc, R, ...]
    R = min(row_chunk, max(va.shape[0], 1))
    nc = -(-max(n, 1) // R)
    pad = nc * R - va.shape[0]
    if pad > 0:
        va = np.pad(va, ((0, pad), (0, 0)))
        ca_cols = np.pad(ca_cols, ((0, pad), (0, 0)))
        cnt_a_full = np.pad(cnt_a_full, (0, pad))
    else:
        va, ca_cols, cnt_a_full = va[: nc * R], ca_cols[: nc * R], cnt_a_full[: nc * R]
    Ka = va.shape[1]
    Kb = vb.shape[1]
    va = va.reshape(nc, R, Ka)
    ca_cols = ca_cols.reshape(nc, R, Ka)
    cnt_a_full = cnt_a_full.reshape(nc, R)
    # B is shared by every group: upload once
    vb_d, cb_d, cnt_b_d = jnp.asarray(vb), jnp.asarray(cb_cols), jnp.asarray(cnt_b)
    itemsize = np.dtype(dtype).itemsize
    # per-chunk stacked residency: rk/ck int32 + sums + first bool, plus
    # one sort-scratch copy of the key/value triple
    per_chunk = R * max(Ka, 1) * max(Kb, 1) * (2 * (4 + 4 + itemsize) + 1)
    group = max(1, min(nc, int(device_budget_bytes // max(per_chunk, 1))))

    rows_parts, cols_parts, vals_parts = [], [], []
    for g0 in range(0, nc, group):
        g1 = min(g0 + group, nc)
        rk, ck, sums, first = _esc_all(
            jnp.asarray(va[g0:g1]), jnp.asarray(ca_cols[g0:g1]),
            jnp.asarray(cnt_a_full[g0:g1]), vb_d, cb_d, cnt_b_d, R,
        )
        # one fetch per group, then vectorized host compaction
        rk = np.asarray(rk)  # [g, R*Ka*Kb]
        ck, sums, first = np.asarray(ck), np.asarray(sums), np.asarray(first)
        keep = first & (rk < R)  # unique (row, col) groups, non-sentinel
        nuniq = keep.sum(axis=1)  # per chunk
        rows_parts.append(
            (rk + (np.arange(g0, g1, dtype=np.int64) * R)[:, None])[keep]
        )
        cols_parts.append(ck[keep].astype(np.int64))
        # valid groups sort before the sentinel group: each chunk's segment
        # sums are exactly its first nuniq entries, in the same sorted order
        # as the kept (row, col) keys
        vals_mask = np.arange(rk.shape[1])[None, :] < nuniq[:, None]
        vals_parts.append(sums[vals_mask].astype(np.float64))
    rows_all = np.concatenate(rows_parts)
    cols_all = np.concatenate(cols_parts)
    vals_all = np.concatenate(vals_parts)
    ptr, idx, val = coo_to_csr_arrays(rows_all, cols_all, vals_all, (n, m))
    return ptr, idx, val, (n, m)


def masked_dense(a_csr, b_csr, shape_a, shape_b, *, threshold: float = 0.0,
                 dtype=None):
    """Device SpGEMM via a densified matmul; returns host CSR of entries
    with |c| > threshold. Appropriate when n·m fits device memory."""
    import jax
    import jax.numpy as jnp

    n, k = shape_a
    _, m = shape_b
    A = np.zeros((n, k), dtype=np.float32 if dtype is None else dtype)
    rows = np.repeat(np.arange(n), np.diff(a_csr[0]))
    A[rows, a_csr[1]] = a_csr[2]
    B = np.zeros((k, m), dtype=A.dtype)
    rows_b = np.repeat(np.arange(k), np.diff(b_csr[0]))
    B[rows_b, b_csr[1]] = b_csr[2]
    # HIGHEST: float32 operands must not drop to TF32 on the GPU
    C = np.array(jnp.dot(jnp.asarray(A), jnp.asarray(B),
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32))
    C[np.abs(C) <= threshold] = 0.0
    r, c = np.nonzero(C)
    from lilac.formats.convert import coo_to_csr_arrays

    ptr, idx, val = coo_to_csr_arrays(r, c, C[r, c], (n, m))
    return ptr, idx, val, (n, m)
