"""Host-side (numpy) format construction and conversion.

The reference suite marshals matrices between host CSR and device formats on
every backend (e.g. 1-based -> 0-based conversion at
/root/reference/libspmv/opencl.cpp:365-379, JDS transform at
parboil convert_dataset.c:160+). Here the conversions run once at plan-build
time; device-side data is immutable thereafter (the analogue of the
reference's mprotect mutation-trap caches, /root/reference/libspmv/gpu.c:140-209).

All functions take/return numpy; `*_device` wrappers produce jax containers.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from lilac.formats.sparse import BSR, COO, CSR, ELL, SlicedELL


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# COO -> canonical CSR (sorted, deduplicated)
# ---------------------------------------------------------------------------


def coo_to_csr_arrays(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    shape: Tuple[int, int],
    sum_duplicates: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build canonical CSR (indptr, indices, data) from COO triples.

    Duplicate (row, col) entries are summed (matching the reference's
    `sparse` assembly, /root/reference/NPB3.3.1/CG/cg.f:814-871, which sums
    duplicated outer-product contributions in place).
    """
    n, _ = shape
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    if sum_duplicates and len(row):
        keep = np.empty(len(row), dtype=bool)
        keep[0] = True
        keep[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
        group = np.cumsum(keep) - 1
        uval = np.zeros(int(group[-1]) + 1, dtype=val.dtype)
        np.add.at(uval, group, val)
        row, col, val = row[keep], col[keep], uval
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    np.cumsum(indptr, out=indptr)
    return (
        indptr.astype(np.int32),
        col.astype(np.int32),
        val,
    )


def csr_device(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    dtype=None,
    with_row_ids: bool = True,
) -> CSR:
    if dtype is not None:
        data = data.astype(dtype)
    m = CSR(
        data=jnp.asarray(data),
        indices=jnp.asarray(indices, dtype=jnp.int32),
        indptr=jnp.asarray(indptr, dtype=jnp.int32),
        shape=tuple(shape),
    )
    return m.with_row_ids() if with_row_ids else m


def coo_device(row, col, val, shape, dtype=None) -> COO:
    if dtype is not None:
        val = val.astype(dtype)
    return COO(
        row=jnp.asarray(row, dtype=jnp.int32),
        col=jnp.asarray(col, dtype=jnp.int32),
        data=jnp.asarray(val),
        shape=tuple(shape),
    )


# ---------------------------------------------------------------------------
# CSR -> ELL / SlicedELL / BSR packing
# ---------------------------------------------------------------------------


def csr_to_ell_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    row_pad: int = 8,
    slot_pad: int = 1,
    max_slots: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack CSR into ELL: [nrows_pad, K] values + column indices.

    Padding slots get (index 0, value 0). `row_pad` aligns the row count
    (a multiple of 8 by default); `slot_pad` aligns K. Returns (vals,
    cols).
    """
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    k = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    k = round_up(k, slot_pad)
    if max_slots is not None and k > max_slots:
        raise ValueError(f"row length {k} exceeds max_slots {max_slots}")
    npad = round_up(max(n, 1), row_pad)
    vals = np.zeros((npad, k) + data.shape[1:], dtype=data.dtype)
    cols = np.zeros((npad, k), dtype=np.int32)
    # scatter: position of element j within its row
    rowid = np.repeat(np.arange(n), counts)
    slot = np.arange(len(indices), dtype=np.int64) - np.repeat(indptr[:-1], counts)
    vals[rowid, slot] = data
    cols[rowid, slot] = indices
    return vals, cols


def ell_device(indptr, indices, data, shape, dtype=None, row_pad=8, slot_pad=1) -> ELL:
    if dtype is not None:
        data = data.astype(dtype)
    vals, cols = csr_to_ell_arrays(indptr, indices, data, shape, row_pad, slot_pad)
    return ELL(data=jnp.asarray(vals), indices=jnp.asarray(cols), shape=tuple(shape))


def csr_to_sliced_ell_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    slice_height: int = 8,
):
    """SELL-C packing: sort rows by descending length, pad per slice."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    npad = round_up(max(n, 1), slice_height)
    counts_pad = np.zeros(npad, dtype=np.int64)
    counts_pad[:n] = counts
    perm = np.argsort(-counts_pad, kind="stable").astype(np.int32)
    sorted_counts = counts_pad[perm]
    nslices = npad // slice_height
    slice_k = sorted_counts.reshape(nslices, slice_height).max(axis=1)
    slot_starts = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(slice_k * slice_height, out=slot_starts[1:])
    total = int(slot_starts[-1])
    vals = np.zeros((total,) + data.shape[1:], dtype=data.dtype)
    cols = np.zeros(total, dtype=np.int32)
    for s in range(nslices):
        k = int(slice_k[s])
        base = int(slot_starts[s])
        for r in range(slice_height):
            orig = perm[s * slice_height + r]
            if orig >= n:
                continue
            lo, hi = indptr[orig], indptr[orig + 1]
            # column-major within the slice so lanes stay coalesced
            dst = base + r + np.arange(hi - lo) * slice_height
            vals[dst] = data[lo:hi]
            cols[dst] = indices[lo:hi]
    return vals, cols, slot_starts.astype(np.int32), perm


def csr_to_bsr_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    block_shape: Tuple[int, int] = (8, 128),
):
    """Re-block CSR into BSR with dense (bh, bw) blocks (zero-filled)."""
    bh, bw = block_shape
    n, m = shape
    nbr = (n + bh - 1) // bh
    counts = np.diff(indptr).astype(np.int64)
    rowid = np.repeat(np.arange(n), counts)
    brow = rowid // bh
    bcol = indices // bw
    key = brow.astype(np.int64) * ((m + bw - 1) // bw) + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, first = np.unique(key_s, return_index=True)
    nblocks = len(uniq)
    bvals = np.zeros((nblocks, bh, bw), dtype=data.dtype)
    block_of = np.searchsorted(uniq, key)
    lr = rowid % bh
    lc = indices % bw
    np.add.at(bvals, (block_of, lr, lc), data)
    ubrow = (uniq // ((m + bw - 1) // bw)).astype(np.int64)
    ubcol = (uniq % ((m + bw - 1) // bw)).astype(np.int32)
    bindptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(bindptr, ubrow + 1, 1)
    np.cumsum(bindptr, out=bindptr)
    return bvals, ubcol, bindptr.astype(np.int32)


def bsr_device(indptr, indices, data, shape, block_shape=(8, 128), dtype=None) -> BSR:
    if dtype is not None:
        data = data.astype(dtype)
    bv, bc, bp = csr_to_bsr_arrays(indptr, indices, data, shape, block_shape)
    return BSR(
        data=jnp.asarray(bv),
        indices=jnp.asarray(bc),
        indptr=jnp.asarray(bp),
        shape=tuple(shape),
        block_shape=tuple(block_shape),
    )


def dense_to_csr_arrays(dense: np.ndarray, tol: float = 0.0):
    """Dense -> CSR, keeping entries with |a_ij| > tol (exact zeros dropped)."""
    mask = np.abs(dense) > tol
    row, col = np.nonzero(mask)
    val = dense[row, col]
    return coo_to_csr_arrays(
        row.astype(np.int64), col.astype(np.int64), val, dense.shape
    )


def csr_to_bucket_ell_arrays(indptr, indices, data, shape, *, quantiles=(50, 90)):
    """Split rows into width-quantile buckets (host). Returns
    (bucket_indices, bucket_values, inv_perm, widths) with numpy arrays.

    Above the top quantile the widths continue as a geometric ladder
    (x4 per bucket) up to the max row length: heavy-tailed degree
    distributions (power-law graphs) otherwise pad every tail row to the
    global max — observed as a 149 GiB allocation on a 1M-node
    scale-free graph whose hub row had 200k entries."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 0
    cand_set = {max(int(np.percentile(counts, q)), 1) for q in quantiles}
    w = max(cand_set) if cand_set else 1
    while w < kmax:
        w = min(w * 4, kmax)
        cand_set.add(w)
    cand = sorted(cand_set | {kmax})
    perm = np.argsort(counts, kind="stable")
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    sorted_counts = counts[perm]

    bucket_idx, bucket_val, widths = [], [], []
    lo = 0
    for w in cand:
        hi = int(np.searchsorted(sorted_counts, w, side="right"))
        if hi <= lo:
            continue
        rows_b = perm[lo:hi]
        nb = len(rows_b)
        bi = np.zeros((nb, w), dtype=np.int64)
        bv = np.zeros((nb, w) + data.shape[1:], dtype=data.dtype)
        for i, r in enumerate(rows_b):
            a, b = indptr[r], indptr[r + 1]
            bi[i, : b - a] = indices[a:b]
            bv[i, : b - a] = data[a:b]
        bucket_idx.append(bi)
        bucket_val.append(bv)
        widths.append(w)
        lo = hi
    return bucket_idx, bucket_val, inv_perm, tuple(widths)


def bucket_ell_device(indptr, indices, data, shape, dtype=None, quantiles=(50, 90)):
    from lilac.formats.sparse import BucketELL

    if dtype is not None:
        data = data.astype(dtype)
    bi, bv, inv_perm, widths = csr_to_bucket_ell_arrays(
        indptr, indices, data, shape, quantiles=quantiles
    )
    return BucketELL(
        data=tuple(jnp.asarray(v) for v in bv),
        indices=tuple(jnp.asarray(i, dtype=jnp.int32) for i in bi),
        inv_perm=jnp.asarray(inv_perm, dtype=jnp.int32),
        shape=tuple(shape),
        widths=widths,
    )


def csr_to_seg_bucket_ell(
    indptr, indices, data, shape, *, seg_size=163840, quantiles=(50, 90),
    seg_quantile=95.0,
):
    """Host build for SegBucketELL (see formats/sparse.py).

    Multi-segment mode stores a MAIN part per segment at a fixed
    quantile-capped width (identity row order, no un-permute) and spills
    the excess entries into a TAIL: a degree-bucketed single-"segment"
    structure with GLOBAL indices (slow big-table gather, but only ~the
    top few percent of entries). This caps the Poisson per-segment max
    padding that otherwise blows memory (observed 7x on NPB class D).
    Tail parts are marked with segment id -1 in `parts`.
    """
    from lilac.formats.sparse import SegBucketELL

    n, ncol = shape
    nseg = -(-ncol // seg_size)
    if nseg > 1:
        return _seg_bucket_multiseg(
            indptr, indices, data, shape, seg_size, nseg, quantiles, seg_quantile
        )
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 0
    cand = sorted({max(int(np.percentile(counts, q)), 1) for q in quantiles} | {kmax})
    # identity (no bucketing) is only safe single-segment: with multiple
    # segments a single bucket pads every row to the global per-segment
    # max count (Poisson max over n rows — observed 7x blow-up and HBM
    # OOM on NPB class D). Multi-segment bucketing of per-segment counts
    # is future work; callers choose seg_size >= ncol to opt out.
    identity = bool(cand and cand[0] * 1.25 >= kmax and nseg == 1)
    if identity:
        # near-uniform row lengths: bucketing and the output un-permute
        # buy nothing — keep original order (kernel skips the un-permute)
        cand = [kmax]
        perm = np.arange(n, dtype=np.int64)
        inv_perm = perm
    else:
        perm = np.argsort(counts, kind="stable")
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[perm] = np.arange(n)
    sorted_counts = counts[perm]

    # per-row, per-segment slices (rows already column-sorted)
    rows_rep = np.repeat(np.arange(n), counts)
    seg_of = indices // seg_size
    # position of each entry within its (row, segment) run
    # entries are sorted by (row, col) so (row, seg) runs are contiguous
    run_key = rows_rep * nseg + seg_of
    run_start = np.zeros(len(indices), dtype=bool)
    if len(indices):
        run_start[0] = True
        run_start[1:] = run_key[1:] != run_key[:-1]
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.zeros(run_id[-1] + 1 if len(indices) else 0, dtype=np.int64)
    first_of_run[run_id[run_start]] = np.nonzero(run_start)[0]
    slot_in_run = np.arange(len(indices)) - first_of_run[run_id]

    # per (row, seg) counts
    rs_counts = np.zeros((n, nseg), dtype=np.int64)
    np.add.at(rs_counts, (rows_rep, seg_of), 1)

    datas, idxs, parts = [], [], []
    lo = 0
    for w in cand:
        hi = int(np.searchsorted(sorted_counts, w, side="right"))
        if hi <= lo:
            continue
        rows_b = perm[lo:hi]
        pos_of = np.full(n, -1, dtype=np.int64)
        pos_of[rows_b] = np.arange(len(rows_b))
        for s in range(nseg):
            wk = int(rs_counts[rows_b, s].max()) if len(rows_b) else 0
            if wk == 0:
                continue
            bi = np.zeros((len(rows_b), wk), dtype=np.int64)
            bv = np.zeros((len(rows_b), wk) + data.shape[1:], dtype=data.dtype)
            sel = (seg_of == s) & (pos_of[rows_rep] >= 0)
            r_local = pos_of[rows_rep[sel]]
            k_local = slot_in_run[sel]
            bi[r_local, k_local] = indices[sel] - s * seg_size
            bv[r_local, k_local] = data[sel]
            datas.append(bv)
            idxs.append(bi)
            parts.append((lo, hi, s, wk))
        lo = hi
    return SegBucketELL(
        data=tuple(jnp.asarray(v) for v in datas),
        indices=tuple(jnp.asarray(i, dtype=jnp.int32) for i in idxs),
        inv_perm=jnp.asarray(inv_perm, dtype=jnp.int32),
        shape=tuple(shape),
        parts=tuple(parts),
        seg_size=seg_size,
        identity_perm=identity,
    )


def csr_to_seg_ell_scan(
    indptr, indices, data, shape, *, seg_size=163840, seg_quantile=97.0
):
    """Host build for SegELLScan (see formats/sparse.py).

    One uniform width w = the `seg_quantile` percentile of per-(row,
    segment) entry counts (max across segments so the tail stays small);
    the first w entries of each (row, segment) run go into that segment's
    slab, the rest spill into the global-index tail.
    """
    from lilac.formats.sparse import SegELLScan

    n, ncol = shape
    nseg = -(-ncol // seg_size)
    counts = np.diff(indptr).astype(np.int64)
    rows_rep = np.repeat(np.arange(n), counts)
    seg_of = indices // seg_size
    # within-(row, segment)-run slot (entries are (row, col)-sorted)
    run_key = rows_rep * nseg + seg_of
    run_start = np.zeros(len(indices), dtype=bool)
    if len(indices):
        run_start[0] = True
        run_start[1:] = run_key[1:] != run_key[:-1]
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.zeros(run_id[-1] + 1 if len(indices) else 0, dtype=np.int64)
    first_of_run[run_id[run_start]] = np.nonzero(run_start)[0]
    slot_in_run = np.arange(len(indices)) - first_of_run[run_id]
    rs_counts = np.zeros((n, nseg), dtype=np.int64)
    np.add.at(rs_counts, (rows_rep, seg_of), 1)

    w = max(
        1,
        int(max(np.percentile(rs_counts[:, s], seg_quantile) for s in range(nseg)))
        if n
        else 1,
    )
    main = slot_in_run < w
    # w-MAJOR slabs: [nseg, w, n] so the big n dimension sits on the lane
    # axis (w-minor layouts pad w -> 128 lanes: measured 25x blow-up)
    mi = np.zeros((nseg, w, n), dtype=np.int64)
    mv = np.zeros((nseg, w, n) + data.shape[1:], dtype=data.dtype)
    mi[seg_of[main], slot_in_run[main], rows_rep[main]] = (
        indices[main] - seg_of[main] * seg_size
    )
    mv[seg_of[main], slot_in_run[main], rows_rep[main]] = data[main]

    ov = np.nonzero(~main)[0]
    tv = ti = tp = None
    if len(ov):
        trows = rows_rep[ov]
        tail_rows = np.unique(trows)  # sorted
        m_t = len(tail_rows)
        pos_of = np.full(n, m_t, dtype=np.int64)
        pos_of[tail_rows] = np.arange(m_t)
        tstart = np.zeros(n + 1, dtype=np.int64)
        np.add.at(tstart, trows + 1, 1)
        np.cumsum(tstart, out=tstart)
        tslot = np.arange(len(ov)) - tstart[trows]
        wt = int(np.diff(tstart).max())
        ti_np = np.zeros((wt, m_t), dtype=np.int64)
        tv_np = np.zeros((wt, m_t) + data.shape[1:], dtype=data.dtype)
        ti_np[tslot, pos_of[trows]] = indices[ov]
        tv_np[tslot, pos_of[trows]] = data[ov]
        ti = jnp.asarray(ti_np, dtype=jnp.int32)
        tv = jnp.asarray(tv_np)
        tp = jnp.asarray(pos_of, dtype=jnp.int32)

    return SegELLScan(
        main_data=jnp.asarray(mv),
        main_indices=jnp.asarray(mi, dtype=jnp.int32),
        tail_data=tv,
        tail_indices=ti,
        tail_pos=tp,
        shape=tuple(shape),
        seg_size=seg_size,
        nseg=nseg,
        width=w,
    )


def _seg_bucket_multiseg(indptr, indices, data, shape, seg_size, nseg,
                         quantiles, seg_quantile):
    from lilac.formats.sparse import SegBucketELL

    n, _ = shape
    counts = np.diff(indptr).astype(np.int64)
    rows_rep = np.repeat(np.arange(n), counts)
    seg_of = indices // seg_size
    # per (row, seg) counts and within-run slots (entries col-sorted)
    run_key = rows_rep * nseg + seg_of
    run_start = np.zeros(len(indices), dtype=bool)
    if len(indices):
        run_start[0] = True
        run_start[1:] = run_key[1:] != run_key[:-1]
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.zeros(run_id[-1] + 1 if len(indices) else 0, dtype=np.int64)
    first_of_run[run_id[run_start]] = np.nonzero(run_start)[0]
    slot_in_run = np.arange(len(indices)) - first_of_run[run_id]
    rs_counts = np.zeros((n, nseg), dtype=np.int64)
    np.add.at(rs_counts, (rows_rep, seg_of), 1)

    datas, idxs, parts = [], [], []
    overflow_mask = np.zeros(len(indices), dtype=bool)
    for s in range(nseg):
        cs = rs_counts[:, s]
        w = max(int(np.percentile(cs, seg_quantile)), 1)
        sel = (seg_of == s) & (slot_in_run < w)
        overflow_mask |= (seg_of == s) & (slot_in_run >= w)
        bi = np.zeros((n, w), dtype=np.int64)
        bv = np.zeros((n, w) + data.shape[1:], dtype=data.dtype)
        bi[rows_rep[sel], slot_in_run[sel]] = indices[sel] - s * seg_size
        bv[rows_rep[sel], slot_in_run[sel]] = data[sel]
        datas.append(bv)
        idxs.append(bi)
        parts.append((0, n, s, w))

    # tail: overflow entries with GLOBAL indices, degree-bucketed with its
    # own row subset but emitted at FULL row height in identity order so
    # the kernel can sum parts directly (rows without overflow contribute
    # padded zeros; the tail is a few percent of entries)
    ov = np.nonzero(overflow_mask)[0]
    if len(ov):
        t_counts = np.zeros(n, dtype=np.int64)
        np.add.at(t_counts, rows_rep[ov], 1)
        wt = int(t_counts.max())
        # slot within tail per row
        order = ov  # already (row, col)-sorted
        trows = rows_rep[order]
        tstart = np.zeros(n + 1, dtype=np.int64)
        np.add.at(tstart, trows + 1, 1)
        np.cumsum(tstart, out=tstart)
        tslot = np.arange(len(order)) - tstart[trows]
        bi = np.zeros((n, wt), dtype=np.int64)
        bv = np.zeros((n, wt) + data.shape[1:], dtype=data.dtype)
        bi[trows, tslot] = indices[order]
        bv[trows, tslot] = data[order]
        datas.append(bv)
        idxs.append(bi)
        parts.append((0, n, -1, wt))

    return SegBucketELL(
        data=tuple(jnp.asarray(v) for v in datas),
        indices=tuple(jnp.asarray(i, dtype=jnp.int32) for i in idxs),
        inv_perm=jnp.arange(n, dtype=jnp.int32),
        shape=tuple(shape),
        parts=tuple(parts),
        seg_size=seg_size,
        identity_perm=True,
    )
