"""XLA-native SpMV kernels — every SpMV this package runs.

These are the analogue of the reference's sequential `native.so` backend
(reference libspmv/native-impl.c:1-12): plain JAX, so the same code
runs on the CPU (tests) and the GPU, where XLA fuses the gather-multiply
into the reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lilac.formats.sparse import BSR, COO, CSR, ELL
from lilac.kernels.registry import register_kernel
from lilac.ops import dfloat as df


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


def csr_spmv(A: CSR, x: jax.Array) -> jax.Array:
    """y = A @ x via gather + sorted segment-sum (requires A.row_ids)."""
    assert A.row_ids is not None, "call A.with_row_ids() first"
    prod = A.data * x[A.indices]
    return jax.ops.segment_sum(
        prod, A.row_ids, num_segments=A.shape[0], indices_are_sorted=True
    )


def csr_spmv_t(A: CSR, x: jax.Array) -> jax.Array:
    """y = A.T @ x via scatter-add (the true transpose product; the reference
    suite's BiCG silently substituted A for A^T, SURVEY.md section 3.5 — we
    implement the honest semantics)."""
    assert A.row_ids is not None
    prod = A.data * x[A.row_ids]
    return jnp.zeros(A.shape[1], A.data.dtype).at[A.indices].add(prod)


register_kernel("xla_csr", csr_spmv, CSR, transpose=csr_spmv_t)


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------


def coo_spmv(A: COO, x: jax.Array) -> jax.Array:
    prod = A.data * x[A.col]
    return jnp.zeros(A.shape[0], A.data.dtype).at[A.row].add(prod)


def coo_spmv_t(A: COO, x: jax.Array) -> jax.Array:
    prod = A.data * x[A.row]
    return jnp.zeros(A.shape[1], A.data.dtype).at[A.col].add(prod)


register_kernel("xla_coo", coo_spmv, COO, transpose=coo_spmv_t)


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


def ell_spmv(A: ELL, x: jax.Array) -> jax.Array:
    """y = A @ x: gather [rows, K] then reduce K. Padding is (idx 0, val 0)."""
    y = jnp.sum(A.data * x[A.indices], axis=1)
    return y[: A.shape[0]]


def ell_spmv_t(A: ELL, x: jax.Array) -> jax.Array:
    xr = jnp.pad(x, (0, A.nrows_pad - A.shape[0]))
    prod = A.data * xr[:, None]
    return jnp.zeros(A.shape[1], A.data.dtype).at[A.indices.ravel()].add(prod.ravel())


register_kernel("xla_ell", ell_spmv, ELL, transpose=ell_spmv_t)


# ---------------------------------------------------------------------------
# ELL, double-word values (df64): data is [rows, K, 2] (hi, lo)
# ---------------------------------------------------------------------------


def ell_spmv_df(A: ELL, x: df.DF) -> df.DF:
    """df64 SpMV: TwoProd per element, pairwise df-sum over the K axis.

    The K-axis halving reduction keeps everything vectorized over rows.
    x is gathered as (hi, lo) pairs from an [n, 2] stack, so one index
    fetch serves both words.
    """
    a = df.DF(A.data[..., 0], A.data[..., 1])
    xs = jnp.stack([x.hi, x.lo], axis=-1)
    g = xs[A.indices]
    xg = df.DF(g[..., 0], g[..., 1])
    terms = df.mul(a, xg)
    y = df.sum_df(terms, axis=1)
    return df.DF(y.hi[: A.shape[0]], y.lo[: A.shape[0]])


register_kernel("xla_ell_df", ell_spmv_df, ELL, dfloat=True)


# ---------------------------------------------------------------------------
# BSR — dense block products
# ---------------------------------------------------------------------------


def bsr_spmv(A: BSR, x: jax.Array) -> jax.Array:
    bh, bw = A.block_shape
    nbr = A.indptr.shape[0] - 1
    # gather x block segments: [nblocks, bw]
    xseg = x[(A.indices[:, None] * bw + jnp.arange(bw)[None, :]) % A.shape[1]]
    # mask out-of-range padding columns
    valid = (A.indices[:, None] * bw + jnp.arange(bw)[None, :]) < A.shape[1]
    xseg = jnp.where(valid, xseg, 0.0)
    # HIGHEST: a float32 product must not drop to TF32 on the GPU
    prod = jnp.einsum(
        "brc,bc->br", A.data, xseg, preferred_element_type=A.data.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    # block-row id of each block from indptr (jit-safe)
    rowid = (
        jnp.searchsorted(
            A.indptr, jnp.arange(A.nblocks, dtype=A.indptr.dtype), side="right"
        )
        - 1
    )
    yblk = jax.ops.segment_sum(
        prod, rowid, num_segments=nbr, indices_are_sorted=True
    )
    return yblk.reshape(nbr * bh)[: A.shape[0]]


register_kernel("xla_bsr", bsr_spmv, BSR)


# ---------------------------------------------------------------------------
# BucketELL — degree-bucketed slicing (general irregular matrices)
# ---------------------------------------------------------------------------

from lilac.formats.sparse import BucketELL  # noqa: E402


def bucket_ell_spmv(A: BucketELL, x: jax.Array) -> jax.Array:
    parts = [
        jnp.sum(v * x[i], axis=1)
        for v, i in zip(A.data, A.indices)
    ]
    return jnp.concatenate(parts)[A.inv_perm]


def bucket_ell_spmv_df(A: BucketELL, x: df.DF) -> df.DF:
    xs = jnp.stack([x.hi, x.lo], axis=-1)
    his, los = [], []
    for v, i in zip(A.data, A.indices):
        a = df.DF(v[..., 0], v[..., 1])
        g = xs[i]
        yb = df.sum_df(df.mul(a, df.DF(g[..., 0], g[..., 1])), axis=1)
        his.append(yb.hi)
        los.append(yb.lo)
    ys = jnp.stack([jnp.concatenate(his), jnp.concatenate(los)], axis=-1)
    out = ys[A.inv_perm]
    return df.DF(out[..., 0], out[..., 1])


def bucket_ell_spmv_t(A: BucketELL, x: jax.Array) -> jax.Array:
    """y = A.T @ x: scatter x back into bucket-row order (inverse of the
    forward kernel's final unpermute), then per-bucket scatter-add of
    v·x_row into the column space. Pad rows land on zeros."""
    nb = sum(v.shape[0] for v in A.data)
    xb = jnp.zeros(nb, x.dtype).at[A.inv_perm].set(x[: A.shape[0]])
    out = jnp.zeros(A.shape[1], A.data[0].dtype)
    off = 0
    for v, i in zip(A.data, A.indices):
        xs = jax.lax.slice_in_dim(xb, off, off + v.shape[0])
        out = out.at[i.ravel()].add((v * xs[:, None]).ravel())
        off += v.shape[0]
    return out


register_kernel("xla_sell", bucket_ell_spmv, BucketELL,
                transpose=bucket_ell_spmv_t)
register_kernel("xla_sell_df", bucket_ell_spmv_df, BucketELL, dfloat=True)


# ---------------------------------------------------------------------------
# SegBucketELL — column-segmented + degree-bucketed (large-n matrices)
# ---------------------------------------------------------------------------

from lilac.formats.sparse import SegBucketELL  # noqa: E402


def _pad_rows(xs: jax.Array, total: int) -> jax.Array:
    return jnp.pad(xs, [(0, total - xs.shape[0])] + [(0, 0)] * (xs.ndim - 1))


def _seg_tables(A: SegBucketELL, xs: jax.Array):
    """Pad the x table ([n] or [n, 2] df pairs) to whole segments and
    pre-slice per segment (static slices). Returns (segments,
    full_table); parts with segment id -1 (overflow tails) gather from
    the full table with global indices."""
    nseg = max(p[2] for p in A.parts) + 1 if A.parts else 1
    if nseg <= 1:
        return [xs], xs  # single segment: indices are global-valid
    xsp = _pad_rows(xs, nseg * A.seg_size)
    segs = [
        jax.lax.dynamic_slice_in_dim(xsp, s * A.seg_size, A.seg_size, 0)
        for s in range(nseg)
    ]
    return segs, xs


def seg_bucket_ell_spmv(A: SegBucketELL, x: jax.Array) -> jax.Array:
    segs, full = _seg_tables(A, x)
    acc = {}
    for (lo, hi, s, w), v, i in zip(A.parts, A.data, A.indices):
        g = (full if s < 0 else segs[s])[i]
        part = jnp.sum(v * g, axis=1)
        acc[(lo, hi)] = acc.get((lo, hi), 0.0) + part
    y = jnp.concatenate([acc[k] for k in sorted(acc)])
    if A.identity_perm:
        return y
    return y[A.inv_perm]


def seg_bucket_ell_spmv_df(A: SegBucketELL, x: df.DF) -> df.DF:
    xs = jnp.stack([x.hi, x.lo], axis=-1)
    segs, full = _seg_tables(A, xs)
    acc = {}
    for (lo, hi, s, w), v, i in zip(A.parts, A.data, A.indices):
        g = (full if s < 0 else segs[s])[i]
        a = df.DF(v[..., 0], v[..., 1])
        t = df.sum_df(df.mul(a, df.DF(g[..., 0], g[..., 1])), axis=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = t if prev is None else df.add(prev, t)
    his = jnp.concatenate([acc[k].hi for k in sorted(acc)])
    los = jnp.concatenate([acc[k].lo for k in sorted(acc)])
    if A.identity_perm:
        return df.DF(his, los)
    ys = jnp.stack([his, los], axis=-1)
    out = ys[A.inv_perm]
    return df.DF(out[..., 0], out[..., 1])


register_kernel("xla_segell", seg_bucket_ell_spmv, SegBucketELL)
register_kernel("xla_segell_df", seg_bucket_ell_spmv_df, SegBucketELL, dfloat=True)


# ---------------------------------------------------------------------------
# SegELLScan — uniform-width stacked segments, lax.scan accumulation
# ---------------------------------------------------------------------------

from lilac.formats.sparse import SegELLScan  # noqa: E402


def _scan_seg_tables(A: SegELLScan, xs: jax.Array) -> jax.Array:
    """Pad the x table ([ncol] or [ncol, 2] df pairs) to whole segments
    and stack to [nseg, seg_size, ...] so the scan slices one segment's
    gather table per step."""
    xsp = _pad_rows(xs, A.nseg * A.seg_size)
    return xsp.reshape((A.nseg, A.seg_size) + xs.shape[1:])


def seg_ell_scan_spmv(A: SegELLScan, x: jax.Array) -> jax.Array:
    xsegs = _scan_seg_tables(A, x)

    def body(y, op):
        v, i, xseg = op  # v,i: [w, n] w-major; xseg: [seg]
        return y + jnp.sum(v * xseg[i], axis=0), None

    y0 = jnp.zeros(A.shape[0], A.main_data.dtype)
    y, _ = jax.lax.scan(body, y0, (A.main_data, A.main_indices, xsegs))
    if A.tail_data is not None:
        yt = jnp.sum(A.tail_data * x[A.tail_indices], axis=0)
        yt1 = jnp.concatenate([yt, jnp.zeros(1, yt.dtype)])
        y = y + yt1[A.tail_pos]
    return y


def seg_ell_scan_spmv_df(A: SegELLScan, x: df.DF) -> df.DF:
    xs = jnp.stack([x.hi, x.lo], axis=-1)
    xsegs = _scan_seg_tables(A, xs)

    def body(y, op):
        v, i, xseg = op
        g = xseg[i]
        a = df.DF(v[..., 0], v[..., 1])
        t = df.sum_df(df.mul(a, df.DF(g[..., 0], g[..., 1])), axis=0)
        return df.add(y, t), None

    zero = jnp.zeros(A.shape[0], jnp.float32)
    y, _ = jax.lax.scan(
        body, df.DF(zero, zero), (A.main_data, A.main_indices, xsegs)
    )
    if A.tail_data is not None:
        g = xs[A.tail_indices]
        a = df.DF(A.tail_data[..., 0], A.tail_data[..., 1])
        t = df.sum_df(df.mul(a, df.DF(g[..., 0], g[..., 1])), axis=0)
        pad = jnp.zeros((1, 2), jnp.float32)
        yt = jnp.concatenate([jnp.stack([t.hi, t.lo], axis=-1), pad])
        gt = yt[A.tail_pos]
        y = df.add(y, df.DF(gt[..., 0], gt[..., 1]))
    return y


register_kernel("xla_segscan", seg_ell_scan_spmv, SegELLScan)
register_kernel("xla_segscan_df", seg_ell_scan_spmv_df, SegELLScan, dfloat=True)
