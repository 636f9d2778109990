"""Factored SpMV for sum-of-sparse-outer-products matrices (NPB CG).

The NPB CG matrix is assembled as A = Σ_i s_i a_i a_iᵀ + (rcond−shift)·I
with each a_i holding only nonzer+1 ≈ 8–27 nonzeros
(reference NPB3.3.1/CG/cg.f:650-905). The assembled matrix has
~(nonzer+1)² nnz per row, but the FACTORED product

    A·x = Vᵀ·(s ⊙ (V x)) + d0·x        (V = stacked a_iᵀ)

needs two narrow sparse passes — about (nonzer+1)/2 times fewer gathered
elements than the assembled form.

Both passes run through the general SegBucketELL kernel: degree-bucketed
slicing for the Vᵀ side's Poisson-spread row lengths, one gather table
per pass. The 'scan' layout (SegELLScan) instead splits the columns into
segments accumulated by lax.scan.

Exactly the same matrix: summation order differs from the assembled CSR
by O(eps) — far inside the ζ tolerance of 1e-10 (verified per class in
tests). Supports f32/f64/df64 value policies like the direct kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lilac.formats.sparse import SegBucketELL, SegELLScan
from lilac.ops import dfloat as df


@dataclasses.dataclass
class FactoredNPB:
    """Device containers for the factored operator (pytree)."""

    V: SegBucketELL  # [n x n] sparse with rows a_i
    VT: SegBucketELL  # transpose
    s: jax.Array  # [n] outer-product weights (f32/f64 or [n,2] df)
    d0: jax.Array  # scalar diagonal shift (rcond - shift)

    def tree_flatten(self):
        return (self.V, self.VT, self.s, self.d0), ()

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch)


jax.tree_util.register_pytree_node(
    FactoredNPB, FactoredNPB.tree_flatten, FactoredNPB.tree_unflatten
)

SEG_SIZE = 163840  # columns per gather segment of the 'scan' layout


def build_factored(
    class_name: str, dtype: str = "f64", segmode: Optional[str] = None
) -> Tuple[FactoredNPB, int]:
    """Host build from the exact makea factors. Returns (containers, nnz_eff)
    where nnz_eff counts gathered elements per matvec (both passes).
    segmode: 'single' | 'scan' layout (None = cfg().factored_segmode)."""
    from lilac.config import cfg
    from lilac.formats.convert import (
        coo_to_csr_arrays,
        csr_to_seg_bucket_ell,
        csr_to_seg_ell_scan,
    )
    from lilac.generate.npb import CLASSES, _generate_triples

    cls = CLASSES[class_name.upper()]
    n = cls.na

    def to_vals(v):
        if dtype == "df64":
            hi = v.astype(np.float32)
            lo = (v - hi.astype(np.float64)).astype(np.float32)
            return np.stack([hi, lo], axis=-1)
        return v.astype({"f32": np.float32, "f64": np.float64}[dtype])

    def to_dev(v):
        return jnp.asarray(to_vals(np.asarray(v)))

    conf = cfg()
    mode = segmode or conf.factored_segmode
    if mode not in ("single", "scan"):
        raise ValueError(f"factored_segmode {mode!r}: expected single | scan")

    nzv_arr, ivc, vc = _generate_triples(cls)
    rows_i = np.repeat(np.arange(n, dtype=np.int64), nzv_arr)
    pos_j = ivc - 1
    v_ip, v_ix, v_v = coo_to_csr_arrays(rows_i, pos_j, vc, (n, n), sum_duplicates=False)
    t_ip, t_ix, t_v = coo_to_csr_arrays(pos_j, rows_i, vc, (n, n), sum_duplicates=False)
    if mode == "scan":
        squant = conf.seg_quantile
        V = csr_to_seg_ell_scan(
            v_ip, v_ix, to_vals(v_v), (n, n), seg_size=SEG_SIZE, seg_quantile=squant
        )
        VT = csr_to_seg_ell_scan(
            t_ip, t_ix, to_vals(t_v), (n, n), seg_size=SEG_SIZE, seg_quantile=squant
        )
    else:
        seg = max(SEG_SIZE, n)
        V = csr_to_seg_bucket_ell(v_ip, v_ix, to_vals(v_v), (n, n), seg_size=seg)
        VT = csr_to_seg_bucket_ell(t_ip, t_ix, to_vals(t_v), (n, n), seg_size=seg)

    ratio = cls.rcond ** (1.0 / n)
    s = np.empty(n, dtype=np.float64)
    s[0] = 1.0
    np.multiply.accumulate(np.full(n - 1, ratio), out=s[1:])
    d0 = cls.rcond - cls.shift

    nnz_eff = int(nzv_arr.sum()) * 2
    cont = FactoredNPB(V=V, VT=VT, s=to_dev(s), d0=to_dev(np.asarray(d0)))
    return cont, nnz_eff


# ---------------------------------------------------------------------------
# matvec implementations
# ---------------------------------------------------------------------------


def _spmv_any(A, x):
    from lilac.kernels.xla import seg_bucket_ell_spmv, seg_ell_scan_spmv

    if isinstance(A, SegELLScan):
        return seg_ell_scan_spmv(A, x)
    return seg_bucket_ell_spmv(A, x)


def _spmv_any_df(A, x):
    from lilac.kernels.xla import seg_bucket_ell_spmv_df, seg_ell_scan_spmv_df

    if isinstance(A, SegELLScan):
        return seg_ell_scan_spmv_df(A, x)
    return seg_bucket_ell_spmv_df(A, x)


def factored_spmv(A: FactoredNPB, x: jax.Array) -> jax.Array:
    """Plain-float factored product (f32/f64)."""
    t = _spmv_any(A.V, x)
    u = A.s * t
    y = _spmv_any(A.VT, u)
    return y + A.d0 * x


def factored_spmv_df(A: FactoredNPB, x: df.DF) -> df.DF:
    """df64 factored product: TwoProd per element, compensated reductions."""
    t = _spmv_any_df(A.V, x)
    s = df.DF(A.s[..., 0], A.s[..., 1])
    u = df.mul(s, t)
    y = _spmv_any_df(A.VT, u)
    d0 = df.DF(A.d0[..., 0], A.d0[..., 1])
    dx = df.mul(df.DF(jnp.broadcast_to(d0.hi, x.hi.shape),
                      jnp.broadcast_to(d0.lo, x.lo.shape)), x)
    return df.add(y, dx)
