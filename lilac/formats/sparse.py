"""Sparse matrix containers as JAX pytrees.

All formats use canonical 0-based indexing (the reference suite's libspmv ABI
is 1-based Fortran CSR, /root/reference/libspmv/native-impl.c:1-12; I/O
converters normalise to 0-based on load). Containers are frozen dataclasses
registered as pytrees so they pass through jit/shard_map/scan transparently;
`shape` is static metadata.

Values may be stored in any float dtype; the double-word (df64) value
policy stores values as a trailing [..., 2] (hi, lo) float32 axis (see
lilac.ops.dfloat).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@partial(_register, data_fields=("row", "col", "data"), meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format: (row[i], col[i]) -> data[i]."""

    row: jax.Array  # [nnz] int32
    col: jax.Array  # [nnz] int32
    data: jax.Array  # [nnz] float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.data.dtype)
        return out.at[self.row, self.col].add(self.data)


@partial(
    _register,
    data_fields=("data", "indices", "indptr", "row_ids"),
    meta_fields=("shape",),
)
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row.

    `row_ids` is an optional precomputed [nnz] row-index expansion of indptr
    (the segment ids for segment-sum SpMV); None until `with_row_ids()`.
    """

    data: jax.Array  # [nnz] float (or [nnz, 2] df64)
    indices: jax.Array  # [nnz] int32 column indices
    indptr: jax.Array  # [nrows + 1] int32
    shape: Tuple[int, int]
    row_ids: jax.Array | None = None

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def with_row_ids(self) -> "CSR":
        if self.row_ids is not None:
            return self
        counts = np.diff(np.asarray(self.indptr))
        rid = np.repeat(np.arange(self.shape[0], dtype=np.int32), counts)
        return dataclasses.replace(self, row_ids=jnp.asarray(rid))

    def todense(self) -> jax.Array:
        me = self.with_row_ids()
        out = jnp.zeros(self.shape, self.data.dtype)
        return out.at[me.row_ids, me.indices].add(me.data)


@partial(_register, data_fields=("data", "indices"), meta_fields=("shape",))
@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to a fixed number of slots K.

    Padding slots carry index 0 and value 0 so a gather-multiply-reduce over
    the K axis is exact without masking. Rows may themselves be padded up to
    a multiple of 8; `shape` records the logical (unpadded) matrix shape.
    """

    data: jax.Array  # [nrows_pad, K] float
    indices: jax.Array  # [nrows_pad, K] int32
    shape: Tuple[int, int]

    @property
    def nrows_pad(self) -> int:
        return self.indices.shape[0]

    @property
    def slots(self) -> int:
        return self.indices.shape[1]

    def todense(self) -> jax.Array:
        n, m = self.shape
        rid = jnp.broadcast_to(
            jnp.arange(self.nrows_pad, dtype=jnp.int32)[:, None], self.indices.shape
        )
        out = jnp.zeros((self.nrows_pad, m), self.data.dtype)
        out = out.at[rid, self.indices].add(self.data)
        return out[:n]


@partial(
    _register,
    data_fields=("data", "indices", "row_starts", "perm"),
    meta_fields=("shape", "slice_height"),
)
@dataclasses.dataclass(frozen=True)
class SlicedELL:
    """Sliced-ELL / SELL-C: rows sorted by length in slices of fixed height,
    each slice padded only to its own max row length.

    `perm` maps sorted row position -> original row id. `row_starts` gives the
    flattened slot offset of each slice. Used when row-length variance makes
    plain ELL padding wasteful (e.g. power-law graphs).
    """

    data: jax.Array  # [total_slots] float
    indices: jax.Array  # [total_slots] int32
    row_starts: jax.Array  # [num_slices + 1] int32 (slot offsets)
    perm: jax.Array  # [nrows_pad] int32
    shape: Tuple[int, int]
    slice_height: int


@partial(
    _register,
    data_fields=("data", "indices", "indptr"),
    meta_fields=("shape", "block_shape"),
)
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row: CSR over dense (bh, bw) blocks.

    Each block multiply is a small dense matmul: only one gather per block
    (of a bw-wide x segment) instead of one per entry.
    """

    data: jax.Array  # [nblocks, bh, bw] float
    indices: jax.Array  # [nblocks] int32 (block-column ids)
    indptr: jax.Array  # [nblockrows + 1] int32
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return self.indices.shape[0]

    def todense(self) -> jax.Array:
        bh, bw = self.block_shape
        n, m = self.shape
        nbr = len(self.indptr) - 1
        counts = np.diff(np.asarray(self.indptr))
        brow = np.repeat(np.arange(nbr, dtype=np.int32), counts)
        out = jnp.zeros((nbr * bh, (m + bw - 1) // bw * bw), self.data.dtype)
        for k in range(self.nblocks):  # host-side debug path only
            r0 = int(brow[k]) * bh
            c0 = int(self.indices[k]) * bw
            out = out.at[r0 : r0 + bh, c0 : c0 + bw].add(self.data[k])
        return out[:n, :m]


@partial(
    _register,
    data_fields=("data", "indices", "inv_perm"),
    meta_fields=("shape", "widths"),
)
@dataclasses.dataclass(frozen=True)
class BucketELL:
    """Degree-bucketed ELL: rows permuted ascending by length and split into
    width-quantile buckets, each stored as a dense [n_b, K_b] ELL.

    Beats plain ELL when row lengths are spread (Poisson/power-law): gather
    volume drops from n·K_max to ~n·mean, and every bucket remains a dense
    vectorised gather-reduce (the JDS idea, parboil convert_dataset.c:160+,
    with quantile buckets instead of warps). `inv_perm` maps
    original row -> position in the bucket-concatenated output.
    """

    data: tuple  # per-bucket [n_b, K_b] float (or [.., 2] df)
    indices: tuple  # per-bucket [n_b, K_b] int32
    inv_perm: jax.Array  # [nrows] int32
    shape: Tuple[int, int]
    widths: Tuple[int, ...]


@partial(
    _register,
    data_fields=(
        "main_data",
        "main_indices",
        "tail_data",
        "tail_indices",
        "tail_pos",
    ),
    meta_fields=("shape", "seg_size", "nseg", "width"),
)
@dataclasses.dataclass(frozen=True)
class SegELLScan:
    """Column-segmented ELL with a UNIFORM per-segment width, stacked for
    lax.scan accumulation.

    The scan-shaped twin of SegBucketELL's multi-segment mode: every
    segment stores a w-major [width, n] ELL slab with SEGMENT-LOCAL
    indices (one gather table of seg_size entries per step), all slabs
    stacked on a leading [nseg] axis so the kernel accumulates them with
    one lax.scan — temporaries are bounded by ONE slab instead of one
    unrolled graph part per segment. Slabs are stored w-MAJOR ([w, n]) so
    the long row axis is the minor one.

    Entries beyond `width` in any (row, segment) run spill into a COMPACT
    tail holding only the rows that overflow (global column indices,
    big-table gather, ~the top few percent of entries); `tail_pos[r]`
    maps row r to its tail slot (= m_t for rows without overflow, which
    read a zero pad slot). Row order is identity throughout.
    """

    main_data: jax.Array  # [nseg, width, n] float (or [..., 2] df)
    main_indices: jax.Array  # [nseg, width, n] int32 (segment-local)
    tail_data: jax.Array | None  # [wt, m_t] float (or [..., 2] df)
    tail_indices: jax.Array | None  # [wt, m_t] int32 (GLOBAL)
    tail_pos: jax.Array | None  # [n] int32 (row -> tail slot, m_t = none)
    shape: Tuple[int, int]
    seg_size: int
    nseg: int
    width: int


@partial(
    _register,
    data_fields=("data", "indices", "inv_perm"),
    meta_fields=("shape", "parts", "seg_size", "identity_perm"),
)
@dataclasses.dataclass(frozen=True)
class SegBucketELL:
    """Column-segmented, degree-bucketed ELL.

    The columns are split into segments of `seg_size` (one segment when
    seg_size >= ncols) and each (bucket, segment) pair stores its own ELL
    with SEGMENT-LOCAL indices. One shared row
    permutation (ascending total degree) serves every segment, so the
    output needs a single un-permute.

    parts: static tuple of (bucket_row_lo, bucket_row_hi, segment, width)
    aligned with the data/indices tuples.
    """

    data: tuple  # per-part [n_b, K] float (or [.., 2] df)
    indices: tuple  # per-part [n_b, K] int32 (segment-local)
    inv_perm: jax.Array  # [nrows] int32
    shape: Tuple[int, int]
    parts: tuple
    seg_size: int
    identity_perm: bool = False  # original row order kept (uniform rows)
