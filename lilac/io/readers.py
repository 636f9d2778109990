"""Matrix file I/O — host side.

Covers the reference suite's three on-disk formats:
* Matrix Market coordinate files (parboil's mmio.c + convert_dataset.c
  semantics: 1-based input, symmetric mirroring of off-diagonal entries,
  /root/reference/parboil/benchmarks/spmv/common_src/convert-dataset/
  convert_dataset.c:82-158) — normalised here to 0-based canonical CSR.
* SparseBench CRS text format (`n nnz` header, n+1 pointer lines, nnz
  `(colidx, value)` lines, 1-based; big_gen.py:50-57).
* The BFS edge-list format (header `rows cols nnz`, then 1-based `x y`
  pairs, all values 1.0; bfs/library.cc:169-184). The reference's 2-based
  colidx quirk is not reproduced (SURVEY.md section 3.5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lilac.formats.convert import coo_to_csr_arrays


def read_matrix_market(path: str):
    """Returns (indptr, indices, data, shape), 0-based canonical CSR."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.lower().split()
        fmt, field, symm = parts[2], parts[3], parts[4]
        if fmt != "coordinate":
            raise NotImplementedError("only coordinate MatrixMarket supported")
        skip = 1
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
            skip += 1
        rows, cols, nnz = map(int, line.split())
        skip += 1
        try:  # native C parser (10-30x faster than loadtxt on big files)
            from lilac import native

            r, c, v = native.mm_parse_body(path, skip, nnz, field == "pattern")
            r = r - 1
            c0 = c - 1
            data = None
        except Exception:
            data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
    if data is not None:
        if data.shape[0] != nnz:
            raise ValueError(f"{path}: expected {nnz} entries, got {data.shape[0]}")
        r = data[:, 0].astype(np.int64) - 1
        c0 = data[:, 1].astype(np.int64) - 1
        if field == "pattern":
            v = np.ones(len(r), dtype=np.float64)
        else:
            v = data[:, 2].astype(np.float64)
    c = c0
    if symm in ("symmetric", "skew-symmetric", "hermitian"):
        off = r != c
        sgn = -1.0 if symm == "skew-symmetric" else 1.0
        r, c, v = (
            np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([v, sgn * v[off]]),
        )
    indptr, indices, vals = coo_to_csr_arrays(r, c, v, (rows, cols))
    return indptr, indices, vals, (rows, cols)


def read_sparsebench_crs(path: str):
    """SparseBench on-disk CRS (1-based) -> 0-based canonical CSR.

    Single-pass vectorized parse: the whole file splits into a token
    stream once (C-level), then slices decode header / pointers /
    (colidx, value) pairs — a per-line Python loop on the reference's
    largest size (crsmat170u, n=4.9M, ~25M entries; SparseBench
    README:76) costs minutes, this parses it in seconds."""
    with open(path) as f:
        toks = f.read().split()
    n, nnz = int(toks[0]), int(toks[1])
    if len(toks) != 2 + (n + 1) + 2 * nnz:
        raise ValueError(f"{path}: token count {len(toks)} != header promise")
    ptr = np.asarray(toks[2 : 3 + n], dtype=np.int64)
    idx = np.asarray(toks[3 + n :: 2], dtype=np.int64)
    val = np.asarray(toks[4 + n :: 2], dtype=np.float64)
    # rows from ptr; entries may be unsorted within rows -> canonicalise
    counts = np.diff(ptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    return coo_to_csr_arrays(rows, idx - 1, val, (n, n)) + ((n, n),)


def write_sparsebench_crs(path: str, indptr, indices, data, shape):
    """Write the SparseBench text format (1-based, big_gen.py layout)."""
    n = shape[0]
    nnz = len(indices)
    with open(path, "w") as f:
        f.write(f"{n:12d}{nnz:12d}\n")
        for p in indptr:
            f.write(f"{int(p) + 1:12d}\n")
        for i, v in zip(indices, data):
            f.write(f"{int(i) + 1:12d} {v:20.17f}\n")


def write_matrix_market(path: str, indptr, indices, data, shape,
                        pattern: bool = False):
    """Write coordinate MatrixMarket (1-based, general symmetry) — the
    on-disk form the reference's graph benches ingest (SuiteSparse .mtx,
    bfs/run_all:3). Chunked formatting bounds host memory on 10M+-entry
    writes."""
    n, m = shape
    nnz = len(indices)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts) + 1
    cols = np.asarray(indices, dtype=np.int64) + 1
    with open(path, "w") as f:
        field = "pattern" if pattern else "real"
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{n} {m} {nnz}\n")
        step = 1 << 20
        for i0 in range(0, nnz, step):
            r = rows[i0 : i0 + step]
            c = cols[i0 : i0 + step]
            if pattern:
                chunk = "\n".join(f"{a} {b}" for a, b in zip(r, c))
            else:
                v = np.asarray(data[i0 : i0 + step], dtype=np.float64)
                chunk = "\n".join(
                    f"{a} {b} {x:.17g}" for a, b, x in zip(r, c, v)
                )
            f.write(chunk)
            f.write("\n")


def read_edgelist(path_or_file, zero_based: bool = False):
    """BFS edge-list -> 0-based canonical CSR with unit values."""
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        f = open(path_or_file)
        close = True
    try:
        rows, cols, nnz = map(int, f.readline().split())
        # one C-level token pass (np.loadtxt is a Python per-line loop —
        # minutes on the reference's 10M+-edge graphs, bfs/run_all:3);
        # np.asarray on the token list raises on malformed tokens instead
        # of silently truncating like np.fromstring would
        toks = f.read().split()
        if len(toks) != 2 * nnz:
            raise ValueError(
                f"edge list: {len(toks)} tokens, header promises {2 * nnz}"
            )
        data = np.asarray(toks, dtype=np.int64).reshape(-1, 2)
    finally:
        if close:
            f.close()
    base = 0 if zero_based else 1
    r = data[:, 0] - base
    c = data[:, 1] - base
    v = np.ones(len(r), dtype=np.float64)
    return coo_to_csr_arrays(r, c, v, (rows, cols)) + ((rows, cols),)
