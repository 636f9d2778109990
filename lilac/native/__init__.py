"""Native (C) host runtime: sequential generator loops and parsing-bound
loaders, built on first import with the system compiler and loaded through
ctypes (the environment has no pybind11; SURVEY.md's native-layer mandate).

Falls back silently: callers guard with try/except and use the pure-Python
paths (e.g. generate/npb.py:_generate_triples).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "lilac_native.c")
_SO = os.path.join(_HERE, "_lilac_native.so")


def _build() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    cc = os.environ.get("CC", "cc")
    # per-process temp name: concurrent cold imports must not clobber each
    # other's half-written .so before the atomic publish
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


_lib = ctypes.CDLL(_build())

_lib.npb_triples.restype = ctypes.c_long
_lib.npb_triples.argtypes = [
    ctypes.c_long,
    ctypes.c_int,
    np.ctypeslib.ndpointer(np.int32, flags="C"),
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    np.ctypeslib.ndpointer(np.float64, flags="C"),
]

_lib.sb_fill_matrix.restype = ctypes.c_long
_lib.sb_fill_matrix.argtypes = [
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    ctypes.c_long,
    ctypes.c_long,
    ctypes.c_int,
    ctypes.c_uint64,
    ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_long,
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    np.ctypeslib.ndpointer(np.float64, flags="C"),
    np.ctypeslib.ndpointer(np.float64, flags="C"),
]

_lib.mm_parse_body.restype = ctypes.c_long
_lib.mm_parse_body.argtypes = [
    ctypes.c_char_p,
    ctypes.c_long,
    ctypes.c_long,
    ctypes.c_int,
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    np.ctypeslib.ndpointer(np.int64, flags="C"),
    np.ctypeslib.ndpointer(np.float64, flags="C"),
]


def npb_triples(na: int, nonzer: int):
    """C fast path for makea phase 1 (exact randlc stream)."""
    nzv = np.empty(na, dtype=np.int32)
    pos = np.empty(na * (nonzer + 1), dtype=np.int64)
    val = np.empty(na * (nonzer + 1), dtype=np.float64)
    w = _lib.npb_triples(na, nonzer, nzv, pos, val)
    return nzv, pos[:w], val[:w]


def sb_fill_matrix(splits: np.ndarray, n: int, sym: bool, state: int):
    """C fast path for SparseBench gen_crs fill (exact DLARAN stream).

    Returns (rows, cols, vals, diag, new_state); rows/cols 1-based like the
    Python port, diagonal values returned separately (entries 1..n first).
    """
    splits = np.ascontiguousarray(splits, dtype=np.int64)
    cap = 40 * n + 16 * len(splits)  # generous: reference caps at 15n total
    # the C fill bounds-checks against cap and returns -1 on overflow (it
    # never writes past the buffers); retry with a bigger allocation
    for _ in range(4):
        rows = np.empty(cap, dtype=np.int64)
        cols = np.empty(cap, dtype=np.int64)
        vals = np.empty(cap, dtype=np.float64)
        diag = np.zeros(n, dtype=np.float64)
        out_state = ctypes.c_uint64(0)
        top = _lib.sb_fill_matrix(
            splits, len(splits), n, int(sym), state, ctypes.byref(out_state),
            cap, rows, cols, vals, diag,
        )
        if top >= 0:
            return rows[:top], cols[:top], vals[:top], diag, int(out_state.value)
        last_cap = cap
        cap *= 4
    raise MemoryError(
        f"sb_fill_matrix overflow: n={n} needs > {last_cap} entries"
    )


def mm_parse_body(path: str, skip_lines: int, nnz: int, pattern: bool):
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    k = _lib.mm_parse_body(
        path.encode(), skip_lines, nnz, int(pattern), rows, cols, vals
    )
    if k != nnz:
        raise ValueError(f"{path}: parsed {k} of {nnz} entries")
    return rows, cols, vals
