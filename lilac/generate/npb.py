"""NPB CG test-matrix generator (host-side, numpy).

Reproduces the NAS CG `makea` problem generator exactly enough for the ζ
verification (rel. err <= 1e-10, /root/reference/NPB3.3.1/CG/cg.f:363-368):

* `randlc` — the NPB 2^46 multiplicative LCG x_{k+1} = a·x_k mod 2^46 with
  a = 5^13 = 1220703125 (/root/reference/NPB3.3.1/common/randi8.f:1-35),
  reproduced bit-exactly in integer arithmetic (low 46 bits of a 64-bit
  wraparound product are exact).
* `sprnvc`/`vecset`/`icnvrt` semantics — rejection-sampled sparse random
  vectors with duplicate suppression (cg.f:911-989); icnvrt's float chop is
  an exact power-of-two shift, reproduced as `Lx >> (46 - log2(nn1))`.
* `sparse` assembly — A = Σ_i size_i · v_i v_iᵀ + (rcond − shift)·I with
  duplicates summed (cg.f:740-905). The reference sums duplicates in
  insertion order; we sum in lexicographic order, which perturbs entries by
  O(eps) — far inside the 1e-10 ζ tolerance. The geometric `size` ramp uses
  a sequential cumulative product to match the Fortran multiply chain
  (cg.f:830, `size = size * ratio`).

Generation is sequential by nature (the LCG stream's consumption is
data-dependent), so it runs on host and is cached to disk — the analogue of
SparseBench's save-generated-matrix discipline (SparseBench/README:38-42).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

_MASK46 = (1 << 46) - 1
AMULT = 1220703125  # 5^13, cg.f:187
TRAN0 = 314159265  # cg.f:186


@dataclasses.dataclass(frozen=True)
class NPBClass:
    name: str
    na: int
    nonzer: int
    niter: int
    shift: float
    zeta_verify: float
    rcond: float = 0.1


# Class table from cg.f:122-163
CLASSES: Dict[str, NPBClass] = {
    c.name: c
    for c in [
        NPBClass("S", 1400, 7, 15, 10.0, 8.5971775078648),
        NPBClass("W", 7000, 8, 15, 12.0, 10.362595087124),
        NPBClass("A", 14000, 11, 15, 20.0, 17.130235054029),
        NPBClass("B", 75000, 13, 75, 60.0, 22.712745482631),
        NPBClass("C", 150000, 15, 75, 110.0, 28.973605592845),
        NPBClass("D", 1500000, 21, 100, 500.0, 52.514532105794),
        NPBClass("E", 9000000, 26, 100, 1.5e3, 77.522164599383),
    ]
}


class Randlc:
    """Bit-exact NPB LCG. State is the 46-bit integer seed."""

    def __init__(self, seed: int = TRAN0, a: int = AMULT):
        self.x = int(seed)
        self.a = int(a)

    def next(self) -> float:
        self.x = (self.x * self.a) & _MASK46
        return self.x * 0.5**46

    def next_int(self) -> int:
        """Advance and return the raw 46-bit state."""
        self.x = (self.x * self.a) & _MASK46
        return self.x

    def stream_ints(self, n: int) -> np.ndarray:
        """Vectorized batch of n raw states (advances the generator by n).

        Uses uint64 wraparound; low 46 bits of each product are exact.
        """
        out = np.empty(n, dtype=np.uint64)
        x, a = np.uint64(self.x), np.uint64(self.a)
        with np.errstate(over="ignore"):
            for i in range(n):
                x = (x * a) & np.uint64(_MASK46)
                out[i] = x
        self.x = int(out[-1]) if n else self.x
        return out


def _generate_triples(cls: NPBClass):
    """Phase 1 of makea (cg.f:707-720): per-row sparse random vectors.

    Returns (nzv, ivc, vc): row-length array [na], and flattened 1-based
    positions / values.
    """
    try:
        from lilac.native import npb_triples  # C fast path

        return npb_triples(cls.na, cls.nonzer)
    except Exception:
        pass
    return _generate_triples_py(cls.na, cls.nonzer)


def _generate_triples_py(na: int, nonzer: int):
    n = na
    nn1 = 1
    while nn1 < n:
        nn1 *= 2
    shift_bits = 46 - (nn1.bit_length() - 1)

    rng_x = TRAN0
    # zeta = randlc(tran, amult) consumed once before makea (cg.f:188)
    rng_x = (rng_x * AMULT) & _MASK46

    nzv_arr = np.empty(n, dtype=np.int32)
    ivc_all = np.empty(n * (nonzer + 1), dtype=np.int64)
    vc_all = np.empty(n * (nonzer + 1), dtype=np.float64)
    w = 0
    d2m46 = 0.5**46
    a = AMULT
    mask = _MASK46
    for iouter in range(1, n + 1):
        # sprnvc: draw `nonzer` distinct positions in [1, n]
        pos = []
        vals = []
        while len(pos) < nonzer:
            rng_x = (rng_x * a) & mask
            vecelt = rng_x * d2m46
            rng_x = (rng_x * a) & mask
            i = (rng_x >> shift_bits) + 1
            if i > n or i in pos:
                continue
            pos.append(i)
            vals.append(vecelt)
        # vecset: force position iouter with value 0.5 (cg.f:718)
        try:
            k = pos.index(iouter)
            vals[k] = 0.5
            nzv = nonzer
        except ValueError:
            pos.append(iouter)
            vals.append(0.5)
            nzv = nonzer + 1
        nzv_arr[iouter - 1] = nzv
        ivc_all[w : w + nzv] = pos
        vc_all[w : w + nzv] = vals
        w += nzv
    return nzv_arr, ivc_all[:w], vc_all[:w]


def make_cg_matrix(
    class_name: str, cache_dir: str | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, NPBClass]:
    """Generate the NPB CG matrix for a class.

    Returns 0-based canonical CSR (indptr, indices, data) in float64 plus the
    class record. Results are cached on disk (generation is one-time host
    work, like the reference's saved crsmat files).
    """
    cls = CLASSES[class_name.upper()]
    if cache_dir is None:
        from lilac.config import cfg

        cache_dir = cfg().resolved_data_dir()
    cache_dir = os.path.abspath(cache_dir)
    path = os.path.join(cache_dir, f"npb_cg_{cls.name}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["indptr"], z["indices"], z["data"], cls

    nzv_arr, ivc, vc = _generate_triples(cls)
    n = cls.na

    # sparse assembly (cg.f:740-905): A = sum_i size_i v_i v_i^T, dup-summed,
    # + (rcond - shift) on the diagonal.
    ratio = cls.rcond ** (1.0 / n)
    size = np.empty(n, dtype=np.float64)
    size[0] = 1.0
    np.multiply.accumulate(np.full(n - 1, ratio), out=size[1:])
    # grouping rows by nzv lets the outer products vectorize as dense batches
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nzv_arr, out=offsets[1:])
    rows_list, cols_list, vals_list = [], [], []
    for k in np.unique(nzv_arr):
        sel = np.nonzero(nzv_arr == k)[0]
        if not len(sel):
            continue
        gather = offsets[sel][:, None] + np.arange(k)[None, :]
        P = ivc[gather]  # [m, k] positions (1-based)
        V = vc[gather]  # [m, k] values
        S = size[sel]  # [m]
        outer = S[:, None, None] * V[:, :, None] * V[:, None, :]
        r = np.broadcast_to(P[:, :, None], outer.shape)
        c = np.broadcast_to(P[:, None, :], outer.shape)
        rows_list.append(r.ravel())
        cols_list.append(c.ravel())
        vals_list.append(outer.ravel())
    diag = np.arange(1, n + 1, dtype=np.int64)
    rows_list.append(diag)
    cols_list.append(diag)
    vals_list.append(np.full(n, cls.rcond - cls.shift))

    row = np.concatenate(rows_list) - 1  # to 0-based
    col = np.concatenate(cols_list) - 1
    val = np.concatenate(vals_list)

    from lilac.formats.convert import coo_to_csr_arrays

    indptr, indices, data = coo_to_csr_arrays(row, col, val, (n, n))

    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, indptr=indptr, indices=indices, data=data)
    return indptr, indices, data, cls
