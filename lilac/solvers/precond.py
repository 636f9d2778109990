"""Preconditioners: Jacobi, block-Jacobi, ILU(0) with level scheduling.

Reference semantics: SparseBench preconditioner menu
(/root/reference/SparseBench/SRC/reference/iter.f:311-376) — 1=Jacobi
(pointwise multiply by inverse diagonal), 2=ILU, 3=block-Jacobi,
4=line-ILU. ILU triangular solves are inherently sequential
(random.f/regular.f ilusolve routines); the answer here (SURVEY.md
section 7 hard parts) is LEVEL SCHEDULING: rows grouped by dependency
depth on host, each level solved as one vectorized gather/multiply/
scatter step, giving O(#levels) device steps instead of O(n).

Factorization runs on host in numpy (plan-build time, like the rest of
the staging pipeline); solves are jit-compatible device functions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Jacobi
# ---------------------------------------------------------------------------


def jacobi_inverse_diagonal(indptr, indices, data, shape) -> np.ndarray:
    """m = 1/diag(A) (SparseBench stores this vector as the Jacobi
    preconditioner and applies it with a pointwise multiply)."""
    n = shape[0]
    diag = np.zeros(n, dtype=np.float64)
    for_rows = np.repeat(np.arange(n), np.diff(indptr))
    mask = for_rows == indices
    diag[for_rows[mask]] = data[mask]
    if np.any(diag == 0.0):
        raise ValueError("zero diagonal; Jacobi preconditioner undefined")
    return 1.0 / diag


# ---------------------------------------------------------------------------
# ILU(0) — host factorization
# ---------------------------------------------------------------------------


def ilu0_factor(indptr, indices, data, shape):
    """In-place ILU(0): L (unit lower) and U share A's sparsity pattern.

    Standard IKJ algorithm restricted to the pattern — the same math the
    reference's crs ILU produces. Returns the combined factor values
    aligned with (indptr, indices) plus the diagonal positions.
    """
    n = shape[0]
    vals = data.astype(np.float64).copy()
    # position lookup per row: dict-free via sorted indices + searchsorted
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = slice(indptr[i], indptr[i + 1])
        cols = indices[row]
        dp = np.searchsorted(cols, i)
        if dp >= len(cols) or cols[dp] != i:
            raise ValueError(f"missing diagonal in row {i}")
        diag_pos[i] = indptr[i] + dp
    for i in range(1, n):
        r0, r1 = indptr[i], indptr[i + 1]
        cols_i = indices[r0:r1]
        for kk in range(r0, r1):
            k = indices[kk]
            if k >= i:
                break
            piv = vals[diag_pos[k]]
            lik = vals[kk] / piv
            vals[kk] = lik
            # subtract lik * U[k, j] for j in row i's pattern, j > k
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks >= ke:
                continue
            cols_k = indices[ks:ke]
            pos = np.searchsorted(cols_i, cols_k)
            valid = (pos < len(cols_i)) & (cols_i[np.minimum(pos, len(cols_i) - 1)] == cols_k)
            vals[r0 + pos[valid]] -= lik * vals[ks:ke][valid]
    return vals, diag_pos


def _level_schedule(indptr, indices, n, lower: bool) -> np.ndarray:
    """Dependency depth of each row for the triangular solve."""
    level = np.zeros(n, dtype=np.int64)
    if lower:
        order = range(n)
    else:
        order = range(n - 1, -1, -1)
    for i in order:
        lv = 0
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if (lower and j < i) or ((not lower) and j > i):
                lv = max(lv, level[j] + 1)
        level[i] = lv
    return level


@dataclasses.dataclass
class ILU0:
    """Device-side ILU(0) apply via level-scheduled sweeps.

    solve(y) computes (LU)^-1 y with one fori_loop over levels; each level
    applies a masked SpMV-style update. Transpose solve supported for BiCG.
    """

    # combined factor in CSR (device)
    data: jax.Array
    indices: jax.Array
    row_ids: jax.Array
    diag: jax.Array  # U diagonal values [n]
    lower_level: jax.Array  # [n] level of each row in L-solve
    upper_level: jax.Array
    lower_level_t: jax.Array  # levels for the transpose solves
    upper_level_t: jax.Array
    n_lower_levels: int
    n_upper_levels: int
    n_lower_levels_t: int
    n_upper_levels_t: int
    shape: Tuple[int, int]

    @staticmethod
    def build(indptr, indices, data, shape) -> "ILU0":
        vals, diag_pos = ilu0_factor(indptr, indices, data, shape)
        n = shape[0]
        lo = _level_schedule(indptr, indices, n, lower=True)
        up = _level_schedule(indptr, indices, n, lower=False)
        # transpose pattern for the shadow (BiCG) solves
        counts = np.diff(indptr)
        rid = np.repeat(np.arange(n, dtype=np.int64), counts)
        order = np.lexsort((rid, indices))
        t_rows = indices[order].astype(np.int64)
        t_cols = rid[order]
        t_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(t_indptr, t_rows + 1, 1)
        np.cumsum(t_indptr, out=t_indptr)
        lo_t = _level_schedule(t_indptr, t_cols, n, lower=False)
        up_t = _level_schedule(t_indptr, t_cols, n, lower=True)
        return ILU0(
            data=jnp.asarray(vals),
            indices=jnp.asarray(indices, jnp.int32),
            row_ids=jnp.asarray(rid, jnp.int32),
            diag=jnp.asarray(vals[diag_pos]),
            lower_level=jnp.asarray(lo, jnp.int32),
            upper_level=jnp.asarray(up, jnp.int32),
            lower_level_t=jnp.asarray(lo_t, jnp.int32),
            upper_level_t=jnp.asarray(up_t, jnp.int32),
            n_lower_levels=int(lo.max()) + 1,
            n_upper_levels=int(up.max()) + 1,
            n_lower_levels_t=int(lo_t.max()) + 1,
            n_upper_levels_t=int(up_t.max()) + 1,
            shape=tuple(shape),
        )

    def solve(self, y):
        """x = U^-1 L^-1 y (forward then backward level sweeps)."""
        n = self.shape[0]
        rid, cid, v = self.row_ids, self.indices, self.data
        strict_lower = cid < rid
        strict_upper = cid > rid

        def sweep(x, levels, nlev, mask, diag_scale):
            def body(lv, x):
                active = levels[rid] == lv
                contrib = jnp.where(mask & active, v * x[cid], 0.0)
                s = jax.ops.segment_sum(contrib, rid, num_segments=n,
                                        indices_are_sorted=True)
                row_active = levels == lv
                newx = (x - s) if diag_scale is None else (x - s) / self.diag
                return jnp.where(row_active, newx, x)

            return jax.lax.fori_loop(0, nlev, body, x)

        # L-solve: x_i = y_i - sum_{j<i} L_ij x_j (unit diagonal)
        x = sweep(y, self.lower_level, self.n_lower_levels, strict_lower, None)
        # U-solve: x_i = (x_i - sum_{j>i} U_ij x_j) / U_ii
        x = sweep(x, self.upper_level, self.n_upper_levels, strict_upper, 1)
        return x

    def solve_t(self, y):
        """x = L^-T U^-T y for the BiCG shadow solve."""
        n = self.shape[0]
        rid, cid, v = self.row_ids, self.indices, self.data
        # U^T is lower triangular with levels = upper levels of columns...
        # transpose solves need column-major sweeps: x_j updated by U_ij x_i.
        # Implement by scatter: for level lv of the *column* ordering.
        strict_upper = cid > rid
        strict_lower = cid < rid

        # U^T solve: iterate rows of U^T = columns of U, in increasing
        # column level order derived from the transpose dependency graph.
        def sweep_t(x, levels_cols, nlev, mask, diag):
            def body(lv, x):
                # divide newly-ready entries by diag first (for U^T)
                if diag is not None:
                    x = jnp.where(levels_cols == lv, x / self.diag, x)
                active = levels_cols[rid] == lv
                contrib = jnp.where(mask & active, v * x[rid], 0.0)
                upd = jnp.zeros(n, x.dtype).at[cid].add(
                    jnp.where(mask & active, contrib, 0.0)
                )
                return x - upd

            return jax.lax.fori_loop(0, nlev, body, x)

        x = sweep_t(y, self.upper_level_t, self.n_upper_levels_t, strict_upper, 1)
        x = sweep_t(x, self.lower_level_t, self.n_lower_levels_t, strict_lower, None)
        return x
