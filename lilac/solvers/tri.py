"""Level-scheduled sparse triangular sweeps (device-side, jit-compatible).

The reference's ILU-D preconditioner applications are inherently sequential
row recurrences (/root/reference/SparseBench/SRC/reference/random.f:148-190,
regular_symm.f:121-311). The answer here (SURVEY.md §7 hard parts) is
LEVEL SCHEDULING: rows are grouped on host by dependency depth in the
triangular pattern; each level is then one vectorized gather/multiply/
scatter step on device. Levels are padded to a uniform shape and the sweep
runs as a single `lax.scan`, so a whole solve is one compact XLA loop
instead of O(n) serial steps (or O(#levels) unrolled ops).

Arithmetic per row is the same set of multiply-adds as the reference
recurrence (order inside a row may differ — f64 reduction reorder only).

Two sweep flavours cover every SparseBench preconditioner:
  forward : t = (D+P)^-1 x      via t_r = dinv_r * (x_r - Σ_c P_rc t_c)
  backward: y = (I+D^-1 P)^-1 t via y_r = t_r - dinv_r * Σ_c P_rc y_c
with P strictly triangular in the sweep's dependency order. M = (D+L)(I+
D^-1 U) then applies as backward(forward(x)) — the reference's ILU-D
(and, with plane-restricted parts, its block-Jacobi).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class LevelSweep:
    """Host-built schedule, ELL-packed per level with uniform padding.

    rows: int32 [nlev, R]   (pad = n, a scratch slot)
    cols: int32 [nlev, R, K] (pad = n)
    vals: f64   [nlev, R, K] (pad = 0)
    Level-0 rows (no stored entries) are handled in the sweep base step.
    """

    n: int
    rows: jnp.ndarray
    cols: jnp.ndarray
    vals: jnp.ndarray

    @staticmethod
    def build(indptr, indices, data, n: int) -> "LevelSweep":
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        data = np.asarray(data, dtype=np.float64)
        counts = np.diff(indptr)
        level = _longest_path_levels(indptr, indices, n)
        nlev = int(level.max()) if n else 0

        if nlev == 0:
            rows = np.full((0, 1), n, dtype=np.int64)
            cols = np.full((0, 1, 1), n, dtype=np.int64)
            vals = np.zeros((0, 1, 1), dtype=np.float64)
        else:
            order = np.argsort(level, kind="stable")
            order = order[level[order] >= 1]
            lv_sizes = np.bincount(level[level >= 1] - 1, minlength=nlev)
            R = int(lv_sizes.max())
            K = int(counts.max()) if len(counts) else 1
            rows = np.full((nlev, R), n, dtype=np.int64)
            cols = np.full((nlev, R, K), n, dtype=np.int64)
            vals = np.zeros((nlev, R, K), dtype=np.float64)
            pos = np.zeros(nlev, dtype=np.int64)
            for r in order:
                k = level[r] - 1
                i = pos[k]
                pos[k] = i + 1
                lo, hi = indptr[r], indptr[r + 1]
                rows[k, i] = r
                cols[k, i, : hi - lo] = indices[lo:hi]
                vals[k, i, : hi - lo] = data[lo:hi]
        return LevelSweep(
            n=n,
            rows=jnp.asarray(rows, dtype=jnp.int32),
            cols=jnp.asarray(cols, dtype=jnp.int32),
            vals=jnp.asarray(vals),
        )

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, flat):
        return cls(aux[0], *flat)


jax.tree_util.register_pytree_node(
    LevelSweep, LevelSweep.tree_flatten, LevelSweep.tree_unflatten
)


def _longest_path_levels(indptr, indices, n):
    """level[r] = longest dependency chain ending at r (0 for no deps).

    Kahn-style frontier propagation over the reverse adjacency — O(nnz),
    vectorized per frontier. Raises on cyclic (non-triangular) patterns.
    """
    counts = np.diff(indptr).astype(np.int64)
    dep_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    order = np.argsort(indices, kind="stable")
    rev_targets = dep_rows[order]
    rev_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rev_ptr, indices + 1, 1)
    np.cumsum(rev_ptr, out=rev_ptr)

    level = np.zeros(n, dtype=np.int64)
    pending = counts.copy()
    frontier = np.nonzero(pending == 0)[0]
    resolved = len(frontier)
    while frontier.size:
        # all rows referencing a frontier column
        segs = [rev_targets[rev_ptr[c] : rev_ptr[c + 1]] for c in frontier]
        if not segs:
            break
        touched = np.concatenate(segs) if segs else np.empty(0, np.int64)
        if touched.size == 0:
            break
        src_lv = np.concatenate(
            [
                np.full(rev_ptr[c + 1] - rev_ptr[c], level[c] + 1)
                for c in frontier
            ]
        )
        np.maximum.at(level, touched, src_lv)
        np.subtract.at(pending, touched, 1)
        newly = np.unique(touched[pending[touched] == 0])
        frontier = newly
        resolved += len(newly)
    if resolved != n:
        raise ValueError("cyclic pattern: not triangular in any order")
    return level


def _scan_sweep(sweep: LevelSweep, dinv, x, base, update):
    """Run levels as one lax.scan over a padded scratch slot n."""
    n = sweep.n
    tp = jnp.concatenate([base, jnp.zeros(1, base.dtype)])
    xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
    dp = jnp.concatenate([dinv, jnp.ones(1, dinv.dtype)])

    def step(t, lv):
        rows, cols, vals = lv
        contrib = jnp.sum(vals * t[cols], axis=1)
        t = t.at[rows].set(update(xp[rows], dp[rows], contrib))
        return t, None

    t, _ = jax.lax.scan(step, tp, (sweep.rows, sweep.cols, sweep.vals))
    return t[:n]


def sweep_forward(sweep: LevelSweep, dinv: jnp.ndarray, x: jnp.ndarray):
    """t = (D+P)^-1 x."""
    return _scan_sweep(
        sweep, dinv, x, dinv * x, lambda xr, dr, c: dr * (xr - c)
    )


def sweep_backward(sweep: LevelSweep, dinv: jnp.ndarray, t: jnp.ndarray):
    """y = (I + D^-1 P)^-1 t."""
    return _scan_sweep(sweep, dinv, t, t, lambda tr, dr, c: tr - dr * c)


def make_ilu_d(dinv, L: LevelSweep, U: LevelSweep):
    """M^-1 application for SparseBench's ILU-D: M = (D+L) D^-1 (D+U)
    (random.f:148-190; block-Jacobi is the same with plane-restricted
    parts, regular.f:568-633)."""

    def psolve(x):
        t = sweep_forward(L, dinv, x)
        return sweep_backward(U, dinv, t)

    return psolve
