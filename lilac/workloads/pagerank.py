"""PageRank power iteration (reference workload parity).

Semantics of /root/reference/pagerank/main.cpp:101-155: the matrix is
column-normalised then pre-scaled by the damping factor d=0.85; each
iteration computes y = (d·M)·x, adds (1−d)·mean(x), and tracks the l2
step difference ||x_new − x||. 1024 iterations per run, 5 timed runs.

The whole iteration loop is one lax.fori_loop inside jit — no
per-iteration host dispatch (the reference pays a dlopen'd function call
per iteration, main.cpp:138).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lilac.plan import SpmvPlan


def normalise_columns(indptr, indices, data, shape):
    """Column-stochastic normalisation (mm::normalise in the reference):
    divide each entry by its column sum; empty columns left untouched."""
    colsum = np.zeros(shape[1], dtype=np.float64)
    np.add.at(colsum, indices, data)
    scale = np.where(colsum != 0.0, 1.0 / np.where(colsum == 0, 1.0, colsum), 1.0)
    return data * scale[indices]


@dataclasses.dataclass
class PageRankResult:
    x: np.ndarray
    error: float
    iters: int
    times_s: list
    nnz: int


def run(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape,
    *,
    d: float = 0.85,
    iters: int = 1024,
    runs: int = 5,
    dtype: str = "f32",
    seed: int = 0,
    x0: Optional[np.ndarray] = None,
    kernel: str = "auto",
    plan: Optional[SpmvPlan] = None,
) -> PageRankResult:
    """plan: optional pre-staged SpmvPlan built from the ALREADY
    column-normalised-and-d-scaled values (normalise_columns · d) — lets
    callers (bench ingest) time the marshalling phase separately."""
    n = shape[0]
    if plan is None:
        scaled = normalise_columns(indptr, indices, data, shape) * d
        plan = SpmvPlan(indptr, indices, scaled, shape, dtype=dtype,
                        kernel=kernel)
    if x0 is None:
        x0 = initial_vector(n, seed)

    @jax.jit
    def run_iters(A, x):
        # A threaded through so jit treats the matrix as an argument
        def body_(i, carry):
            x, _ = carry
            mean = jnp.sum(x) / n
            y = plan.matvec_with(A, x) + (1.0 - d) * mean
            err = jnp.sqrt(jnp.sum((y - x) ** 2))
            return (y, err)
        return jax.lax.fori_loop(0, iters, body_, (x, jnp.asarray(0.0, x.dtype)))

    xd = plan.vec_in(x0)
    xf, err = run_iters(plan.A, xd)
    jax.block_until_ready(xf)

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        xf, err = jax.block_until_ready(run_iters(plan.A, xd))
        times.append(time.perf_counter() - t0)

    return PageRankResult(
        x=plan.vec_out(xf), error=float(err), iters=iters, times_s=times,
        nnz=plan.nnz,
    )


def initial_vector(n: int, seed: int = 0) -> np.ndarray:
    """The random start vector run() uses by default (sums to 1)."""
    x0 = np.random.default_rng(seed).random(n)
    return x0 / x0.sum()


def pagerank_oracle(indptr, indices, data, shape, x0, *, d: float = 0.85,
                    iters: int = 1024) -> np.ndarray:
    """Host f64 replica of run()'s iteration (scipy), for checks:
    x ← (d·M)x + (1−d)·mean(x), M column-normalised."""
    import scipy.sparse as sp

    scaled = normalise_columns(indptr, indices, data, shape) * d
    M = sp.csr_matrix((scaled, indices, indptr), shape=shape)
    x = np.asarray(x0, dtype=np.float64)
    for _ in range(iters):
        x = M @ x + (1.0 - d) * x.mean()
    return x
