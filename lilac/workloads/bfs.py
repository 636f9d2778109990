"""Linear-algebra BFS as masked SpMV (reference workload parity).

Semantics of /root/reference/bfs/bfs.cc:36-68 (Yang/Buluç style): the
frontier advances as `front = (M·front ≠ 0) & unvisited`, with `distances`
doubling as the visited set — distances[source]=1 and newly reached nodes
at sweep i get distance i+1. The reference's 2-based colidx quirk
(library.cc:74, SURVEY.md section 3.5) is NOT reproduced: we implement the
clean 0-based semantics of the cited algorithm.

Levels run in a lax.while_loop over dense {0,1} f32 frontier
vectors; SpMV + mask fuse in XLA. 16 random sources per benchmark run
(bfs.cc:85-90).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from lilac.plan import SpmvPlan


def bfs_distances(plan: SpmvPlan, source: int) -> np.ndarray:
    """Distances per the reference convention: source=1, neighbours=2, ...
    unreachable=0."""
    run = _bfs_runner(plan)
    return np.asarray(run(plan.A, jnp.int32(source)))


def _bfs_runner(plan: SpmvPlan):
    """One compiled BFS program per plan, reused across sources (a fresh
    closure per call would re-trace and re-compile every time — measured
    as 16 compiles dominating the 16-source benchmark)."""
    cached = getattr(plan, "_bfs_run", None)
    if cached is not None:
        return cached
    n = plan.shape[0]

    @jax.jit
    def run(A, src):
        front = jnp.zeros(n, jnp.float32).at[src].set(1.0)
        dist = jnp.zeros(n, jnp.float32).at[src].set(1.0)

        def cond(state):
            front, dist, i, cont = state
            return cont

        def body(state):
            front, dist, i, _ = state
            nxt = plan.matvec_with(A, front)
            one = jnp.float32(1.0)
            front = jnp.where((nxt != 0.0) & (dist == 0.0), one, jnp.float32(0.0))
            dist = jnp.where(front != 0.0, i + one, dist)
            return (front, dist, i + one, jnp.any(front != 0.0))

        front, dist, i, _ = jax.lax.while_loop(
            cond, body, (front, dist, jnp.float32(1.0), jnp.bool_(True))
        )
        return dist

    plan._bfs_run = run
    return run


@dataclasses.dataclass
class BFSResult:
    time_s: float
    runs: int
    n: int
    nnz: int


def run_benchmark(
    indptr, indices, data, shape, *, runs: int = 16, seed: int = 0,
    kernel: str = "auto",
) -> BFSResult:
    """16 random-source BFS runs, wall-clock timed (bfs.cc:80-95)."""
    data = np.ones_like(data)  # BFS is pattern-only (values all 1.0)
    plan = SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel=kernel)
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, shape[0], size=runs)
    bfs_distances(plan, int(sources[0]))  # compile warm-up
    t0 = time.perf_counter()
    for s in sources:
        bfs_distances(plan, int(s))
    return BFSResult(
        time_s=time.perf_counter() - t0, runs=runs, n=shape[0], nnz=plan.nnz
    )


def bfs_oracle(indptr, indices, data, shape, source) -> np.ndarray:
    """Host oracle replicating the masked-SpMV semantics exactly
    (front = (M·front != 0) & unvisited) with scipy, for tests."""
    import scipy.sparse as sp

    M = sp.csr_matrix((np.ones_like(data), indices, indptr), shape=shape)
    n = shape[0]
    dist = np.zeros(n)
    dist[source] = 1.0
    front = np.zeros(n)
    front[source] = 1.0
    level = 1.0
    while True:
        nxt = M @ front
        front = ((nxt != 0.0) & (dist == 0.0)).astype(np.float64)
        if not front.any():
            return dist
        level += 1.0
        dist[front != 0.0] = level
