"""Benchmark driver + analysis — the run_all/results pipeline.

The reference orchestrates bash `run_all` scripts that run each workload 5
times per (platform, impl, size) and append CSV rows
`platform,bench,impl,size,t1..t5` (/root/reference/NPB3.3.1/run_all:31-38,
results/ics/all.csv), then a pandas pipeline melts and geomeans them
(results/ics/tidy.py:6-17, analysis.py:7-27). This module is the
equivalent here: a Python runner with the same CSV schema and a numpy tidy/
geomean analysis (the runtime image carries no pandas).

CLI:  python -m lilac.bench run --bench npb --size S --impl xla_ell --runs 5
      python -m lilac.bench analyze all.csv --baseline xla_ell
"""

from __future__ import annotations

import csv
import dataclasses
import io
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

CSV_FIELDS = ["platform", "bench", "impl", "size"]  # + t1..tN


@dataclasses.dataclass
class BenchRow:
    platform: str
    bench: str
    impl: str
    size: str
    times: List[float]

    def csv(self) -> List[str]:
        return [self.platform, self.bench, self.impl, self.size] + [
            f"{t:.6f}" for t in self.times
        ]


# ---------------------------------------------------------------------------
# benchmark registry: each entry returns seconds for one run
# ---------------------------------------------------------------------------


def _run_npb(size: str, impl: str) -> float:
    from lilac.workloads import npb_cg

    from lilac.config import cfg

    kernel = "factored" if impl in ("factored", "auto") else impl
    r = npb_cg.run(size, dtype=cfg().bench_dtype, kernel=kernel)
    if not r.verified and r.rel_err > 1e-8:
        raise RuntimeError(f"NPB {size} failed verification: {r.rel_err}")
    return r.time_s


def _run_sparsebench(size: str, impl: str) -> float:
    from lilac.workloads import sparsebench

    if int(size) >= 40:  # timed benchmark protocol (run_all sizes 40-160)
        r = sparsebench.benchmark(int(size), kernel=impl if impl != "auto" else "auto")
        return r.time_s
    r = sparsebench.run_case("s", int(size), 2, 0)
    return r.time_s


def _run_pagerank(size: str, impl: str) -> float:
    from lilac.generate.random_crs import random_crs
    from lilac.workloads import pagerank

    indptr, indices, data, shape = random_crs(int(size), seed=1)
    r = pagerank.run(indptr, indices, data, shape, runs=1)
    return float(np.median(r.times_s))


def _run_pathsample(size: str, impl: str) -> float:
    from lilac.workloads import pathsample as ps

    db = ps.synthetic_landscape(nmin=int(size), nts=4 * int(size), seed=0)
    r = ps.pfold(db, temperature=0.05, npfold=10000)
    return r.time_s


def _run_parboil_spmv(size: str, impl: str) -> float:
    from lilac.workloads import parboil_spmv as pv

    r = pv.run_dataset(size, "/root/reference/parboil", kernel=impl if impl != "auto" else "auto")
    if r.matched is False:
        raise RuntimeError("parboil output mismatch")
    return r.time_s


def _run_sgemm(size: str, impl: str) -> float:
    from lilac.workloads import sgemm

    n = int(size)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)).astype(np.float32)
    BT = rng.normal(size=(n, n)).astype(np.float32)
    _, res = sgemm.run_arrays(A, BT, precision="highest" if impl == "auto" else impl)
    return res.time_s


BENCHES: Dict[str, Callable[[str, str], float]] = {
    "npb": _run_npb,
    "sparsebench": _run_sparsebench,
    "pagerank": _run_pagerank,
    "pathsample": _run_pathsample,
    "parboil-spmv": _run_parboil_spmv,
    "sgemm": _run_sgemm,
}


def run_bench(
    bench: str, size: str, impl: str = "auto", *, platform: Optional[str] = None,
    runs: int = 5,
) -> BenchRow:
    """platform: the CSV label; None = the device the run is on
    (jax.devices()[0].platform)."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    fn = BENCHES[bench]
    times = [fn(size, impl) for _ in range(runs)]
    return BenchRow(platform, bench, impl, size, times)


def append_rows(path: str, rows: Sequence[BenchRow]) -> None:
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(r.csv())


# ---------------------------------------------------------------------------
# analysis (tidy.py + analysis.py semantics, numpy-only)
# ---------------------------------------------------------------------------


def tidy(csv_path: str) -> List[dict]:
    """Melt t1..tN columns into long form (results/ics/tidy.py:6-17)."""
    out = []
    for row in csv.reader(open(csv_path)):
        if not row:
            continue
        platform, bench, impl, size = row[:4]
        for i, t in enumerate(row[4:], 1):
            out.append(
                dict(
                    platform=platform,
                    bench=bench,
                    impl=impl,
                    size=size,
                    run=i,
                    time=float(t),
                )
            )
    return out


def geomean_speedups(records: List[dict], baseline: str) -> Dict[tuple, float]:
    """Per (platform, bench, impl): geometric-mean speedup vs `baseline`
    over matching sizes, using each group's min-over-runs time
    (results/ics/analysis.py:7-27)."""
    best: Dict[tuple, float] = {}
    for r in records:
        key = (r["platform"], r["bench"], r["impl"], r["size"])
        best[key] = min(best.get(key, np.inf), r["time"])
    out: Dict[tuple, List[float]] = {}
    for (plat, bench, impl, size), t in best.items():
        base = best.get((plat, bench, baseline, size))
        if base is None or impl == baseline:
            continue
        out.setdefault((plat, bench, impl), []).append(base / t)
    return {
        k: float(np.exp(np.mean(np.log(np.asarray(v))))) for k, v in out.items() if v
    }
