"""Parboil spmv benchmark workload.

Reference semantics (/root/reference/parboil/benchmarks/spmv/src/cpu/
main.c:80-117): load a MatrixMarket matrix (symmetric entries mirrored,
convert_dataset.c:82-112), read the f32 input vector (file.c:57-62), run 50
repetitions of the FLOAT SpMV, and compare the result against the golden
output with parboil's tolerance — abs diff <= 1e-4·max|ref| OR rel < 0.2%
(tools/compare-output:13-35). Golden files: uint32 length + f32 payload
(file.c:64-78).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

REPS = 50  # main.c:93


@dataclasses.dataclass
class ParboilResult:
    rows: int
    nnz: int
    reps: int
    time_s: float
    gflops: float
    matched: Optional[bool]  # None when no golden file
    max_abs_err: Optional[float]


def read_vector_bin(path: str, n: int) -> np.ndarray:
    v = np.fromfile(path, dtype="<f4", count=n)
    if len(v) < n:
        raise ValueError(f"{path}: wanted {n} floats, got {len(v)}")
    return v


def read_golden(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype="<u4", count=1)[0])
        return np.fromfile(f, dtype="<f4", count=n)


def write_output(path: str, y: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.asarray([len(y)], dtype="<u4").tofile(f)
        y.astype("<f4").tofile(f)


def compare(ref: np.ndarray, got: np.ndarray) -> bool:
    """parboil compare-output semantics."""
    if len(ref) != len(got):
        return False
    abstol = 1e-4 * np.abs(ref).max()
    diff = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    ok = (diff <= abstol) | (diff < 0.002 * np.abs(ref))
    return bool(ok.all())


def run(
    mtx_path: str,
    vec_path: str,
    *,
    golden_path: Optional[str] = None,
    out_path: Optional[str] = None,
    reps: int = REPS,
    kernel: str = "auto",
) -> ParboilResult:
    import jax

    from lilac.io.readers import read_matrix_market
    from lilac.plan import SpmvPlan

    indptr, indices, data, shape = read_matrix_market(mtx_path)
    n = shape[0]
    x = read_vector_bin(vec_path, n)

    plan = SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel=kernel)
    xd = plan.vec_in(x)

    @jax.jit
    def run_reps(A, x):
        # the reference recomputes the same product `reps` times into the
        # same output buffer (main.c:93-95) — keep them as a dependent
        # chain so the device really executes every repetition
        def body(_, y):
            return plan.matvec_with(A, x + 0.0 * y)

        return jax.lax.fori_loop(0, reps, body, x)

    y = run_reps(plan.A, xd)
    _ = np.asarray(y)  # warm-up fence
    t0 = time.perf_counter()
    y = run_reps(plan.A, xd)
    y_host = np.asarray(y, dtype=np.float32)[:n]
    t = time.perf_counter() - t0

    gflops = 2.0 * plan.nnz * reps / t / 1e9
    matched = maxerr = None
    if golden_path and os.path.exists(golden_path):
        ref = read_golden(golden_path)
        matched = compare(ref, y_host)
        maxerr = float(np.abs(ref - y_host).max())
    if out_path:
        write_output(out_path, y_host)
    return ParboilResult(
        rows=n,
        nnz=plan.nnz,
        reps=reps,
        time_s=t,
        gflops=gflops,
        matched=matched,
        max_abs_err=maxerr,
    )


DATASETS = {
    "small": ("1138_bus.mtx", "1138_bus.mtx.out"),
    "medium": ("bcsstk18.mtx", "bcsstk18.mtx.out"),
    "large": ("Dubcova3.mtx.bin", "Dubcova3.mtx.out"),  # input blob stripped
}


def run_dataset(name: str, root: str, **kw) -> ParboilResult:
    mtx, out = DATASETS[name]
    base = os.path.join(root, "datasets", "spmv", name)
    return run(
        os.path.join(base, "input", mtx),
        os.path.join(base, "input", "vector.bin"),
        golden_path=os.path.join(base, "output", out),
        **kw,
    )
