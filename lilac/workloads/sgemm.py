"""Parboil sgemm workload: C = A·Bᵀ on column-major text matrices.

Reference: /root/reference/parboil/benchmarks/sgemm/src/base/main.cc:40-95 —
read A [m,k] and Bᵀ [n,k] (column-major text, io.cc:17-37), one GEMM through
the mm_harness ABI (sgemm_kernel.cc:16-28), write C column-major and print
GFLOPs (main.cc:94). Golden comparison uses the parboil float tolerance.
The medium dataset's blobs are stripped from the reference checkout
(.MISSING_LARGE_BLOBS:2-6), so tests run on synthetic matrices against a
float64 oracle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SgemmResult:
    m: int
    n: int
    k: int
    time_s: float
    gflops: float
    precision: str


def matmul_nt(a, bt, precision: str = "highest"):
    """C = a @ bt.T with a [M, K], bt [N, K] (the parboil 'NT' layout),
    through XLA's dot (cuBLAS on the GPU). precision='highest' keeps full
    float32 products; 'default' lets the GPU run TF32."""
    import jax
    import jax.numpy as jnp

    prec = {"highest": jax.lax.Precision.HIGHEST,
            "default": jax.lax.Precision.DEFAULT}[precision]
    return jax.lax.dot_general(
        a, bt, (((1,), (1,)), ((), ())), precision=prec,
        preferred_element_type=jnp.float32,
    )


def read_col_major(path: str):
    """io.cc:17-37: 'rows cols' then rows*cols floats, column-major."""
    toks = open(path).read().split()
    nr, nc = int(toks[0]), int(toks[1])
    v = np.asarray([float(t) for t in toks[2 : 2 + nr * nc]], dtype=np.float32)
    return v.reshape((nc, nr)).T  # column-major -> [nr, nc]


def write_col_major(path: str, mat: np.ndarray) -> None:
    nr, nc = mat.shape
    with open(path, "w") as f:
        f.write(f"{nr} {nc} ")
        f.write(" ".join(repr(float(x)) for x in mat.T.ravel()))
        f.write("\n")


def run_arrays(A: np.ndarray, BT: np.ndarray, precision: str = "highest",
               reps: int = 4) -> tuple:
    """C = A @ BT.T. Returns (C, SgemmResult)."""
    import functools

    import jax
    import jax.numpy as jnp

    m, k = A.shape
    n, _ = BT.shape
    a = jnp.asarray(A, jnp.float32)
    bt = jnp.asarray(BT, jnp.float32)
    f = jax.jit(functools.partial(matmul_nt, precision=precision))
    C = jax.block_until_ready(f(a, bt))  # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(a, bt)
    jax.block_until_ready(out)
    t = time.perf_counter() - t0
    res = SgemmResult(
        m=m, n=n, k=k, time_s=t / reps,
        gflops=2.0 * m * n * k * reps / t / 1e9, precision=precision,
    )
    return np.asarray(C), res


def run(
    a_path: str,
    bt_path: str,
    out_path: Optional[str] = None,
    golden_path: Optional[str] = None,
    precision: str = "highest",
):
    A = read_col_major(a_path)
    BT = read_col_major(bt_path)
    C, res = run_arrays(A, BT, precision=precision)
    matched = None
    if golden_path:
        from lilac.workloads.parboil_spmv import compare

        ref = read_col_major(golden_path)
        matched = compare(ref.ravel(), C.ravel())
    if out_path:
        write_col_major(out_path, C)
    return C, res, matched
