"""NPB CG benchmark workload (flagship end-to-end slice).

Reproduces the NAS CG benchmark semantics exactly
(/root/reference/NPB3.3.1/CG/cg.f:53-439): makea matrix, one untimed warm-up
power iteration, then `niter` timed iterations of (25-step CG + ζ update),
verified against the per-class ζ constants to 1e-10 relative (cg.f:363-368).
MOp/s uses NPB's closed-form flop count (cg.f:395-402).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from lilac.generate.npb import CLASSES, make_cg_matrix
from lilac.plan import SpmvPlan
from lilac.solvers.algebra import get_algebra
from lilac.solvers.cg import npb_power_method


@dataclasses.dataclass
class NPBCGResult:
    class_name: str
    zeta: float
    zeta_verify: float
    verified: bool
    rel_err: float
    time_s: float
    mops: float
    niter: int
    nnz: int
    dtype: str
    kernel: str
    rnorm_last: float
    setup_s: float = 0.0  # host matrix build + device upload


def nnz_per_row_flops(cls) -> float:
    """NPB's flop model term (cg.f:398-399): nonzer*(nonzer+1) per row."""
    return float(cls.nonzer * (cls.nonzer + 1))


def run(
    class_name: str = "S",
    *,
    dtype: str = "f64",
    kernel: str = "auto",
    niter: Optional[int] = None,
    plan: Optional[SpmvPlan] = None,
    verbose: bool = False,
    steps_per_dispatch: Optional[int] = None,
) -> NPBCGResult:
    cls = CLASSES[class_name.upper()]
    n_it = niter if niter is not None else cls.niter
    if steps_per_dispatch is None:
        from lilac.config import cfg

        env = cfg().steps_per_dispatch
        if env is not None:
            steps_per_dispatch = int(env)
        elif cls.na <= 20000:
            # small classes: the whole loop as one program
            steps_per_dispatch = n_it
        elif cls.na <= 200000:
            steps_per_dispatch = 15  # classes B/C
        elif cls.na <= (1 << 21):
            steps_per_dispatch = 3  # class D
        else:
            steps_per_dispatch = 1  # class E: one outer step per program

    t_setup = time.perf_counter()
    if plan is None:
        if kernel == "factored":
            from lilac.plan import FactoredNPBPlan

            plan = FactoredNPBPlan(class_name, dtype=dtype)
        else:
            indptr, indices, data, _ = make_cg_matrix(class_name)
            plan = SpmvPlan(
                indptr, indices, data, (cls.na, cls.na), dtype=dtype, kernel=kernel
            )
        jax.block_until_ready(plan.A)
    setup_s = time.perf_counter() - t_setup
    alg = get_algebra(dtype)

    # Dispatch in chunks of outer power iterations rather than one giant
    # program, so no single device execution runs for minutes; chunking
    # costs one launch per chunk. Each chunk is still a fully fused
    # scan(fori_loop) XLA program.
    chunk = max(1, min(steps_per_dispatch, n_it))

    @jax.jit
    def run_chunk(A, x):
        return npb_power_method(plan.matvec_with, alg, A, x, cls.shift, chunk)

    x0 = plan.vec_in(np.ones(cls.na, dtype=np.float64))

    def full_run(x):
        zs, rs = [], []
        x_cur = x
        done = 0
        while done < n_it:
            zetas, rnorms, x_cur = run_chunk(plan.A, x_cur)
            # chunks chain through x_cur; histories stay on the device
            # until one fetch at the end
            zs.append(zetas)
            rs.append(rnorms)
            done += chunk
        jax.block_until_ready((zs, rs, x_cur))
        zh = np.concatenate([_scalars_to_f64(z, dtype) for z in zs])[:n_it]
        rh = np.concatenate([_scalars_to_f64(r, dtype) for r in rs])[:n_it]
        return zh, rh, x_cur

    # untimed warm-up iteration (cg.f:233-272) doubles as compile warm-up
    jax.block_until_ready(run_chunk(plan.A, x0))

    t0 = time.perf_counter()
    zeta_hist, rnorm_hist_arr, xf = full_run(x0)
    t = time.perf_counter() - t0

    rnorm_hist = rnorm_hist_arr
    zeta = float(zeta_hist[-1])
    rel_err = abs(zeta - cls.zeta_verify) / cls.zeta_verify
    verified = rel_err <= 1e-10

    term = nnz_per_row_flops(cls)
    mflops = (
        2.0 * n_it * cls.na * (3.0 + term + 25.0 * (5.0 + term) + 3.0) / t / 1e6
    )

    if verbose:
        for i, (zv, rv) in enumerate(zip(zeta_hist, rnorm_hist)):
            print(f"  it {i + 1:4d}  rnorm {rv:.14e}  zeta {zv:.13f}")

    return NPBCGResult(
        class_name=cls.name,
        zeta=zeta,
        zeta_verify=cls.zeta_verify,
        verified=verified,
        rel_err=rel_err,
        time_s=t,
        mops=mflops,
        niter=n_it,
        nnz=plan.nnz,
        dtype=dtype,
        kernel=plan.kernel,
        rnorm_last=float(rnorm_hist[-1]),
        setup_s=setup_s,
    )


def _scalars_to_f64(arr, dtype: str) -> np.ndarray:
    from lilac.ops import dfloat as df

    if dtype == "df64":
        return df.to_f64(arr)
    return np.asarray(arr, dtype=np.float64)


def print_report(r: NPBCGResult) -> str:
    """The NPB report card (common/print_results.f layout)."""
    card = f"""
 CG Benchmark Completed (lilac)
 Class           =             {r.class_name:>12s}
 Size            =             {r.niter and CLASSES[r.class_name].na:>12d}
 Iterations      =             {r.niter:>12d}
 Time in seconds =             {r.time_s:>12.2f}
 Mop/s total     =             {r.mops:>12.2f}
 Operation type  =   floating point ({r.dtype})
 Verification    =             {"SUCCESSFUL" if r.verified else "UNSUCCESSFUL":>12s}
 Zeta            =             {r.zeta:>20.13E}
 Kernel          =             {r.kernel:>12s}
"""
    print(card)
    return card
