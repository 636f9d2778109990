#!/usr/bin/env python
"""Headline benchmark: NPB CG time-to-solution on one GPU.

Prints ONE JSON line per completed class {"metric", "value", "unit",
"vs_baseline", ...}; the last line is the largest verified class.
vs_baseline is the speedup over the reference suite's best harnessed
backend for the same NPB class (MKL on the Intel rig,
reference results/cgo/cgo_data.csv — see BASELINE.md). Values > 1
mean faster than the reference.

The run climbs a class ladder A -> B -> C -> D and starts the next class
only when the remaining wall budget (LILAC_BENCH_BUDGET_S, default 480)
covers a prediction of its wall: the previous class's measured wall
scaled by NPB's flop model (npb_cg.py). LILAC_BENCH_CLASS runs one class
instead. LILAC_BENCH_DTYPE (f64 | df64) and LILAC_BENCH_KERNEL override
the value policy and operator; every run must verify (zeta rel err
<= 1e-10).

Exits non-zero when JAX finds no GPU, when a class fails, or when a class
does not verify.

Run: python bench.py
"""

import gc
import json
import os
import sys
import time

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

# reference best harnessed backend per class (results/cgo/cgo_data.csv)
BASELINE_S = {
    "S": 0.05,
    "W": 0.08,
    "A": 0.23,
    "B": 19.48,
    "C": 51.82,
    "D": 2181.90,
    # class E was never run by the reference (no published number); scale
    # MKL class D by the NPB flop-model ratio E/D (~13.5x) as the bar.
    "E": 29456.0,
}

LADDER = ("A", "B", "C", "D")


def _elapsed():
    return time.time() - T0


def _fingerprint():
    """Run fingerprint: device-memory copy bandwidth and dispatch
    round-trip latency, so absolute numbers from two runs can be put
    side by side."""
    import jax
    import jax.numpy as jnp

    nbig = 1 << 26  # 256 MB f32
    v = jnp.zeros(nbig, jnp.float32)
    reps = 30

    @jax.jit
    def sweep(a):
        return jax.lax.fori_loop(0, reps, lambda _, x: x + 1.0, a)

    jax.block_until_ready(sweep(v))
    t0 = time.perf_counter()
    jax.block_until_ready(sweep(v))
    dt = (time.perf_counter() - t0) / reps
    fp = {"hbm_copy_gbps": 2 * nbig * 4 / dt / 1e9}
    cp = jax.jit(lambda a: a + 1.0)
    tiny = jax.block_until_ready(cp(jnp.zeros(8, jnp.float32)))
    t0 = time.perf_counter()
    for _ in range(20):
        tiny = jax.block_until_ready(cp(tiny))
    fp["dispatch_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"bench: fingerprint {fp}", file=sys.stderr)
    return fp


def _class_flops(class_name):
    """NPB's closed-form operation count of one whole run (cg.f:395-402)."""
    from lilac.generate.npb import CLASSES
    from lilac.workloads.npb_cg import nnz_per_row_flops

    cls = CLASSES[class_name]
    term = nnz_per_row_flops(cls)
    return 2.0 * cls.niter * cls.na * (3.0 + term + 25.0 * (5.0 + term) + 3.0)


def _run_class(class_name, dtype, kernel, device):
    """Run one class; returns (line dict, wall seconds)."""
    from lilac.workloads import npb_cg

    t0 = time.time()
    res = npb_cg.run(class_name, dtype=dtype, kernel=kernel)
    wall = time.time() - t0
    line = {
        "metric": f"npb_cg_class{res.class_name}_time_to_solution",
        "value": res.time_s,
        "unit": "s",
        "vs_baseline": BASELINE_S[res.class_name] / res.time_s,
        "verified": bool(res.verified),
        "zeta_rel_err": res.rel_err,
        "mops": res.mops,
        "dtype": res.dtype,
        "kernel": res.kernel,
        "nnz": res.nnz,
        "setup_s": res.setup_s,
        "device": device,
        "class_wall_s": wall,
    }
    return line, wall


def main():
    sys.path.insert(0, HERE)
    import jax

    jax.config.update("jax_enable_x64", True)
    from lilac.config import cfg, enable_compile_cache

    conf = cfg()
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (first device is {dev.platform!r})",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"bench: device {device} up at {_elapsed():.1f}s", file=sys.stderr)
    fp = _fingerprint()

    classes = (conf.bench_class,) if conf.bench_class else LADDER
    prev = None
    for cls in classes:
        if prev is not None:
            pred = prev[1] * _class_flops(cls) / _class_flops(prev[0])
            remaining = conf.bench_budget_s - _elapsed()
            if remaining < 1.25 * pred:
                print(f"bench: stopping ladder before {cls} (predicted "
                      f"{pred:.0f}s, remaining {remaining:.0f}s)",
                      file=sys.stderr)
                break
        line, wall = _run_class(cls, conf.bench_dtype, conf.bench_kernel,
                                device)
        line["fingerprint"] = fp
        line["wall_total_s"] = _elapsed()
        print(json.dumps(line), flush=True)
        if not line["verified"]:
            print(f"bench: class {cls} FAILED verification "
                  f"(zeta rel err {line['zeta_rel_err']:.3e})", file=sys.stderr)
            return 1
        prev = (cls, wall)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
