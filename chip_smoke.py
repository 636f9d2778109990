#!/usr/bin/env python
"""Smoke test of lilac on NVIDIA GPUs: the main path, full size, verified.

One GPU (no arguments), in one process, phase by phase:

  device     the GPU JAX runs on, its count, and `nvidia-smi` name and
             power limit;
  df64       TwoSum/TwoProd error-free transforms exact against host f64
             under jit on the card;
  npb        NPB CG class C in f64 and in df64 and class D in f64 through
             npb_cg.run(kernel="factored"), each verified to NPB's 1e-10;
  kernels    every SpMV kernel (and the sgemm product) at real widths
             against a plain scipy/numpy f64 reference, each tolerance
             printed with its precision;
  graphs     PageRank and BFS on 1M-node power-law graphs against the
             host oracles;
  sparsebench  BiCG at size 40, validated by its true-residual check.

Four GPUs (--multi) run only the distributed plans and what they are
compared with: NPB CG class C over a 4-device mesh against the
single-device run, the ring halo matvec on a 128^3 stencil and the
distributed BiCG on a big_gen random CRS, both against scipy.

Every phase prints device memory in use and peak. A failed check exits
non-zero at once; so does a run where JAX finds no GPU. The last line of
standard output is {"ok": true, "device": {...}}.

Run: python chip_smoke.py           (one GPU)
     python chip_smoke.py --multi   (four GPUs)
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# normwise tolerances: max|got - ref| / max|ref| against an f64 reference
TOL = {"f64": 1e-12, "df64": 1e-12, "f32": 1e-5}
PRECISION = {
    "f64": "native f64",
    "df64": "double-word f32 (df64)",
    "f32": "f32",
}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise SystemExit(f"FAIL: {msg}")


def compare(name, got, ref, tol, precision):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    check(got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite output")
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
    log(f"  {name}: rel err {err:.3e} <= tol {tol:.0e} ({precision})")
    check(err <= tol, f"{name}: rel err {err:.3e} > {tol:.0e}")


def memory(tag):
    import jax

    for d in jax.local_devices():
        st = d.memory_stats() or {}
        log(f"  memory[{tag}] device {d.id}: in use "
            f"{st.get('bytes_in_use', 0) / 2**30:.3f} GiB, peak "
            f"{st.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB")


def phase_device(count):
    """Require `count` GPUs; print what JAX and nvidia-smi report."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    check(dev.platform == "gpu",
          f"JAX found no GPU (first device platform {dev.platform!r})")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    log(f"device: {dev.device_kind}, platform {dev.platform}, count {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def phase_df64(n=1 << 20):
    """TwoSum/TwoProd must be exact: s + e == a + b and p + e == a * b in
    f64 arithmetic, which represents both sides exactly for f32 inputs of
    these magnitudes."""
    import jax
    import jax.numpy as jnp

    from lilac.ops import dfloat as df

    log("phase df64: error-free transforms under jit")
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-8, 8, n))).astype(np.float32)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-8, 8, n))).astype(np.float32)
    s, e = jax.jit(df._two_sum)(jnp.asarray(a), jnp.asarray(b))
    p, f = jax.jit(df._two_prod)(jnp.asarray(a), jnp.asarray(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ts = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    tp = np.asarray(p, np.float64) + np.asarray(f, np.float64)
    bad_s = int((ts != a64 + b64).sum())
    bad_p = int((tp != a64 * b64).sum())
    log(f"  two_sum: {bad_s} of {n} inexact; two_prod: {bad_p} of {n} inexact "
        "(tol 0, exact)")
    check(bad_s == 0 and bad_p == 0, "df64 error-free transforms not exact")
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)
    got = float(df.to_f64(jax.jit(df.dot)(df.from_f64(x), df.from_f64(y))))
    # a dot's rounding error scales with sum |x_i y_i|, not with |x . y|
    err = abs(got - float(np.dot(x, y))) / float(np.abs(x * y).sum())
    log(f"  df64 dot of {n}: error / sum|x*y| {err:.3e} <= tol 1e-13 "
        f"({PRECISION['df64']})")
    check(err <= 1e-13, "df64 dot inaccurate")
    memory("df64")


def phase_npb(class_name, dtype):
    from lilac.workloads import npb_cg

    log(f"phase npb: class {class_name} {dtype}, factored operator")
    r = npb_cg.run(class_name, dtype=dtype, kernel="factored")
    log(f"  kernel {r.kernel}, time {r.time_s:.6f} s, zeta {r.zeta:.13f}, "
        f"zeta rel err {r.rel_err:.3e} (tol 1e-10), host set-up "
        f"{r.setup_s:.3f} s, {r.mops:.1f} MOp/s, nnz/matvec {r.nnz}")
    check(r.verified, f"NPB class {class_name} {dtype} did not verify "
          f"(rel err {r.rel_err:.3e})")
    memory(f"npb {class_name} {dtype}")
    return r


def _factored_reference(class_name):
    """Plain host f64 factored operator: x -> Vᵀ(s ⊙ (V x)) + d0·x from the
    same makea triples, through scipy."""
    import scipy.sparse as sp

    from lilac.generate.npb import CLASSES, _generate_triples

    cls = CLASSES[class_name]
    n = cls.na
    nzv, ivc, vc = _generate_triples(cls)
    rows = np.repeat(np.arange(n), nzv)
    V = sp.csr_matrix((vc, (rows, ivc - 1)), shape=(n, n))
    s = np.empty(n)  # size ramp as makea multiplies it (cg.f:830)
    s[0] = 1.0
    np.multiply.accumulate(np.full(n - 1, cls.rcond ** (1.0 / n)), out=s[1:])
    d0 = cls.rcond - cls.shift
    return lambda x: V.T @ (s * (V @ x)) + d0 * x


def phase_kernels(npb_class="C", crs_size=60, stencil_side=64,
                  graph_n=1_000_000, gemm_shapes=((4096, 4096, 4096),
                                                  (1000, 1100, 900))):
    import jax
    import scipy.sparse as sp

    from lilac.formats import convert
    from lilac.generate.graphs import powerlaw_graph
    from lilac.generate.npb import CLASSES
    from lilac.generate.random_crs import random_crs
    from lilac.generate.stencil import seven_point_csr
    from lilac.kernels import xla as kx
    from lilac.plan import FactoredNPBPlan, SpmvPlan
    from lilac.workloads import sgemm

    log("phase kernels: every kernel against a plain f64 reference")
    rng = np.random.default_rng(0)

    # factored NPB operator (segmented bucketed ELL, and the scan layout)
    ref = _factored_reference(npb_class)
    x = rng.standard_normal(CLASSES[npb_class].na)
    y_ref = ref(x)
    for dtype, segmode in (("f64", "single"), ("df64", "single"),
                           ("f64", "scan")):
        plan = FactoredNPBPlan(npb_class, dtype=dtype, segmode=segmode)
        y = plan.vec_out(jax.jit(plan.matvec_with)(plan.A, plan.vec_in(x)))
        compare(f"factored {segmode} class {npb_class} ({plan.kernel})",
                y, y_ref, TOL[dtype], PRECISION[dtype])
        del plan

    # general kernels: big_gen random CRS (all formats) and a power-law
    # graph (row-spread formats only: ELL would pad every row to the hub)
    mats = {
        f"random CRS size {crs_size}": (
            random_crs(crs_size, seed=1),
            ("xla_ell", "xla_csr", "xla_sell", "xla_ell_df", "xla_sell_df"),
        ),
        f"power-law n={graph_n}": (
            powerlaw_graph(graph_n, avg_deg=16.0, seed=0),
            ("xla_csr", "xla_sell", "xla_sell_df"),
        ),
    }
    for mname, ((ip, ix, dv, shape), kernels) in mats.items():
        dv = dv * rng.uniform(0.5, 1.5, len(dv))
        A = sp.csr_matrix((dv, ix, ip), shape=shape)
        x = rng.standard_normal(shape[1])
        xt = rng.standard_normal(shape[0])
        y_ref, yt_ref = A @ x, A.T @ xt
        for kernel in kernels:
            dtypes = ("df64",) if kernel.endswith("_df") else ("f32", "f64")
            for dtype in dtypes:
                plan = SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel=kernel)
                y = plan.vec_out(
                    jax.jit(plan.matvec_with)(plan.A, plan.vec_in(x)))
                compare(f"{kernel} {dtype} {mname}", y, y_ref, TOL[dtype],
                        PRECISION[dtype])
                if dtype == "f64":
                    yt = plan.vec_out(jax.jit(plan.matvec_t_with)(
                        plan.A, plan.vec_in(xt)))
                    compare(f"{kernel} transpose f64 {mname}", yt, yt_ref,
                            TOL["f64"], PRECISION["f64"])
                del plan
        rows = np.repeat(np.arange(shape[0]), np.diff(ip))
        coo = convert.coo_device(rows, ix, dv, shape, dtype=np.float64)
        compare(f"xla_coo f64 {mname}",
                jax.jit(kx.coo_spmv)(coo, x), y_ref, TOL["f64"],
                PRECISION["f64"])
        compare(f"xla_coo transpose f64 {mname}",
                jax.jit(kx.coo_spmv_t)(coo, xt), yt_ref, TOL["f64"],
                PRECISION["f64"])
        del coo

    # BSR: dense (8, 16) blocks of a 7-point stencil, f32 at HIGHEST
    ip, ix, dv, shape = seven_point_csr(stencil_side, stencil_side,
                                        stencil_side)
    A = sp.csr_matrix((dv, ix, ip), shape=shape)
    x = rng.standard_normal(shape[1])
    bsr = convert.bsr_device(ip, ix, dv, shape, block_shape=(8, 16),
                             dtype=np.float32)
    compare(f"xla_bsr f32 stencil {stencil_side}^3",
            jax.jit(kx.bsr_spmv)(bsr, np.asarray(x, np.float32)), A @ x,
            TOL["f32"], "f32, einsum precision HIGHEST")
    del bsr

    # parboil sgemm: XLA's dot at HIGHEST against the f64 oracle
    for m, n, k in gemm_shapes:
        a = rng.standard_normal((m, k)).astype(np.float32)
        bt = rng.standard_normal((n, k)).astype(np.float32)
        c, res = sgemm.run_arrays(a, bt, precision="highest")
        ref = a.astype(np.float64) @ bt.astype(np.float64).T
        compare(f"sgemm {m}x{n}x{k} ({res.gflops / 1e3:.2f} TF/s)", c, ref,
                1e-5, "f32, precision HIGHEST")
    memory("kernels")


def phase_graphs(n=1_000_000, pr_deg=16.0, bfs_deg=13.0, pr_iters=128,
                 bfs_sources=4):
    from lilac.generate.graphs import powerlaw_graph
    from lilac.plan import SpmvPlan
    from lilac.workloads import bfs, pagerank

    log(f"phase graphs: PageRank and BFS on power-law graphs, n={n}")
    g = powerlaw_graph(n, avg_deg=pr_deg, seed=0)
    r = pagerank.run(*g, iters=pr_iters, runs=2, dtype="f32")
    ref = pagerank.pagerank_oracle(*g, pagerank.initial_vector(n, 0),
                                   iters=pr_iters)
    log(f"  pagerank: nnz {r.nnz}, {pr_iters} iterations in "
        f"{min(r.times_s):.6f} s, step error {r.error:.3e}")
    compare("pagerank fixed point vs host f64 oracle", r.x, ref, 1e-4,
            "f32 device vs f64 host")
    del g

    g = powerlaw_graph(n, avg_deg=bfs_deg, seed=0, symmetric=True)
    rb = bfs.run_benchmark(*g, runs=16)
    log(f"  bfs: nnz {rb.nnz}, 16 sources in {rb.time_s:.6f} s")
    plan = SpmvPlan(g[0], g[1], np.ones_like(g[2]), g[3], dtype="f32")
    srcs = np.random.default_rng(1).integers(0, n, size=bfs_sources)
    for src in srcs:
        got = bfs.bfs_distances(plan, int(src))
        want = bfs.bfs_oracle(*g, int(src))
        mism = int((got != want).sum())
        log(f"  bfs source {src}: {int(want.max())} levels, {mism} "
            "mismatches vs host oracle (tol 0, exact)")
        check(mism == 0, f"BFS levels differ from the oracle (source {src})")
    memory("graphs")


def phase_sparsebench(size=40):
    from lilac.workloads import sparsebench

    log(f"phase sparsebench: BiCG benchmark, size {size}")
    r = sparsebench.benchmark(size)
    log(f"  n {r.n}, nnz {r.nnz}, kernel {r.kernel}, iterations "
        f"{r.iterations}, time {r.time_s:.6f} s, {r.mflop_rate:.1f} Mflop/s, "
        f"true-residual gap {r.true_residual_rel_gap:.3e} (tol 5e-2)")
    check(r.validated, "SparseBench true-residual check failed")
    memory("sparsebench")


def phase_dist_npb(class_name="C", ndev=4):
    from lilac.generate.npb import make_cg_matrix
    from lilac.parallel.dist import (
        DistSpmvPlan,
        dist_npb_power_method,
        make_mesh,
    )

    log(f"phase dist npb: class {class_name} f64 over {ndev} devices")
    single = phase_npb(class_name, "f64")
    indptr, indices, data, cls = make_cg_matrix(class_name)
    plan = DistSpmvPlan.build(indptr, indices, data, (cls.na, cls.na),
                              make_mesh(ndev), dtype="f64")
    x0 = plan.vec_in(np.ones(cls.na))
    times = []
    for _ in range(2):  # the first call compiles, the second finds the cache
        t0 = time.perf_counter()
        zetas, _, _ = dist_npb_power_method(plan, x0, cls.shift, cls.niter)
        zeta = float(np.asarray(zetas)[-1])
        times.append(time.perf_counter() - t0)
    rel = abs(zeta - cls.zeta_verify) / cls.zeta_verify
    rel_single = abs(zeta - single.zeta) / abs(single.zeta)
    log(f"  {ndev}-device zeta {zeta:.15f} in {times[0]:.6f} s with compile, "
        f"{times[1]:.6f} s with the compile cache warm (no warm-up "
        f"iteration), rel err {rel:.3e} (tol 1e-10); vs 1-device zeta "
        f"{single.zeta:.15f}: rel diff {rel_single:.3e} (tol 1e-12)")
    check(rel <= 1e-10, "distributed NPB did not verify")
    check(rel_single <= 1e-12, "distributed zeta differs from 1-device zeta")
    memory("dist npb")


def phase_halo(side=128, ndev=4):
    import scipy.sparse as sp

    from lilac.generate.stencil import seven_point_csr
    from lilac.parallel.dist import make_mesh
    from lilac.parallel.halo import HaloSpmvPlan, halo_matvec

    log(f"phase halo: 7-point stencil {side}^3 over {ndev} devices")
    ip, ix, dv, shape = seven_point_csr(side, side, side)
    plan = HaloSpmvPlan.build(ip, ix, dv, shape, make_mesh(ndev), dtype="f64")
    x = np.random.default_rng(2).standard_normal(shape[0])
    y = plan.vec_out(halo_matvec(plan, plan.vec_in(x)))
    log(f"  ring distances {plan.dist_ks}, halo rows {plan.halos}")
    compare("halo matvec vs scipy", y,
            sp.csr_matrix((dv, ix, ip), shape=shape) @ x, TOL["f64"],
            PRECISION["f64"])
    memory("halo")


def phase_dist_bicg(size=60, ndev=4):
    import scipy.sparse as sp

    from lilac.generate.random_crs import random_crs
    from lilac.parallel.dist import (
        DistSpmvPlan,
        dist_bicg_solve,
        dist_transposed_plan,
        make_mesh,
    )

    log(f"phase dist bicg: big_gen random CRS size {size} over {ndev} devices")
    ip, ix, dv, shape = random_crs(size, seed=0)
    mesh = make_mesh(ndev)
    plan = DistSpmvPlan.build(ip, ix, dv, shape, mesh, dtype="f64")
    plan_t = dist_transposed_plan(ip, ix, dv, shape, mesh, dtype="f64")
    x, its, _, rn = dist_bicg_solve(plan, plan_t, plan.vec_in(np.ones(shape[0])),
                                    maxit=100, rtol=1e-6)
    xh = plan.vec_out(x)
    true_res = float(np.linalg.norm(
        np.ones(shape[0]) - sp.csr_matrix((dv, ix, ip), shape=shape) @ xh))
    rec = float(np.asarray(rn))
    gap = abs(true_res - rec) / max(true_res, 1e-300)
    log(f"  iterations {int(its)}, recurrence residual {rec:.6e}, scipy "
        f"true residual {true_res:.6e}, gap {gap:.3e} (tol 5e-2, f64)")
    check(np.isfinite(xh).all() and gap <= 0.05,
          "distributed BiCG residual disagrees with scipy")
    memory("dist bicg")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run the distributed plans on four GPUs")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    t0 = time.time()

    import jax

    jax.config.update("jax_enable_x64", True)
    device = phase_device(4 if args.multi else 1)
    from lilac.config import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.multi:
        phase_dist_npb()
        phase_halo()
        phase_dist_bicg()
    else:
        phase_df64()
        phase_npb("C", "f64")
        phase_npb("C", "df64")
        phase_npb("D", "f64")
        phase_kernels()
        phase_graphs()
        phase_sparsebench()
    log(f"all phases passed in {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
