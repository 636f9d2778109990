"""Observability: phase timers, report cards, roofline accounting.

The reference instruments with per-section Fortran timers gated by a
`timer.flag` file (NPB common/timers.f, cg.f:103-112,419-439), per-op-class
flop/time ledgers (SparseBench iter.f:378-430, main.f:437-457) and parboil's
IO/Kernel/Copy/Compute categories (common/include/parboil.h). The
equivalents here:

* PhaseTimers  — named wall-clock sections with device fencing
                 (block_until_ready),
                 printable as the NPB-style report card;
* FlopLedger   — analytic per-op-class flop/byte counters (SpMV = 2·nnz
                 flops, 12·nnz bytes, ...) with achieved-rate reporting;
* roofline()   — achieved GB/s and FLOP/s against the device's published
                 peaks (chip_spec; the SURVEY §5 'achieved-GB/s vs HBM
                 roofline' requirement);
* trace()      — context manager around jax.profiler for deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np

# Published peaks per device, keyed by jax.Device.device_kind. H100 SXM:
# NVIDIA H100 Tensor Core GPU data sheet (SXM form factor, dense rates
# without sparsity): 3.35 TB/s HBM3, 67 TFLOP/s FP32, 34 TFLOP/s FP64
# (vector, outside the tensor cores). The rates assume the card's full
# 700 W power limit.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_gbps=3350.0, f32_tflops=67.0, f64_tflops=34.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM",
    ),
}


def chip_spec(device_kind: Optional[str] = None) -> dict:
    """Published peaks of `device_kind` (default: jax.devices()[0]). A
    device that is not in CHIP_SPECS is an error, not a default."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    if device_kind not in CHIP_SPECS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(CHIP_SPECS)}"
        )
    return CHIP_SPECS[device_kind]


class PhaseTimers:
    """Named sections; `fence` (any pytree of device arrays) is waited on
    with block_until_ready before the clock stops."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str, fence=None) -> float:
        if fence is not None:
            import jax

            jax.block_until_ready(fence)
        dt = time.perf_counter() - self._open.pop(name)
        self.total[name] = self.total.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    @contextlib.contextmanager
    def section(self, name: str, fence_fn=None):
        """Wall-clock section. NOTE: with the bare `with timers.section(x):`
        form there is nothing to fence on (a generator-based context manager
        receives None from `with`), so device work still in flight is NOT
        awaited — pass fence_fn=lambda: <device value> to fence, or use
        start()/stop(fence=...) directly."""
        self.start(name)
        yield
        self.stop(name, fence=None if fence_fn is None else fence_fn())

    def report(self) -> str:
        """NPB print_results-style card (common/print_results.f)."""
        tmax = max(self.total.values(), default=0.0)
        lines = ["  SECTION            calls   time(s)    fraction"]
        for k in sorted(self.total, key=self.total.get, reverse=True):
            t = self.total[k]
            lines.append(
                f"  {k:18s} {self.counts[k]:6d} {t:10.4f} {t / tmax if tmax else 0:10.2%}"
            )
        return "\n".join(lines)


@dataclasses.dataclass
class OpClass:
    flops: float = 0.0
    bytes: float = 0.0
    time_s: float = 0.0


class FlopLedger:
    """Per-op-class flop/byte/time ledger (SparseBench's add_*_flops)."""

    def __init__(self):
        self.classes: Dict[str, OpClass] = {}

    def add(self, name: str, *, flops=0.0, bytes=0.0, time_s=0.0) -> None:
        c = self.classes.setdefault(name, OpClass())
        c.flops += flops
        c.bytes += bytes
        c.time_s += time_s

    def add_spmv(self, nnz: int, value_bytes=4, index_bytes=4, time_s=0.0):
        self.add(
            "spmv",
            flops=2.0 * nnz,
            bytes=nnz * (value_bytes + index_bytes) + 2 * value_bytes * nnz,
            time_s=time_s,
        )

    def report(self, device_kind: Optional[str] = None) -> str:
        spec = chip_spec(device_kind)
        lines = [
            "  OP CLASS      GFLOP     GB     time(s)   GFLOP/s    GB/s   %roofline"
        ]
        for k, c in sorted(self.classes.items()):
            gf = c.flops / 1e9
            gb = c.bytes / 1e9
            fr = gf / c.time_s if c.time_s else 0.0
            br = gb / c.time_s if c.time_s else 0.0
            roof = max(
                fr / (spec["f32_tflops"] * 1e3), br / spec["hbm_gbps"]
            )
            lines.append(
                f"  {k:12s} {gf:8.2f} {gb:7.2f} {c.time_s:9.4f} {fr:9.1f} {br:7.1f}  {roof:8.1%}"
            )
        return "\n".join(lines)


def spmv_traffic_bytes(plan) -> dict:
    """Per-matvec device-memory traffic for a staged SpmvPlan.

    Every device leaf of the staged container (values, indices,
    permutations) is streamed once per matvec, so the container itself is
    the model's ground truth — no per-format formula to get wrong. The
    gather kernels add one gathered-x read per stored element (worst
    case: no cache reuse — the classic 12 B/nnz model's x term), plus one
    read of x and one write of y.

    Returns component bytes + 'total'; feed total to roofline().
    """
    import jax

    leaves = jax.tree_util.tree_leaves(plan.A)
    a_bytes = int(sum(v.size * np.dtype(v.dtype).itemsize for v in leaves))
    n, ncols = plan.shape
    vit = 8 if plan.dtype in ("f64", "df64") else 4
    x_bytes = ncols * vit
    y_bytes = n * vit
    extra = plan.nnz * vit
    total = a_bytes + x_bytes + y_bytes + extra
    return dict(
        container=a_bytes, x=x_bytes, y=y_bytes, intermediates=extra,
        total=total,
    )


def roofline(bytes_moved: float, flops: float, time_s: float,
             device_kind: Optional[str] = None) -> dict:
    """Achieved vs published-peak rates for one measured region on
    `device_kind` (default: the device this process runs on)."""
    spec = chip_spec(device_kind)
    gbps = bytes_moved / time_s / 1e9 if time_s else 0.0
    gflops = flops / time_s / 1e9 if time_s else 0.0
    return dict(
        gbps=gbps,
        gflops=gflops,
        frac_hbm=gbps / spec["hbm_gbps"],
        frac_flops=gflops / (spec["f32_tflops"] * 1e3),
        bound="memory" if gbps / spec["hbm_gbps"] > gflops / (spec["f32_tflops"] * 1e3) else "compute",
    )


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler wrapper: with trace('/tmp/trace'): run()."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
