"""One declarative configuration surface for every runtime knob.

The reference spreads configuration over Makefile vars, env probes and
per-bench CLI flags. This module is the single catalogue SURVEY §5 asks
for: each knob has a name, an env var, a type, a default and a docstring, and
``python -m lilac.bench config`` prints the live table.

Env vars stay the override mechanism (scripts and tests set them), so
``Config.from_env()`` re-reads the environment on every call — knob reads
are a few getenv calls, never hot-path work.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_UNSET = object()


def _env(name, typ, default):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw not in ("", "0", "false", "False")
    if typ is Optional[int] or typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


@dataclasses.dataclass(frozen=True)
class Knob:
    attr: str
    env: str
    typ: object
    default: object
    doc: str


KNOBS = (
    Knob("data_dir", "LILAC_DATA_DIR", str, None,
         "Directory for generated matrices (default: <repo>/data). "
         "LILAC_CACHE is an accepted alias."),
    Knob("steps_per_dispatch", "LILAC_STEPS_PER_DISPATCH", Optional[int], None,
         "NPB CG outer iterations fused per device dispatch (None = "
         "class-dependent auto: whole loop for small classes, chunks for "
         "large ones so no single device program runs for minutes)."),
    Knob("factored_segmode", "LILAC_FACTORED_SEGMODE", str, "single",
         "Layout for the factored NPB operator: single (one bucketed "
         "gather table) | scan (column segments accumulated by lax.scan)."),
    Knob("seg_quantile", "LILAC_SEG_QUANTILE", float, 97.0,
         "Row-length percentile defining the uniform slab width of the "
         "scan-accumulated segmented ELL layout."),
    Knob("autotune_model", "LILAC_AUTOTUNE_MODEL", str, None,
         "Path of the trained kernel-selection model JSON (default: "
         "lilac/autotune/model.json; absent = the heuristic serves)."),
    Knob("bench_budget_s", "LILAC_BENCH_BUDGET_S", float, 480.0,
         "bench.py wall budget in seconds; the class ladder stops before "
         "a rung whose predicted wall would exceed it."),
    Knob("bench_dtype", "LILAC_BENCH_DTYPE", str, "f64",
         "bench.py value policy (f64 | df64; both verify to 1e-10)."),
    Knob("bench_kernel", "LILAC_BENCH_KERNEL", str, "factored",
         "bench.py operator (factored = V/VT sum-of-outer-products form)."),
    Knob("bench_class", "LILAC_BENCH_CLASS", str, None,
         "Force one NPB class in bench.py instead of the budget ladder."),
    Knob("compile_cache_dir", "LILAC_COMPILE_CACHE", str, "auto",
         "JAX persistent compilation cache directory; 'auto' = "
         "<repo>/.jax_cache; '', '0', 'false' or 'off' (any case) "
         "disables. A set JAX_COMPILATION_CACHE_DIR takes precedence and "
         "is left as it is."),
)


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compilation cache.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    leaves the directory alone; otherwise the cache goes to
    cfg().compile_cache_dir. Idempotent and safe to call any time before
    (or after) backend init. Returns the directory in use, or None when
    disabled."""
    import jax

    c = os.environ.get("JAX_COMPILATION_CACHE_DIR") or None
    if c is None:
        c = cfg().compile_cache_dir
        if c.lower() in ("", "0", "false", "off"):
            return None
        if c == "auto":
            c = os.path.abspath(
                os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
            )
        jax.config.update("jax_compilation_cache_dir", c)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return c


@dataclasses.dataclass
class Config:
    data_dir: Optional[str]
    steps_per_dispatch: Optional[int]
    factored_segmode: str
    seg_quantile: float
    autotune_model: Optional[str]
    bench_budget_s: float
    bench_dtype: str
    bench_kernel: str
    bench_class: Optional[str]
    compile_cache_dir: Optional[str]

    @staticmethod
    def from_env() -> "Config":
        vals = {k.attr: _env(k.env, k.typ, k.default) for k in KNOBS}
        if vals["data_dir"] is None:  # legacy alias
            vals["data_dir"] = os.environ.get("LILAC_CACHE")
        return Config(**vals)

    def resolved_data_dir(self) -> str:
        if self.data_dir is not None:
            return os.path.abspath(self.data_dir)
        return os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "data")
        )

    def describe(self) -> str:
        lines = []
        for k in KNOBS:
            v = getattr(self, k.attr)
            src = "env" if os.environ.get(k.env) is not None else "default"
            lines.append(f"{k.env:28s} = {v!r:20} [{src}]  {k.doc}")
        return "\n".join(lines)


def cfg() -> Config:
    """The live configuration (re-reads env — see module docstring)."""
    return Config.from_env()
