"""Profiling, configuration and checkpoint/resume tests."""

import numpy as np
import pytest

H100 = "NVIDIA H100 80GB HBM3"


def test_phase_timers_and_ledger():
    import time

    from lilac.utils.profiling import FlopLedger, PhaseTimers, roofline

    t = PhaseTimers()
    t.start("init")
    time.sleep(0.01)
    t.stop("init")
    assert t.total["init"] >= 0.01
    rep = t.report()
    assert "init" in rep

    led = FlopLedger()
    led.add_spmv(1_000_000, time_s=0.001)
    assert "spmv" in led.report(device_kind=H100)

    r = roofline(bytes_moved=1e9, flops=2e9, time_s=0.01, device_kind=H100)
    assert r["gbps"] == 100.0 and r["bound"] == "memory"
    assert abs(r["frac_hbm"] - 100.0 / 3350.0) < 1e-12


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from lilac.ops import dfloat as df
    from lilac.utils import checkpoint as ck

    state = (jnp.arange(5.0), df.from_f64(np.asarray([1.0, 2.0])))
    p = str(tmp_path / "s.npz")
    ck.save_state(p, state, dict(iter=3, zetas=[1.0, 2.0]))
    back, meta = ck.load_state(p, state)
    assert meta["iter"] == 3
    np.testing.assert_array_equal(np.asarray(back[0]), np.arange(5.0))
    np.testing.assert_array_equal(df.to_f64(back[1]), [1.0, 2.0])


def test_checkpointed_power_method_resumes(tmp_path):
    """Interrupt after 5 outer iterations; resumed run continues from the
    checkpoint and matches an uninterrupted run."""
    from lilac.generate.npb import CLASSES, make_cg_matrix
    from lilac.plan import SpmvPlan
    from lilac.utils import checkpoint as ck

    cls = CLASSES["S"]
    indptr, indices, data, _ = make_cg_matrix("S")
    plan = SpmvPlan(indptr, indices, data, (cls.na, cls.na), dtype="f64")
    x0 = plan.vec_in(np.ones(cls.na))

    p = str(tmp_path / "cg.npz")
    z1, xf, start = ck.checkpointed_power_method(
        plan, x0, cls.shift, 5, path=p, every=5
    )
    assert start == 0 and len(z1) == 5
    # resume to 15
    z2, xf, start = ck.checkpointed_power_method(
        plan, x0, cls.shift, 15, path=p, every=5
    )
    assert start == 5 and len(z2) == 15
    # uninterrupted reference
    p2 = str(tmp_path / "cg2.npz")
    z3, _, _ = ck.checkpointed_power_method(plan, x0, cls.shift, 15, path=p2, every=15)
    np.testing.assert_allclose(z2, z3, rtol=1e-12)
    assert abs(z2[-1] - cls.zeta_verify) / cls.zeta_verify < 1e-10


def test_spmv_traffic_bytes_models_each_family():
    """Container-leaf traffic accounting: every staged leaf (values,
    indices, permutations) plus one gathered-x read per stored element,
    one x read and one y write — for plain and factored plans alike."""
    import jax

    from lilac.generate.random_crs import random_crs
    from lilac.plan import FactoredNPBPlan, SpmvPlan
    from lilac.utils.profiling import spmv_traffic_bytes

    def leaf_bytes(tree):
        return sum(v.size * np.dtype(v.dtype).itemsize
                   for v in jax.tree_util.tree_leaves(tree))

    indptr, indices, data, shape = random_crs(12, seed=0)
    ell = SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel="xla_ell")
    tb = spmv_traffic_bytes(ell)
    assert tb["intermediates"] == ell.nnz * 4
    assert tb["total"] == sum(
        tb[k] for k in ("container", "x", "y", "intermediates")
    )
    assert tb["container"] >= ell.nnz * 8  # >= unpadded vals+idx

    # bucketed ELL stages an un-permute: its leaf is counted too
    sell = SpmvPlan(indptr, indices, data, shape, dtype="f64", kernel="xla_sell")
    ts = spmv_traffic_bytes(sell)
    assert ts["container"] == leaf_bytes(sell.A)
    assert ts["container"] >= sell.A.inv_perm.size * 4 + sell.nnz * 12

    fac = FactoredNPBPlan("S", dtype="f64")
    tf = spmv_traffic_bytes(fac)
    assert tf["container"] == leaf_bytes(fac.A)
    assert tf["intermediates"] == fac.nnz * 8
    assert tf["x"] == tf["y"] == fac.shape[0] * 8


def test_config_catalogue_and_env_overrides(monkeypatch):
    from lilac.config import KNOBS, cfg

    c = cfg()
    # every knob resolves and appears in the human description
    desc = c.describe()
    for k in KNOBS:
        assert k.env in desc
    assert c.steps_per_dispatch is None
    assert c.bench_dtype == "f64"
    assert c.factored_segmode == "single"

    monkeypatch.setenv("LILAC_STEPS_PER_DISPATCH", "5")
    monkeypatch.setenv("LILAC_BENCH_CLASS", "C")
    c2 = cfg()
    assert c2.steps_per_dispatch == 5 and c2.bench_class == "C"
    assert "[env]" in c2.describe()

    # legacy LILAC_CACHE alias feeds data_dir
    monkeypatch.setenv("LILAC_CACHE", "/tmp/xyz")
    assert cfg().resolved_data_dir() == "/tmp/xyz"


@pytest.fixture
def cache_config():
    """Restore JAX's compilation-cache directory after a test sets it."""
    import jax

    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path, cache_config):
    """A set JAX_COMPILATION_CACHE_DIR is the cache; the code sets no other."""
    import jax

    from lilac.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_COMPILE_CACHE", str(tmp_path / "other"))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_repo_dir(monkeypatch, cache_config):
    import os

    import jax

    from lilac.config import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("LILAC_COMPILE_CACHE", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("off", ["off", "0", "", "FALSE"])
def test_compile_cache_off(monkeypatch, off, cache_config):
    import jax

    from lilac.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("LILAC_COMPILE_CACHE", off)
    assert enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_chip_spec_h100_row():
    from lilac.utils.profiling import chip_spec

    spec = chip_spec(H100)
    assert spec["hbm_gbps"] == 3350.0
    assert spec["f32_tflops"] == 67.0 and spec["f64_tflops"] == 34.0
    assert "data sheet" in spec["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", None])
def test_chip_spec_unknown_kind_raises(kind):
    """No silent default: an unknown device (the CPU this suite runs on,
    when kind is None) has no peaks."""
    from lilac.utils.profiling import chip_spec

    with pytest.raises(KeyError, match="no published peaks"):
        chip_spec(kind)
