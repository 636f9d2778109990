"""Autotune selector and bench-harness tests."""

import numpy as np
import pytest

from lilac import autotune, bench


def test_linear_selector_train_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    # synthetic: kernel A wins for small nnz, B for large — linearly separable
    X, y = [], []
    for _ in range(200):
        n = int(rng.integers(100, 1_000_000))
        nnz = int(n * rng.integers(2, 300))
        mean = nnz / n
        X.append(autotune.features(n, nnz, mean, mean * rng.uniform(0, 2)))
        y.append("xla_ell" if nnz < 1_000_000 else "xla_csr")
    model = autotune.train(np.asarray(X), y)
    acc = np.mean([model.predict(x) == lbl for x, lbl in zip(X, y)])
    assert acc > 0.95, acc

    p = tmp_path / "model.json"
    model.save(str(p))
    back = autotune.LinearSelector.load(str(p))
    assert all(back.predict(x) == model.predict(x) for x in X[:20])


def test_measure_times_kernels(rng):
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(rng, 200, 200, 0.05)
    t = autotune.measure(indptr, indices, data, shape, ["xla_ell", "xla_csr"], reps=2)
    assert set(t) == {"xla_ell", "xla_csr"}
    assert all(v > 0 for v in t.values())


def test_plan_uses_installed_model(tmp_path, monkeypatch, rng):
    from tests.conftest import random_csr

    X = [autotune.features(100, 1000, 10, 1.0)]
    model = autotune.train(np.asarray(X * 4), ["xla_csr"] * 4)
    p = tmp_path / "m.json"
    model.save(str(p))
    monkeypatch.setenv(autotune.MODEL_ENV, str(p))
    autotune._cached_model = None

    from lilac.plan import SpmvPlan

    (indptr, indices, data), shape = random_csr(rng, 64, 64, 0.1)
    plan = SpmvPlan(indptr, indices, data, shape, dtype="f32")
    assert plan.kernel == "xla_csr"
    monkeypatch.delenv(autotune.MODEL_ENV)
    autotune._cached_model = None


def test_bench_csv_and_analysis(tmp_path):
    rows = [
        bench.BenchRow("gpu", "npb", "xla_ell", "S", [2.0, 2.1, 2.2]),
        bench.BenchRow("gpu", "npb", "fast", "S", [1.0, 1.1, 1.0]),
        bench.BenchRow("gpu", "npb", "xla_ell", "W", [4.0, 4.0, 4.0]),
        bench.BenchRow("gpu", "npb", "fast", "W", [1.0, 1.0, 1.0]),
    ]
    p = tmp_path / "all.csv"
    bench.append_rows(str(p), rows)
    recs = bench.tidy(str(p))
    assert len(recs) == 12
    sp = bench.geomean_speedups(recs, "xla_ell")
    # geomean(2/1, 4/1) = sqrt(8)
    assert abs(sp[("gpu", "npb", "fast")] - np.sqrt(8.0)) < 1e-9


def test_bench_run_smoke():
    row = bench.run_bench("sparsebench", "10", runs=1, platform="cpu-test")
    assert len(row.times) == 1 and row.times[0] > 0
    # the CSV platform label defaults to the device the run is on
    assert bench.run_bench("sparsebench", "10", runs=1).platform == "cpu"


def test_corpus_v2_families_and_validity():
    # lazily iterate a small slice of the corpus; every matrix must be
    # canonical CSR with consistent pointers
    seen = set()
    n_checked = 0
    for name, (ip, ix, d, sh) in autotune.corpus_v2(max_n=5000, seeds=1):
        assert ip[0] == 0 and ip[-1] == len(ix) == len(d), name
        assert len(ip) == sh[0] + 1, name
        assert (np.diff(ip) >= 0).all(), name
        if len(ix):
            assert ix.min() >= 0 and ix.max() < sh[1], name
        seen.add(name.split("_")[0].rstrip("0123456789"))
        n_checked += 1
    assert n_checked >= 10
    # several distinct families even at tiny max_n
    assert len(seen) >= 3, seen


def test_collect_rows_resumable_and_model_v2(tmp_path, monkeypatch):
    # stub the corpus (3 tiny matrices) and the timer so the test is
    # device-free; exercise resumability + the held-out training protocol
    from tests.conftest import random_csr

    rng = np.random.default_rng(5)
    mats = []
    for i in range(3):
        (ip, ix, v), sh = random_csr(rng, 40 + 10 * i, 40 + 10 * i, 0.1)
        mats.append((f"m{i}", (ip, ix, v, sh)))

    monkeypatch.setattr(
        autotune, "corpus_v2", lambda max_n=0, seeds=0: iter(mats)
    )

    def fake_measure(ip, ix, d, sh, kernels, dtype="f32", reps=1):
        return {k: 1.0 + j + 0.001 * sh[0] for j, k in enumerate(kernels)}

    monkeypatch.setattr(autotune, "measure", fake_measure)
    rows = str(tmp_path / "rows.jsonl")
    n1 = autotune.collect_rows(rows, ("a", "b"), verbose=False)
    assert n1 == 3
    # resumable: second call adds nothing
    assert autotune.collect_rows(rows, ("a", "b"), verbose=False) == 0

    import json

    model_path = str(tmp_path / "model.json")
    # widen the label set so training has 2 classes
    lines = [json.loads(ln) for ln in open(rows)]
    lines[0]["times"] = {"a": 2.0, "b": 1.0}
    with open(rows, "w") as f:
        for ln in lines * 4:  # enough rows for a holdout split
            f.write(json.dumps(ln) + "\n")
    autotune.build_model_v2(rows, model_path, holdout=0.25, verbose=False)
    meta = json.load(open(model_path))["meta"]
    assert meta["corpus_rows"] == 12
    assert 0.0 <= meta["test_accuracy"] <= 1.0
    assert set(meta["label_counts"]) == {"a", "b"}
    # the shipped weights still load through the normal path
    back = autotune.LinearSelector.load(model_path)
    assert back.predict(np.asarray(lines[1]["feat"])) in ("a", "b")


def test_model_ship_gate_blocks_weak_models(tmp_path, monkeypatch):
    """A trained model whose held-out accuracy does not beat BOTH the
    majority-class and heuristic baselines must not install: predict()
    returns None and SpmvPlan's heuristic serves (round-4 verdict: the
    shipped 0.52-accuracy model was worse than always saying one label)."""
    import json

    rng = np.random.default_rng(7)
    rows = []
    # corpus where 'xla_csr' wins 80% of rows but features are pure noise:
    # no linear model can beat the 0.8 majority/heuristic baselines
    for i in range(40):
        win = "xla_csr" if i % 5 else "xla_ell"
        times = {"xla_csr": 2.0, "xla_ell": 2.0}
        times[win] = 1.0
        rows.append(dict(
            name=f"r{i}", feat=list(rng.normal(size=5)), times=times,
            nrows=1000, ncols=1000, nnz=5000,
        ))
    rows_path = str(tmp_path / "rows.jsonl")
    with open(rows_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    model_path = str(tmp_path / "model.json")
    autotune.build_model_v2(rows_path, model_path, verbose=False)
    meta = json.load(open(model_path))["meta"]
    assert "majority_accuracy" in meta and "heuristic_accuracy" in meta
    # force the weak-model condition deterministically (training on noise
    # can land at the majority rate either side of the bar): the GATE is
    # what's under test — a recorded held-out accuracy at/below the
    # baselines must keep the model uninstalled
    d = json.load(open(model_path))
    d["meta"]["test_accuracy"] = d["meta"]["majority_accuracy"]
    d["meta"]["gated_ok"] = False
    with open(model_path, "w") as f:
        json.dump(d, f)
    monkeypatch.setenv("LILAC_AUTOTUNE_MODEL", model_path)
    autotune._cached_model = None
    autotune._cached_path = None
    assert autotune.installed_model() is None
    assert autotune.predict(1000, 5000, 5.0, 1.0) is None

    # a strong model (labels perfectly separable on feat[0]) DOES ship
    for i, r in enumerate(rows):
        win = "xla_csr" if i % 2 else "xla_ell"
        r["times"] = {"xla_csr": 2.0, "xla_ell": 2.0}
        r["times"][win] = 1.0
        r["feat"][0] = 5.0 if win == "xla_csr" else -5.0
    with open(rows_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    autotune.build_model_v2(rows_path, model_path, verbose=False)
    meta2 = json.load(open(model_path))["meta"]
    assert meta2["gated_ok"]
    autotune._cached_model = None
    autotune._cached_path = None
    assert autotune.installed_model() is not None


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_refuses_cpu(script):
    """With no GPU, the GPU entry points exit non-zero and print no result
    (chip_smoke's last line is never an "ok": true)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(repo, script)], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0, p.stdout
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stdout + p.stderr
