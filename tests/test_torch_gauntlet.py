"""The port's scenario gauntlet (``delphi_tpu_torch/gauntlet/``): the cases
of ``tests/test_gauntlet.py`` on the port's modules (injector determinism
and bookkeeping, the scenario registry, cell and downstream scoring, the
per-scenario drift gate, the v6 -> v7 report upgrade, the regression
branch of the numeric scenario, the gauntlet smoke's checks at 120 rows),
and host parity with the JAX package: generated scenarios byte for byte
at 2,000 rows, ``score_cells``, ``apply_repairs`` and ``downstream_score``
value for value, and ``lookalikes.materialize_testdata`` file for file.

``run_scenario`` itself is held against the JAX package's in
``tests/test_torch_gauntlet_parity.py``.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu_torch as T
from delphi_tpu.gauntlet import lookalikes as j_lookalikes
from delphi_tpu.gauntlet import score as j_score
from delphi_tpu.gauntlet.scenarios import generate_scenario as j_generate
from delphi_tpu_torch.gauntlet import (SCENARIOS, NullInjector,
                                       OutlierInjector, SwapInjector,
                                       TypoInjector, generate_scenario,
                                       inject, scenario_names)
from delphi_tpu_torch.gauntlet import lookalikes as t_lookalikes
from delphi_tpu_torch.gauntlet import score as t_score
from delphi_tpu_torch.gauntlet.score import (apply_repairs, downstream_score,
                                             score_cells, values_match)
from delphi_tpu_torch.observability import drift


@pytest.fixture(autouse=True)
def _clean_gauntlet_env():
    saved = {v: os.environ.get(v) for v in
             ("DELPHI_GAUNTLET_ROWS", "DELPHI_GAUNTLET_SEED",
              "DELPHI_GAUNTLET_SCENARIOS", "DELPHI_PROVENANCE_PATH",
              "DELPHI_METRICS_PATH")}
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _frame(n=120):
    rng = np.random.RandomState(7)
    return pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "cat": [f"c{v}" for v in rng.randint(0, 5, size=n)],
        "num": np.round(rng.uniform(-3, 3, size=n), 6),
        "code": [f"{100 + v}-{v % 7}" for v in rng.randint(0, 30, size=n)],
    })


# -- injectors --------------------------------------------------------------

def test_inject_deterministic_byte_identical():
    clean = _frame()
    injectors = lambda: [NullInjector(["cat"], rate=0.05),  # noqa: E731
                         TypoInjector(["code"], rate=0.05),
                         OutlierInjector(["num"], rate=0.05),
                         SwapInjector(["cat"], rate=0.05)]
    d1, t1 = inject(clean, injectors(), seed=3)
    d2, t2 = inject(clean, injectors(), seed=3)
    assert d1.to_csv(index=False) == d2.to_csv(index=False)
    assert t1 == t2


def test_inject_seed_changes_cells():
    clean = _frame()
    _, t1 = inject(clean, [NullInjector(["cat", "code"], rate=0.08)], seed=1)
    _, t2 = inject(clean, [NullInjector(["cat", "code"], rate=0.08)], seed=2)
    assert set(t1) != set(t2)


def test_inject_never_corrupts_a_cell_twice_and_truth_is_exact():
    """Every differing cell is in the truth map with the clean value, every
    truth entry actually differs, and no cell carries two corruptions."""
    clean = _frame()
    dirty, truth = inject(clean, [
        NullInjector(["cat", "code"], rate=0.1),
        TypoInjector(["cat", "code"], rate=0.1),
        SwapInjector(["cat"], rate=0.1),
    ], seed=5)
    diff = set()
    for col in ("cat", "num", "code"):
        for i in range(len(clean)):
            a, b = clean[col].iloc[i], dirty[col].iloc[i]
            if (pd.isna(a) != pd.isna(b)) or \
                    (pd.notna(a) and pd.notna(b) and a != b):
                diff.add((clean["tid"].iloc[i], col))
    assert diff == set(truth)
    for (tid, col), v in truth.items():
        row = clean.index[clean["tid"] == tid][0]
        assert clean[col].iloc[row] == v


def test_inject_row_order_and_clean_frame_untouched():
    clean = _frame()
    before = clean.to_csv(index=False)
    dirty, _ = inject(clean, [NullInjector(["cat"], rate=0.2)], seed=0)
    assert clean.to_csv(index=False) == before
    assert list(dirty["tid"]) == list(clean["tid"])


# -- scenarios --------------------------------------------------------------

def test_registry_has_five_scenarios_with_scale_series():
    names = scenario_names()
    assert len(names) >= 5
    assert {"fd_categorical", "numeric_regression", "missing_heavy",
            "wide", "correlated_multi"} <= set(names)
    for n in names:
        s = SCENARIOS[n]
        assert len(s.scales) >= 3 and min(s.scales) <= 2_000 \
            and max(s.scales) >= 50_000


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_generates_consistent_triple(name):
    data = generate_scenario(name, rows=200, seed=1)
    assert len(data.clean) == 200 and len(data.dirty) == 200
    assert list(data.clean.columns) == list(data.dirty.columns)
    assert data.truth, "every scenario must inject at least one cell"
    cols = set(data.clean.columns)
    assert data.label in cols and set(data.targets) <= cols
    for (tid, col), v in data.truth.items():
        assert col in cols
    again = generate_scenario(name, rows=200, seed=1)
    assert data.dirty.to_csv(index=False) == again.dirty.to_csv(index=False)
    assert data.truth == again.truth


def test_wide_scenario_is_wide():
    data = generate_scenario("wide", rows=100, seed=0)
    assert len(data.clean.columns) - 1 >= 50


def test_missing_heavy_rate():
    data = generate_scenario("missing_heavy", rows=500, seed=0)
    frac = data.dirty[["tier", "band", "grade"]].isna().to_numpy().mean()
    assert frac >= 0.2


# -- scoring ----------------------------------------------------------------

def test_values_match_numeric_tolerance():
    assert values_match("3.001", 3.0)
    assert values_match(10.4, 10.0)          # 4% relative error
    assert not values_match(20.0, 10.0)
    assert values_match("x", "x") and not values_match("x", "y")
    assert not values_match(None, "x")


def test_score_cells_perfect_and_empty():
    truth = {("0", "a"): "v0", ("1", "a"): "v1"}
    frame = pd.DataFrame({"tid": ["0", "1"], "attribute": ["a", "a"],
                          "repaired": ["v0", "v1"]})
    s = score_cells(frame, truth)
    assert s["f1"] == 1.0 and s["correct"] == 2
    s0 = score_cells(None, truth)
    assert s0 == {"injected": 2, "repairs": 0, "correct": 0,
                  "precision": 0.0, "recall": 0.0, "f1": 0.0}


def test_apply_repairs_splices_and_downstream_scores():
    data = generate_scenario("fd_categorical", rows=300, seed=0)
    # oracle repairs: write the clean value back into every injected cell
    frame = pd.DataFrame(
        [(t, a, v) for (t, a), v in data.truth.items()],
        columns=["tid", "attribute", "repaired"])
    repaired = apply_repairs(data.dirty, frame, data.row_id)
    pd.testing.assert_frame_equal(
        repaired.fillna("_"), data.clean.fillna("_"), check_dtype=False)
    d = downstream_score(data, repaired, seed=0)
    assert d["task"] == "classification" and d["metric"] == "accuracy"
    assert d["repaired"] == d["clean"]           # oracle == clean variant
    assert d["train_rows"] + d["test_rows"] == 300


# -- drift gate -------------------------------------------------------------

def _mini_gauntlet(f1, gap):
    return {"scenarios": {"s": {
        "repair": {"f1": f1, "precision": f1, "recall": f1,
                   "injected": 10, "repairs": 10, "correct": int(10 * f1)},
        "downstream": {"gap_closed": gap},
        "scorecards": None}}}


def test_evaluate_gauntlet_trips_on_f1_collapse():
    healthy = _mini_gauntlet(0.9, 0.8)
    degraded = _mini_gauntlet(0.0, -0.5)
    baseline = {"gauntlet": healthy}
    ok = drift.evaluate_gauntlet(healthy, baseline, fail_over=0.25)
    assert ok["failed"] is False and ok["max_severity"] == 0.0
    bad = drift.evaluate_gauntlet(degraded, baseline, fail_over=0.25)
    assert bad["failed"] is True
    assert bad["per_scenario"]["s"]["f1_drop"] == 0.9


def test_evaluate_gauntlet_baseline_missing_never_fails():
    res = drift.evaluate_gauntlet(_mini_gauntlet(0.0, 0.0),
                                  {"scorecards": {}}, fail_over=0.01)
    assert res["baseline_missing"] is True and res["failed"] is False


def test_evaluate_gauntlet_improvement_never_contributes():
    res = drift.evaluate_gauntlet(
        _mini_gauntlet(0.9, 0.9), {"gauntlet": _mini_gauntlet(0.1, 0.0)},
        fail_over=0.01)
    assert res["failed"] is False and res["max_severity"] == 0.0


# -- run-report schema v7 ---------------------------------------------------

def test_run_report_v6_upgrades_to_v7():
    from delphi_tpu_torch import observability as obs
    v6 = {"schema_version": 6, "kind": obs.REPORT_KIND, "status": "ok",
          "run": {}, "env": {}, "metrics": {}, "spans": {},
          "device_time": None, "per_process": None, "scorecards": None,
          "drift": None, "incremental": None, "escalation": None,
          "dist": None}
    up = obs.upgrade_run_report(v6)
    assert up["schema_version"] == obs.REPORT_SCHEMA_VERSION
    assert up["schema_version_loaded_from"] == 6
    assert up["gauntlet"] is None


# -- pipeline integration ---------------------------------------------------

def test_numeric_scenario_exercises_regression_branch():
    """The numeric scenario's continuous target columns route to regressor
    training (train.regressors > 0) and produce numeric repairs the scorer
    can match under tolerance."""
    from delphi_tpu_torch.gauntlet.runner import run_scenario
    data = generate_scenario("numeric_regression", rows=300, seed=0)
    result = run_scenario(data, seed=0)
    assert not result.get("error")
    assert result["counters"].get("train.regressors", 0) > 0
    assert result["repair"]["repairs"] > 0


def test_emit_gauntlet_metrics_registry_shape():
    from delphi_tpu_torch.gauntlet.runner import emit_gauntlet_metrics
    from delphi_tpu_torch.observability.registry import MetricsRegistry
    reg = MetricsRegistry()
    report = {"scenarios": {"s": {
        "repair": {"injected": 4, "repairs": 3, "correct": 2, "f1": 0.57},
        "downstream": {"gap_closed": 0.5}}},
        "mean_f1": 0.57, "mean_gap_closed": 0.5}
    emit_gauntlet_metrics(reg, report)
    snap = reg.snapshot()
    assert snap["counters"]["gauntlet.scenarios"] == 1
    assert snap["counters"]["gauntlet.cells_injected"] == 4
    assert snap["counters"]["gauntlet.repairs_correct"] == 2
    assert snap["gauges"]["gauntlet.mean_f1"] == 0.57
    assert snap["gauges"]["gauntlet.s.f1"] == 0.57
    assert snap["gauges"]["gauntlet.s.gap_closed"] == 0.5


def gauntlet_smoke_checks(rows):
    """The checks of the JAX package's ``bench.gauntlet_smoke`` on the
    port: three scenarios scored, repairs help, the per-scenario gate
    passes a healthy run against itself and trips on a run without
    repairs."""
    from delphi_tpu_torch.gauntlet.runner import run_gauntlet
    names = ["fd_categorical", "missing_heavy", "correlated_multi"]
    healthy = run_gauntlet(names=names, rows=rows, seed=0)
    degraded = run_gauntlet(names=names, rows=rows, seed=0,
                            repairs_enabled=False)
    baseline = {"gauntlet": healthy}
    gate_self = drift.evaluate_gauntlet(healthy, baseline, fail_over=0.25)
    gate_degraded = drift.evaluate_gauntlet(degraded, baseline,
                                            fail_over=0.25)

    def scored(s):
        return not s.get("error") \
            and {"f1", "precision", "recall"} <= set(s["repair"]) \
            and all(s["downstream"].get(k) is not None
                    for k in ("dirty", "repaired", "clean"))

    return {
        "all_scored": all(scored(s) for s in healthy["scenarios"].values()),
        "mean_f1_positive": healthy["mean_f1"] > 0,
        "some_recall": any(s["repair"]["recall"] > 0.5
                           for s in healthy["scenarios"].values()),
        "self_gate_passes": gate_self["failed"] is False
                            and gate_self["baseline_missing"] is False,
        "degraded_gate_trips": gate_degraded["failed"] is True,
    }


def test_gauntlet_smoke_wrapper():
    checks = gauntlet_smoke_checks(rows=120)
    assert all(checks.values()), checks


# -- host parity with the JAX package ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_generated_scenario_equals_jax(name, seed):
    want, got = j_generate(name, 2_000, seed), generate_scenario(
        name, 2_000, seed)
    for frame in ("clean", "dirty"):
        w, g = getattr(want, frame), getattr(got, frame)
        assert g.to_csv(index=False) == w.to_csv(index=False), frame
        assert list(g.dtypes) == list(w.dtypes), frame
        pd.testing.assert_frame_equal(g, w)
    assert got.truth == want.truth and len(got.truth) > 0
    for key in ("name", "row_id", "label", "task", "constraints",
                "regexes", "targets", "outlier_detection"):
        assert getattr(got, key) == getattr(want, key), key


def test_generated_fd_scenario_equals_jax_at_10000_rows():
    """The FD injector's batched column writes and per-lhs donor arrays at
    five times the size above (the JAX package's injector takes about 40 s
    here, so one scenario and one seed)."""
    want, got = j_generate("fd_categorical", 10_000, 0), generate_scenario(
        "fd_categorical", 10_000, 0)
    for frame in ("clean", "dirty"):
        w, g = getattr(want, frame), getattr(got, frame)
        assert g.to_csv(index=False) == w.to_csv(index=False), frame
        pd.testing.assert_frame_equal(g, w)
    assert got.truth == want.truth and len(got.truth) > 1_000


def _repair_frame(data, seed):
    """A repair-candidates frame mixing right, wrong and numeric-near
    repairs of injected cells with repairs of clean cells."""
    rng = np.random.RandomState(seed)
    rows = []
    for (tid, attr), value in sorted(data.truth.items()):
        pick = rng.randint(4)
        if pick == 0:
            rows.append((tid, attr, value))
        elif pick == 1:
            rows.append((tid, attr, "wrong"))
        elif pick == 2 and isinstance(value, float):
            rows.append((tid, attr, value * 1.05))
        elif pick == 2:
            rows.append((tid, attr, value))
    clean_cells = data.clean.sample(n=8, random_state=seed)
    attr = data.targets[0]
    rows += [(t, attr, v) for t, v in
             zip(clean_cells["tid"], clean_cells[attr])]
    return pd.DataFrame(rows, columns=["tid", "attribute", "repaired"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scoring_equals_jax(name):
    data = generate_scenario(name, 600, 0)
    j_data = j_generate(name, 600, 0)
    frame = _repair_frame(data, 3)
    assert t_score.score_cells(frame, data.truth) == \
        j_score.score_cells(frame, j_data.truth)
    assert t_score.score_cells(None, data.truth) == \
        j_score.score_cells(None, j_data.truth)
    got = t_score.apply_repairs(data.dirty, frame, data.row_id)
    want = j_score.apply_repairs(j_data.dirty, frame, j_data.row_id)
    pd.testing.assert_frame_equal(got, want)
    for repaired_t, repaired_j in ((got, want),
                                   (data.dirty, j_data.dirty)):
        assert t_score.downstream_score(data, repaired_t, seed=0) == \
            j_score.downstream_score(j_data, repaired_j, seed=0)
    for v, w in ((1.0, 1.04), ("a", "a"), (None, 1.0), ("2.5", 2.0),
                 (np.nan, np.nan), ("x", 3.0)):
        assert t_score.values_match(v, w) == j_score.values_match(v, w)


def test_lookalikes_write_the_jax_files(tmp_path):
    got = t_lookalikes.materialize_testdata(str(tmp_path / "port"))
    want = j_lookalikes.materialize_testdata(str(tmp_path / "jax"))
    files = sorted(
        os.path.relpath(os.path.join(d, f), want)
        for d, _, fs in os.walk(want) for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), got)
        for d, _, fs in os.walk(got) for f in fs)
    assert set(t_lookalikes.SYNTHESIZED) <= set(files)
    for rel in files:
        with open(os.path.join(got, rel), "rb") as g, \
                open(os.path.join(want, rel), "rb") as w:
            assert g.read() == w.read(), rel
