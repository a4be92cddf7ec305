"""The port's whole repair pipeline against the JAX package's on gauntlet
scenarios (2k rows, NULL detection), on the CPU: with one GBDT config per
target (``model.hp.max_evals=1``), at default options (the cross-validated
grid search, the logistic head for wide targets), and through the batched
training route (``setParallelStatTrainingEnabled(True)``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.models import linear as j_linear
from delphi_tpu_torch.models.linear import LogisticRegressionModel
from delphi_tpu_torch.session import get_session as t_session

# scenario -> (targets of the max_evals=1 runs, extra options).
# fd_categorical's max_evals=1 runs repair `region` only, as slice 1 did;
# the default-option runs repair every target (`state`, whose typos widen
# it past 24 classes, through the logistic head). missing_heavy keeps all
# 4 candidate pairs per target, since the default cap of 3 prunes every
# pair of that table and the statistics would not run.
RUNS = {
    "missing_heavy": (None, {"error.max_attrs_to_compute_pairwise_stats": "4"}),
    "fd_categorical": (["region"], {}),
    "numeric_regression": (None, {}),
}

# top-two probability gap under which a logistic-head repair may differ:
# the two packages' f32 roundings can end Adam a step apart
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    # one intra-op thread: the CPU kernels' reduction order follows the
    # thread count, and the test workers share the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def _run(lib, name, **kw):
    sc = generate_scenario(name, 2000, seed=0)
    targets, opts = RUNS[name]
    m = lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .option("model.hp.max_evals", "1")
    if targets:
        m = m.setTargets(targets)
    for k, v in opts.items():
        m = m.option(k, v)
    return m.run(**kw)


_DEFAULT_RUNS = {}


def _run_default(lib, name, batched=False):
    """Default options, every target; cached per (package, scenario,
    route). For the JAX package also returns each logistic-head repair's
    top-two probability gap, in repair order."""
    key = (lib.__name__, name, batched)
    if key not in _DEFAULT_RUNS:
        gaps = []
        orig = j_linear.LogisticRegressionModel.predict

        def predict(self, X):
            p = np.sort(np.asarray(self.predict_proba(X)), axis=1)
            gaps.append(p[:, -1] - p[:, -2])
            return orig(self, X)

        sc = generate_scenario(name, 2000, seed=0)
        m = lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
            .setErrorDetectors([lib.NullErrorDetector()]) \
            .setParallelStatTrainingEnabled(batched)
        for k, v in RUNS[name][1].items():
            m = m.option(k, v)
        j_linear.LogisticRegressionModel.predict = predict
        try:
            out = m.run()
        finally:
            j_linear.LogisticRegressionModel.predict = orig
        _DEFAULT_RUNS[key] = (out, gaps)
    return _DEFAULT_RUNS[key]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_detect_errors_only_identical(name):
    want = _run(J, name, detect_errors_only=True)
    got = _run(T, name, detect_errors_only=True)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("name", ["missing_heavy", "fd_categorical"])
def test_repair_candidates_identical(name):
    want = _run(J, name)
    got = _run(T, name)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


def test_repaired_table_identical():
    want = _run(J, "missing_heavy", repair_data=True)
    got = _run(T, "missing_heavy", repair_data=True)
    pd.testing.assert_frame_equal(got, want)


def test_regression_repairs_within_tolerance():
    """Repaired floats within 1e-5 relative: the trees agree, the f32 leaf
    sums differ from the JAX matmul sums in the last ulp."""
    want = _run(J, "numeric_regression")
    got = _run(T, "numeric_regression")
    key = ["tid", "attribute", "current_value"]
    pd.testing.assert_frame_equal(got[key], want[key])
    rj = want["repaired"].astype(float).to_numpy()
    rt = got["repaired"].astype(float).to_numpy()
    assert np.isfinite(rt).all() and len(rt) > 0
    np.testing.assert_allclose(rt, rj, rtol=1e-5)


def _assert_frames_match(got, want, gaps=()):
    """Equal frames, except logistic-head (`state`) repairs whose top-two
    JAX probability gap is under NEAR_TIE: those are left out of the
    comparison and counted, and at most 1% of the column's repairs may
    differ among them. (On fd_categorical at 2k rows, 7 of the 59 `state`
    repairs are such near-ties, gaps 4e-7 and 8e-7, so the share of
    near-ties itself is not bounded.)"""
    key = ["tid", "attribute", "current_value"]
    pd.testing.assert_frame_equal(got[key], want[key])
    keep = np.ones(len(want), dtype=bool)
    if gaps:
        assert len(gaps) == 1, "one logistic-head target expected"
        rows = np.flatnonzero(want["attribute"].to_numpy() == "state")
        assert len(rows) == len(gaps[0]) > 0
        near = rows[gaps[0] < NEAR_TIE]
        differ = (got["repaired"].to_numpy()[near]
                  != want["repaired"].to_numpy()[near]).sum()
        print(f"state: {len(near)} near-tie repairs of {len(rows)}, "
              f"{differ} differ")
        assert differ <= 0.01 * len(rows), (differ, len(near), len(rows))
        keep[near] = False
    pd.testing.assert_series_equal(got["repaired"][keep],
                                   want["repaired"][keep])


@pytest.mark.parametrize("name", ["missing_heavy", "fd_categorical"])
def test_default_options_identical(name):
    """The README's call at default options: the CV grid search for every
    GBDT target and the logistic head for fd_categorical's `state`."""
    want, gaps = _run_default(J, name)
    got, _ = _run_default(T, name)
    assert len(got) > 0
    if name == "fd_categorical":
        assert "state" in set(got["attribute"])
    _assert_frames_match(got, want, gaps)


def _assert_regression_close(got, want):
    """Within 1e-5 of each value, or of its column's mean magnitude for
    values near zero (last-ulp leaf differences add up over 200 rounds)."""
    key = ["tid", "attribute", "current_value"]
    pd.testing.assert_frame_equal(got[key], want[key])
    for attr in want["attribute"].unique():
        sel = (want["attribute"] == attr).to_numpy()
        rj = want["repaired"][sel].astype(float).to_numpy()
        rt = got["repaired"][sel].astype(float).to_numpy()
        assert np.isfinite(rt).all() and len(rt) > 0
        np.testing.assert_allclose(rt, rj, rtol=1e-5,
                                   atol=1e-5 * np.abs(rj).mean())


def test_default_options_regression_within_tolerance():
    want, _ = _run_default(J, "numeric_regression")
    got, _ = _run_default(T, "numeric_regression")
    _assert_regression_close(got, want)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_batched_training_matches_sequential_and_jax(name):
    """setParallelStatTrainingEnabled(True): the port's batched frame equals
    its sequential frame and the JAX package's batched frame."""
    from delphi_tpu_torch.utils import counters
    counters.clear()
    got, _ = _run_default(T, name, batched=True)
    assert counters.get("gbdt.cv_launches", 0) > 0
    assert counters.get("train.batched_fallbacks", 0) == 0
    seq, _ = _run_default(T, name)
    want, gaps = _run_default(J, name, batched=True)
    if name == "numeric_regression":
        pd.testing.assert_frame_equal(got, seq)
        _assert_regression_close(got, want)
        return
    pd.testing.assert_frame_equal(got, seq)
    _assert_frames_match(got, want, gaps)


def _tiny():
    return pd.DataFrame({
        "tid": range(60),
        "a": [f"a{i % 3}" for i in range(60)],
        "b": [None if i % 9 == 0 else f"b{i % 3}" for i in range(60)],
        "c": [f"c{i % 2}" for i in range(60)],
    })


def _cost(m):
    """A Levenshtein cost function of the package ``m`` belongs to."""
    lib = J if type(m).__module__.startswith("delphi_tpu.") else T
    return m.setUpdateCostFunction(lib.Levenshtein()).setRepairDelta(5)


# case -> (model setup, run() arguments, environment, session conf of
# both packages)
PORTED = {
    "cv grid search": (lambda m: m, {}, {}, {}),
    "batched training": (lambda m: m.option("model.hp.max_evals", "1")
                         .setParallelStatTrainingEnabled(True), {}, {}, {}),
    "user error cells": (
        lambda m: m.setErrorCells(pd.DataFrame({
            "tid": [1, 9, 18, 30], "attribute": ["a", "b", "c", "b"]})),
        {}, {}, {}),
    "default detectors": (lambda m: m.setErrorDetectors([]), {}, {}, {}),
    "pmf mode": (lambda m: m, {"compute_repair_prob": True}, {}, {}),
    "score mode": (_cost, {"compute_repair_score": True}, {}, {}),
    "maximal likelihood": (_cost, {"maximal_likelihood_repair": True}, {},
                           {}),
    "rule repairs": (lambda m: m.setRepairByRules(True), {}, {}, {}),
    "chunked repair": (lambda m: m, {}, {"DELPHI_REPAIR_CHUNK_ROWS": "2"},
                       {}),
    "escalation": (lambda m: m.option("repair.escalate", "1"), {}, {}, {}),
    "escalation env": (lambda m: m, {}, {"DELPHI_ESCALATE": "1"}, {}),
    "escalation conf": (lambda m: m, {}, {}, {"repair.escalate": "true"}),
    "escalation explicit false": (
        lambda m: m, {}, {"DELPHI_ESCALATE": "false"},
        {"repair.escalate": "true"}),
    "provenance ledger": (lambda m: m, {}, {"DELPHI_PROVENANCE_PATH":
                                            ":memory:"}, {}),
    # incremental settings without a snapshot directory run in full, and a
    # snapshot directory without incremental runs is not read
    "snapshot dir": (lambda m: m.option("repair.snapshot.dir", "snap"), {},
                     {}, {}),
    "snapshot dir env": (lambda m: m, {}, {"DELPHI_SNAPSHOT_DIR": "snap"},
                         {}),
    "snapshot dir conf": (lambda m: m, {}, {},
                          {"repair.snapshot.dir": "snap"}),
    "incremental": (lambda m: m.option("repair.incremental", "true"), {},
                    {}, {}),
    "incremental env": (lambda m: m, {}, {"DELPHI_INCREMENTAL": "1"}, {}),
    "incremental conf": (lambda m: m, {}, {},
                         {"repair.incremental": "true"}),
    "store quota": (lambda m: m, {}, {"DELPHI_STORE_QUOTA_GB": "1"}, {}),
    # the checkpoint directories are relative: each package writes its own
    "checkpoints": (lambda m: m.option("model.checkpoint_path", "ckpt"), {},
                    {}, {}),
    "phase checkpoints env": (lambda m: m, {},
                              {"DELPHI_CHECKPOINT_DIR": "ckpt"}, {}),
    "phase checkpoints conf": (lambda m: m, {}, {},
                               {"repair.checkpoint.dir": "ckpt"}),
    # plans at sites both packages enter on this table: each fires once
    "fault plan env": (lambda m: m, {},
                       {"DELPHI_FAULT_PLAN": "freq.pair*:1:oom"}, {}),
    "fault plan conf": (lambda m: m, {}, {},
                        {"repair.fault.plan": "0:gbdt.*:1:oom"}),
    "fault plan non-store site": (
        lambda m: m, {}, {"DELPHI_FAULT_PLAN": "store.provenance:1:torn_write,"
                                               "domain.bucket:2:oom"}, {}),
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_formerly_unported_paths_match_jax(case, monkeypatch, tmp_path):
    """Paths that raised NotImplementedError in an earlier slice now run
    and return the JAX package's frame and ``resilience.*`` counters (the
    JAX package counts in its recorder's registry)."""
    from delphi_tpu import observability as j_obs
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu.parallel import resilience as j_rz
    from delphi_tpu_torch.parallel import resilience as t_rz
    from delphi_tpu_torch.utils import counters
    setup, run_kw, env, conf = PORTED[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
        monkeypatch.setitem(j_session().conf, k, v)

    def run(lib):
        (j_rz if lib is J else t_rz).reset_fault_state()
        d = tmp_path / lib.__name__
        d.mkdir()
        monkeypatch.chdir(d)
        m = lib.delphi.repair.setInput(_tiny()).setRowId("tid") \
            .setErrorDetectors([lib.NullErrorDetector()])
        counters.clear()
        rec = j_obs.start_recording("t") if lib is J else None
        try:
            frame = setup(m).run(**run_kw)
        finally:
            if rec is not None:
                j_obs.stop_recording(rec)
        got = rec.registry.snapshot()["counters"] if rec is not None \
            else dict(counters)
        return frame, {k: v for k, v in got.items()
                       if k.startswith("resilience.")}

    (want, want_rz), (got, got_rz) = run(J), run(T)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)
    assert got_rz == want_rz
    if case in ("fault plan env", "fault plan conf"):
        assert got_rz["resilience.faults.oom"] == 1


# case -> (model setup, words of the message, ROADMAP item, environment,
# session conf)
UNPORTED = {
    "pipeline env": (lambda m: m, "pipeline thread", "item 8b",
                     {"DELPHI_PIPELINE": "1"}, {}),
    "pipeline conf": (lambda m: m, "pipeline thread", "item 8b", {},
                      {"repair.pipeline.enabled": "auto"}),
    "planner": (lambda m: m, "launch planner", "item 8b",
                {"DELPHI_PLAN": "0"}, {}),
    "planner merge": (lambda m: m, "bucket merging", "item 8b",
                      {"DELPHI_PLAN_MERGE": "4"}, {}),
    "planner chunk cells": (lambda m: m, "cell budget", "item 8b",
                            {"DELPHI_PLAN_CHUNK_CELLS": "1000"}, {}),
    "planner chunk cells legacy": (lambda m: m, "cell budget", "item 8b",
                                   {"DELPHI_DOMAIN_CHUNK_CELLS": "1000"},
                                   {}),
    "planner cv cap": (lambda m: m, "CV instance cap", "item 8b",
                       {"DELPHI_PLAN_CV_INSTANCE_CAP": "8"}, {}),
    "planner cv cap legacy": (lambda m: m, "CV instance cap", "item 8b",
                              {"DELPHI_CV_INSTANCE_CAP": "8"}, {}),
    "plan dir": (lambda m: m, "persisted launch plans", "item 8b",
                 {"DELPHI_PLAN_DIR": "plans"}, {}),
    "compile cache env": (lambda m: m, "compile cache", "item 8b",
                          {"DELPHI_COMPILE_CACHE_DIR": "cc"}, {}),
    "compile cache conf": (lambda m: m, "compile cache", "item 8b", {},
                           {"repair.compile.cache_dir": "cc"}),
    "compile cache threshold env": (lambda m: m, "threshold", "item 8b",
                                    {"DELPHI_COMPILE_CACHE_MIN_S": "0.5"},
                                    {}),
    "compile cache threshold conf": (
        lambda m: m, "threshold", "item 8b", {},
        {"repair.compile.min_compile_secs": "0"}),
    "prewarm env": (lambda m: m, "prewarm thread", "item 8b",
                    {"DELPHI_PREWARM": "on"}, {}),
    "prewarm conf": (lambda m: m, "prewarm thread", "item 8b", {},
                     {"repair.compile.prewarm": "true"}),
    "prewarm budget env": (lambda m: m, "prewarm budget", "item 8b",
                           {"DELPHI_PREWARM_BUDGET": "4"}, {}),
    "prewarm budget conf": (lambda m: m, "prewarm budget", "item 8b", {},
                            {"repair.compile.prewarm_budget": "4"}),
    "run report env": (lambda m: m, "run report", "item 10",
                       {"DELPHI_METRICS_PATH": "r.json"}, {}),
    "run report conf": (lambda m: m, "run report", "item 10", {},
                        {"repair.metrics.path": "r.json"}),
    "live telemetry env": (lambda m: m, "live telemetry", "item 10",
                           {"DELPHI_METRICS_PORT": "0"}, {}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_paths_raise(case, monkeypatch):
    """Settings outside the port raise NotImplementedError naming what is
    missing and the ROADMAP item that brings it, before any work starts
    (detect-only runs too); none is silently ignored."""
    setup, words, item, env, conf = UNPORTED[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
    for detect_only in (False, True):
        m = T.delphi.repair.setInput(_tiny()).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()])
        with pytest.raises(NotImplementedError, match=words) as exc:
            setup(m).run(detect_errors_only=detect_only)
        assert f"queue 1 {item} of ROADMAP.md" in str(exc.value)
        assert "item 5" not in str(exc.value)


@pytest.mark.parametrize("env,conf", [
    ({"DELPHI_INCREMENTAL": "false"}, {"repair.incremental": "true"}),
    ({}, {"repair.incremental": "off"}),
    ({"DELPHI_METRICS_PORT": "not-a-port"}, {}),
    ({"DELPHI_STORE_QUOTA_GB": ""}, {"repair.metrics.path": ""}),
    ({"DELPHI_FAULT_PLAN": ""}, {"repair.fault.plan": "domain.bucket:1:oom"}),
    ({"DELPHI_PIPELINE": "off"}, {"repair.pipeline.enabled": "on"}),
    ({}, {"repair.pipeline.enabled": "false"}),
    ({"DELPHI_PREWARM": "0"}, {"repair.compile.prewarm": "1"}),
    ({}, {"repair.compile.prewarm": "no"}),
    # values the JAX package's parse ignores
    ({"DELPHI_PLAN_MERGE": "x", "DELPHI_PREWARM_BUDGET": "many",
      "DELPHI_PLAN_CHUNK_CELLS": ""}, {"repair.compile.min_compile_secs": ""}),
])
def test_explicit_false_settings_do_not_raise(env, conf, monkeypatch):
    """Read as the JAX package reads them (the environment before the
    session conf), these spellings turn nothing on, so the run goes on."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
    out = T.delphi.repair.setInput(_tiny()).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()]) \
        .run(detect_errors_only=True)
    assert len(out) > 0


def test_logistic_head_trains_on_the_factored_design():
    """fd_categorical's `state` trains the gather route of the logistic
    head (a OneHotDesign in, ``_compact`` set)."""
    seen = []
    orig = LogisticRegressionModel.fit

    def fit(self, X, y):
        out = orig(self, X, y)
        seen.append(self._compact is not None)
        return out

    LogisticRegressionModel.fit = fit
    try:
        sc = generate_scenario("fd_categorical", 2000, seed=0)
        T.delphi.repair.setInput(sc.dirty).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]) \
            .setTargets(["state"]).run()
    finally:
        LogisticRegressionModel.fit = orig
    assert seen == [True]


def test_misc_facade_returns_repair_misc():
    assert isinstance(T.delphi.misc, T.RepairMisc)
