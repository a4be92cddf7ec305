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
    # queue 1 item 8b (raised until slice 9): the launch planner, the
    # pipeline thread and the compile plane, read as the JAX package reads
    # them; the directories are relative, so each package writes its own
    "pipeline env": (lambda m: m, {}, {"DELPHI_PIPELINE": "1"}, {}),
    "pipeline conf": (lambda m: m, {}, {},
                      {"repair.pipeline.enabled": "auto"}),
    "planner": (lambda m: m, {}, {"DELPHI_PLAN": "0"}, {}),
    "planner merge": (lambda m: m, {}, {"DELPHI_PLAN_MERGE": "4"}, {}),
    "planner chunk cells": (lambda m: m, {},
                            {"DELPHI_PLAN_CHUNK_CELLS": "4"}, {}),
    "planner chunk cells legacy": (lambda m: m, {},
                                   {"DELPHI_DOMAIN_CHUNK_CELLS": "4"}, {}),
    "planner cv cap": (lambda m: m, {},
                       {"DELPHI_PLAN_CV_INSTANCE_CAP": "2"}, {}),
    "planner cv cap legacy": (lambda m: m, {},
                              {"DELPHI_CV_INSTANCE_CAP": "2"}, {}),
    "plan dir": (lambda m: m, {}, {"DELPHI_PLAN_DIR": "plans"}, {}),
    "compile cache env": (lambda m: m, {},
                          {"DELPHI_COMPILE_CACHE_DIR": "cc"}, {}),
    "compile cache conf": (lambda m: m, {}, {},
                           {"repair.compile.cache_dir": "cc"}),
    "compile cache threshold env": (lambda m: m, {},
                                    {"DELPHI_COMPILE_CACHE_MIN_S": "0.5"}, {}),
    "compile cache threshold conf": (
        lambda m: m, {}, {}, {"repair.compile.min_compile_secs": "0"}),
    "prewarm env": (lambda m: m, {}, {"DELPHI_PREWARM": "on"}, {}),
    "prewarm conf": (lambda m: m, {}, {}, {"repair.compile.prewarm": "true"}),
    "prewarm budget env": (lambda m: m, {},
                           {"DELPHI_PREWARM_BUDGET": "4"}, {}),
    "prewarm budget conf": (lambda m: m, {}, {},
                            {"repair.compile.prewarm_budget": "4"}),
    "pair budget env": (lambda m: m, {}, {"DELPHI_PAIR_BUDGET": "60"}, {}),
    "pair budget conf": (lambda m: m, {}, {}, {"repair.pair.budget": "60"}),
    "device table off": (lambda m: m, {}, {"DELPHI_DEVICE_TABLE": "0"}, {}),
    "device table conf off": (lambda m: m, {}, {},
                              {"repair.device_table": "off"}),
    "batch train on": (lambda m: m.option("model.hp.max_evals", "1"), {},
                       {"DELPHI_BATCH_TRAIN": "1"}, {}),
    "batch train off": (lambda m: m.setParallelStatTrainingEnabled(True)
                        .option("model.hp.max_evals", "1"), {},
                        {"DELPHI_BATCH_TRAIN": "0"}, {}),
}


@pytest.fixture
def _restore_jax_cache_config():
    """The JAX package's compile plane points jax's persistent cache at the
    run's directory; the next test gets the old one back."""
    import jax
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


@pytest.mark.parametrize("case", sorted(PORTED))
def test_formerly_unported_paths_match_jax(case, monkeypatch, tmp_path,
                                           _restore_jax_cache_config):
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
    "run report env": (lambda m: m, "run report", "item 10",
                       {"DELPHI_METRICS_PATH": "r.json"}, {}),
    "run report conf": (lambda m: m, "run report", "item 10", {},
                        {"repair.metrics.path": "r.json"}),
    "live telemetry env": (lambda m: m, "live telemetry", "item 10",
                           {"DELPHI_METRICS_PORT": "0"}, {}),
    # fault F6: settings of the JAX package the port read nowhere
    "mesh env": (lambda m: m, "device mesh", "item 9",
                 {"DELPHI_MESH": "2"}, {}),
    "mesh conf": (lambda m: m, "device mesh", "item 9", {},
                  {"repair.mesh": "auto"}),
    "shard": (lambda m: m, "row-shard plane", "item 9",
              {"DELPHI_SHARD": "1"}, {}),
    "shard min rows": (lambda m: m, "row floor", "item 9",
                       {"DELPHI_SHARD_MIN_ROWS": "64"}, {}),
    "coordinator": (lambda m: m, "multi-process cluster", "item 9",
                    {"DELPHI_COORDINATOR": "localhost:9999"}, {}),
    "num processes": (lambda m: m, "multi-process cluster", "item 9",
                      {"DELPHI_NUM_PROCESSES": "2"}, {}),
    "process id": (lambda m: m, "multi-process cluster", "item 9",
                   {"DELPHI_PROCESS_ID": "0"}, {}),
    "collective timeout env": (lambda m: m, "collective deadline", "item 9",
                               {"DELPHI_COLLECTIVE_TIMEOUT_S": "5"}, {}),
    "collective timeout conf": (lambda m: m, "collective deadline",
                                "item 9", {},
                                {"repair.collective.timeout_s": "5"}),
    "plan cost": (lambda m: m, "cost veto", "item 10",
                  {"DELPHI_PLAN_COST": "1"}, {}),
    "trace dir": (lambda m: m, "request traces", "item 10",
                  {"DELPHI_TRACE_DIR": "traces"}, {}),
    "trace sample": (lambda m: m, "sampling", "item 10",
                     {"DELPHI_TRACE_SAMPLE": "0.5"}, {}),
    "profile dir env": (lambda m: m, "device profiles", "item 10",
                        {"DELPHI_PROFILE_DIR": "prof"}, {}),
    "profile dir conf": (lambda m: m, "device profiles", "item 10", {},
                         {"repair.profile.dir": "prof"}),
    "metrics events env": (lambda m: m, "event stream", "item 10",
                           {"DELPHI_METRICS_EVENTS": "1"}, {}),
    "metrics events conf": (lambda m: m, "event stream", "item 10", {},
                            {"repair.metrics.events": "yes"}),
    "phase heartbeat": (lambda m: m, "phase heartbeat", "item 10",
                        {"DELPHI_PHASE_HEARTBEAT": "on"}, {}),
    "resource sampler": (lambda m: m, "resource sampler", "item 10",
                         {"DELPHI_RESOURCE_SAMPLER": "true"}, {}),
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
        assert "item 8b" not in str(exc.value)


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
    # fault F6: the false spellings of the multi-GPU and observability
    # settings, and what their parse ignores
    ({"DELPHI_MESH": "off", "DELPHI_SHARD": "0"}, {"repair.mesh": "auto"}),
    ({}, {"repair.mesh": "no"}),
    ({"DELPHI_SHARD": "", "DELPHI_SHARD_MIN_ROWS": "many",
      "DELPHI_COORDINATOR": "", "DELPHI_NUM_PROCESSES": "",
      "DELPHI_COLLECTIVE_TIMEOUT_S": "soon"}, {}),
    ({"DELPHI_PLAN_COST": "0", "DELPHI_METRICS_EVENTS": "false",
      "DELPHI_PHASE_HEARTBEAT": "off", "DELPHI_RESOURCE_SAMPLER": "0",
      "DELPHI_TRACE_SAMPLE": "half", "DELPHI_TRACE_DIR": " "},
     {"repair.metrics.events": "no", "repair.profile.dir": ""}),
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


# Fault F6, documented in README.md: route selectors and XLA-only settings
# of the JAX package. The port has one route for each (or no XLA), so they
# have no effect and the results are equal.
NO_EFFECT = {
    "pallas": ({"DELPHI_PALLAS": "1"}, {}),
    "pallas off": ({"DELPHI_PALLAS": "0"}, {}),
    "device detect": ({"DELPHI_DEVICE_DETECT": "1"}, {}),
    "domain device": ({"DELPHI_DOMAIN_DEVICE": "1"}, {}),
    "dense logreg": ({"DELPHI_DENSE_LOGREG": "1"}, {}),
    "donate": ({"DELPHI_DONATE": "0"}, {}),
    "xfer content cache env": ({"DELPHI_XFER_CONTENT_CACHE": "0"}, {}),
    "xfer content cache conf": ({}, {"repair.xfer.content_cache": "off"}),
    "xla cache": ({"DELPHI_XLA_CACHE": "0"}, {}),
    "xla cache dir": ({"DELPHI_XLA_CACHE_DIR": "xla"}, {}),
    "cpu max isa": ({"DELPHI_CPU_MAX_ISA": "AVX2"}, {}),
}


@pytest.mark.parametrize("case", sorted(NO_EFFECT))
def test_route_selectors_leave_the_frame_unchanged(case, monkeypatch,
                                                   tmp_path):
    """Each setting leaves the port's repaired frame unchanged (and equal
    to the JAX package's at its defaults), on a constraint table whose
    run crosses every route those settings select in the JAX package:
    the stats kernels, detection, domain scoring, the logistic head."""
    sc = generate_scenario("fd_categorical", 600, seed=0)

    def run():
        return T.delphi.repair.setInput(sc.dirty).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]) \
            .option("model.hp.max_evals", "1").run()

    want = run()
    env, conf = NO_EFFECT[case]
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
    got = run()
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)
    assert list(tmp_path.iterdir()) == []


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
