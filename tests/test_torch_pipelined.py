"""The port's pipeline thread (``delphi_tpu_torch/parallel/pipeline.py``):
the cases of ``tests/test_pipeline.py`` (the determinism contract, thread
hygiene, errors at the sequential index), then ``run()`` with the pipeline
forced on and off on the CPU: bit-identical frames in the port, equal to
the JAX package's, through sequential training (one target at a time) and
the batched route's CV sets. Integer and string frames: compared exactly.
"""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu_torch.parallel.pipeline import enabled, run_pipelined
from delphi_tpu_torch.session import get_session as t_session
from delphi_tpu_torch.utils import counters, histograms


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def _no_pipeline_threads() -> bool:
    return not any(t.name == "delphi-pipeline-prepare"
                   for t in threading.enumerate())


def test_disabled_path_spawns_no_threads(monkeypatch):
    monkeypatch.setenv("DELPHI_PIPELINE", "0")
    assert not enabled()
    before = threading.active_count()
    out = run_pipelined([1, 2, 3], lambda x: x * 10,
                        lambda item, prep: prep + item)
    assert out == [11, 22, 33]
    assert threading.active_count() == before
    assert _no_pipeline_threads()


def test_enabled_path_preserves_order_and_results(monkeypatch):
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    assert enabled()
    consumed = []

    def prep(x):
        return x * 10

    def consume(item, p):
        consumed.append(item)
        return p + item

    counters.clear()
    histograms.clear()
    out = run_pipelined(list(range(6)), prep, consume)
    assert out == [0, 11, 22, 33, 44, 55]
    assert consumed == list(range(6))
    assert _no_pipeline_threads()
    assert counters["pipeline.runs"] == 1 and counters["pipeline.items"] == 6
    assert len(histograms["pipeline.consumer_wait_seconds"]) == 6


def test_enabled_path_single_item_stays_sequential(monkeypatch):
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    before = threading.active_count()
    assert run_pipelined([7], lambda x: x, lambda i, p: p) == [7]
    assert threading.active_count() == before


def test_prepare_error_surfaces_at_sequential_index(monkeypatch):
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    consumed = []

    def prep(x):
        if x == 2:
            raise ValueError("boom")
        return x

    def consume(item, p):
        consumed.append(item)
        return p

    with pytest.raises(ValueError, match="boom"):
        run_pipelined([0, 1, 2, 3], prep, consume)
    # items before the failure consumed in order; nothing past it ran
    assert consumed == [0, 1]
    assert _no_pipeline_threads()


def test_consume_error_stops_producer(monkeypatch):
    monkeypatch.setenv("DELPHI_PIPELINE", "1")

    def consume(item, p):
        if item == 1:
            raise RuntimeError("consumer failed")
        return p

    with pytest.raises(RuntimeError, match="consumer failed"):
        run_pipelined(list(range(50)), lambda x: x, consume)
    assert _no_pipeline_threads()


@pytest.mark.parametrize("env,conf,want", [
    ({"DELPHI_PIPELINE": "on"}, {}, True),
    ({"DELPHI_PIPELINE": "off"}, {"repair.pipeline.enabled": "on"}, False),
    ({}, {"repair.pipeline.enabled": "yes"}, True),
    ({}, {"repair.pipeline.enabled": "0"}, False),
    # auto: on only for a run on the card; these tests pin the CPU
    ({"DELPHI_PIPELINE": "auto"}, {}, False),
    ({}, {}, False),
])
def test_toggle_reads_env_then_conf_then_device(env, conf, want,
                                                monkeypatch):
    monkeypatch.delenv("DELPHI_PIPELINE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
    assert enabled() is want


def test_producer_never_touches_the_card(monkeypatch):
    """Prepare is host-only: with the pipeline on, every guarded entry (each
    upload and device launch) of a whole run happens on the calling
    thread, none on the producer thread."""
    from delphi_tpu_torch.parallel import resilience
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    seen = []
    orig = resilience._maybe_inject

    def spy(site):
        seen.append((site, threading.current_thread().name))
        return orig(site)

    monkeypatch.setattr(resilience, "_maybe_inject", spy)
    counters.clear()
    _repair(T, "missing_heavy", {})
    assert counters.get("pipeline.items", 0) >= 2
    assert {s for s, _ in seen} >= {"xfer.upload", "gbdt.cv_chunk"}
    assert all(t != "delphi-pipeline-prepare" for _, t in seen)


_TABLE = {}


def _table(name):
    if name not in _TABLE:
        _TABLE[name] = generate_scenario(name, 2000, seed=0).dirty
    return _TABLE[name]


def _repair(lib, name, opts, batched=False):
    m = lib.delphi.repair.setInput(_table(name)).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .option("error.max_attrs_to_compute_pairwise_stats", "4") \
        .setParallelStatTrainingEnabled(batched)
    for k, v in opts.items():
        m = m.option(k, v)
    return m.run()


# scenario -> options: one GBDT config per target, or the CV grid search
CASES = {
    "missing_heavy max_evals=1": ("missing_heavy", {"model.hp.max_evals": "1"}),
    "missing_heavy grid": ("missing_heavy", {}),
    "fd_categorical max_evals=1": ("fd_categorical",
                                   {"model.hp.max_evals": "1"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_repair_bit_identical_with_pipeline_on_and_off(case, monkeypatch):
    """Sequential training: frames bit-identical with the pipeline on and
    off, and equal to the JAX package's (which runs its sequential loop on
    the CPU)."""
    name, opts = CASES[case]
    monkeypatch.setenv("DELPHI_PIPELINE", "0")
    off = _repair(T, name, opts)
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    counters.clear()
    on = _repair(T, name, opts)
    assert counters.get("pipeline.runs", 0) >= 1
    pd.testing.assert_frame_equal(on, off)
    want = _repair(J, name, opts)
    pd.testing.assert_frame_equal(on, want)
    assert _no_pipeline_threads()


def test_batched_cv_sets_bit_identical_with_pipeline_on_and_off(
        monkeypatch):
    """The batched route's CV sets go through the pipeline too
    (``_prep_cv_set`` / ``_search_cv_set``): frames bit-identical on and
    off."""
    monkeypatch.setenv("DELPHI_PIPELINE", "0")
    off = _repair(T, "missing_heavy", {}, batched=True)
    monkeypatch.setenv("DELPHI_PIPELINE", "1")
    on = _repair(T, "missing_heavy", {}, batched=True)
    pd.testing.assert_frame_equal(on, off)
    assert len(on) > 0 and not on["repaired"].isna().any()


def test_batch_train_setting_forces_the_route(monkeypatch):
    """``DELPHI_BATCH_TRAIN=1/0`` forces batched or sequential training as
    in the JAX package; either way the frame is the JAX package's."""
    want = _repair(J, "missing_heavy", {"model.hp.max_evals": "1"})
    for setting, route_counter in (("1", "train.batched_gbdt_targets"),
                                   ("0", None)):
        monkeypatch.setenv("DELPHI_BATCH_TRAIN", setting)
        counters.clear()
        got = _repair(T, "missing_heavy", {"model.hp.max_evals": "1"},
                      batched=setting == "0")
        if route_counter:
            assert counters.get(route_counter, 0) > 0
        else:
            assert "train.batched_gbdt_targets" not in counters
        pd.testing.assert_frame_equal(got, want)
