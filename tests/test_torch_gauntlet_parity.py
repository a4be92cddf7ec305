"""``run_scenario`` of the port's gauntlet against the JAX package's, on the
CPU, at 160 rows (the size of the JAX package's ``bench.gauntlet_smoke``),
one case per scenario: the injected, repaired and correct cell counts,
cell F1 and the downstream triple are equal, and ``emit_gauntlet_metrics``
lands the same counters and gauges over the five. Each target's
scorecard (from the in-memory provenance ledger) has the same counts; its
confidence statistics agree within 1e-6 except on the scenarios whose
posteriors tie at this size (``POSTERIOR_TIES``).

Both runners use default options (the CV grid search) with the runner's
detectors and its in-memory provenance ledger. Torch runs on one intra-op
thread: the CPU kernels' reduction order follows the thread count, and
the test workers share the host's cores.

The size is 160 rows and not 2,000: one pass of the five scenarios costs
the port about 67 s at 160 rows and 140 s at 2,000 on this kind of host,
and the JAX package more, and this file runs on one test worker.
"""

import numpy as np
import pytest
import torch

import delphi_tpu_torch as T
from delphi_tpu.gauntlet import runner as j_runner
from delphi_tpu.gauntlet.scenarios import generate_scenario as j_generate
from delphi_tpu.observability.registry import MetricsRegistry as JRegistry
from delphi_tpu_torch.gauntlet import runner as t_runner
from delphi_tpu_torch.gauntlet.scenarios import generate_scenario as t_generate
from delphi_tpu_torch.observability.registry import \
    MetricsRegistry as TRegistry

ROWS = 160
SEED = 0
SCENARIOS = ["correlated_multi", "fd_categorical", "missing_heavy",
             "numeric_regression", "wide"]
# scenarios whose posteriors tie at this size: a split whose gains tie in
# the last ulp picks another feature in the CV search's trees, which moves
# confidences (by up to 0.073 on wide's a0_0) but no repair; their
# scorecards' confidence statistics are not compared here, and
# tests/test_torch_cli.py holds two of them within 1e-5 when the port
# repairs with the JAX run's trees
POSTERIOR_TIES = {"correlated_multi", "fd_categorical", "wide"}
CONFIDENCE_TOL = 1e-6
# regression repairs are f32 leaf sums in another order (ROADMAP.md queue
# 3, 3a): the repaired values agree within this relative tolerance
VALUE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("DELPHI_PROVENANCE_PATH", raising=False)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


_CACHE = {}


def _both(name):
    """(JAX result, port result) of one scenario, run once per process."""
    if name not in _CACHE:
        want = j_runner.run_scenario(j_generate(name, ROWS, SEED), seed=SEED)
        got = t_runner.run_scenario(t_generate(name, ROWS, SEED), seed=SEED)
        _CACHE[name] = (want, got)
    return _CACHE[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_run_scenario_matches_jax(name):
    want, got = _both(name)
    assert not want.get("error") and not got.get("error"), (want, got)
    for key in ("rows", "attributes", "targets", "repairs_enabled"):
        assert got[key] == want[key], key
    assert got["repair"] == want["repair"]
    assert got["downstream"] == want["downstream"]
    for key in ("train.regressors", "train.classifiers"):
        assert got["counters"].get(key) == want["counters"].get(key), key
    assert got["repair"]["injected"] > 0 and got["repair"]["repairs"] > 0


def _assert_cards_match(name, got, want):
    """Every count of every target's scorecard equal; the confidence
    statistics within CONFIDENCE_TOL outside POSTERIOR_TIES; repaired
    values equal, numbers within VALUE_RTOL."""
    assert set(got) == set(want) and got
    for attr, w in want.items():
        g = got[attr]
        for key in ("cells_flagged", "cells_repaired", "detectors",
                    "decisions", "domain_size", "escalation",
                    "repair_rate"):
            assert g.get(key) == w.get(key), (attr, key)
        wc, gc = w.get("confidence") or {}, g.get("confidence") or {}
        assert gc.get("count") == wc.get("count"), attr
        if name not in POSTERIOR_TIES:
            assert gc.get("bins") == wc.get("bins"), attr
            for key in ("sum", "min", "max", "mean"):
                if wc.get(key) is not None:
                    assert abs(gc[key] - wc[key]) <= CONFIDENCE_TOL, \
                        (attr, key, gc[key], wc[key])
        gv, wv = g["repaired_values"], w["repaired_values"]
        if gv == wv:
            continue
        assert sum(gv.values()) == sum(wv.values()), attr
        by_value = lambda kv: float(kv[0])  # noqa: E731
        for (a, na), (b, nb) in zip(sorted(gv.items(), key=by_value),
                                    sorted(wv.items(), key=by_value)):
            assert na == nb and abs(float(a) - float(b)) <= \
                VALUE_RTOL * max(1.0, abs(float(b))), (attr, a, b)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scorecards_match_jax(name):
    want, got = _both(name)
    _assert_cards_match(name, got["scorecards"], want["scorecards"])


def _report(results, rows):
    f1s = [s["repair"]["f1"] for s in results.values()]
    gaps = [s["downstream"]["gap_closed"] for s in results.values()
            if s["downstream"]["gap_closed"] is not None]
    return {"scenarios": results, "rows": rows,
            "mean_f1": round(sum(f1s) / len(f1s), 4),
            "mean_gap_closed":
                round(sum(gaps) / len(gaps), 4) if gaps else None}


def test_emit_gauntlet_metrics_matches_jax_over_the_five():
    runs = {n: _both(n) for n in SCENARIOS}
    j_reg, t_reg = JRegistry(), TRegistry()
    j_runner.emit_gauntlet_metrics(
        j_reg, _report({n: w for n, (w, _) in runs.items()}, ROWS))
    t_runner.emit_gauntlet_metrics(
        t_reg, _report({n: g for n, (_, g) in runs.items()}, ROWS))
    want, got = j_reg.snapshot(), t_reg.snapshot()
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert got["counters"]["gauntlet.scenarios"] == len(SCENARIOS)
    assert np.isfinite(got["gauges"]["gauntlet.mean_f1"])
