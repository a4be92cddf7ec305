"""Whole runs of the port with every detector kind, against the JAX
package's on the CPU: ``detect_errors_only`` frames on the five gauntlet
scenarios (2k rows, the gauntlet runner's detector set rebuilt from each
package's classes) and on the adult and hospital fixtures, identical
frames; full ``run()`` frames at default options, equal apart from
logistic-head repairs whose top-two probability gap in the JAX package is
under ``NEAR_TIE``; the one-tuple DC minimization changing the same cells
in both packages; the default detector set, user-supplied error cells and
repair validation.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import model as j_model
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.models import linear as j_linear
from delphi_tpu_torch import model as t_model
from delphi_tpu_torch.utils import counters

from conftest import TESTDATA

# top-two probability gap under which a logistic-head repair may differ
# (the same rule as tests/test_torch_pipeline.py)
NEAR_TIE = 1e-4

SCENARIOS = ["correlated_multi", "fd_categorical", "missing_heavy",
             "numeric_regression", "wide"]


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


def detectors(lib, data):
    """The gauntlet runner's detector set (``runner._detectors``) built
    from ``lib``'s classes."""
    dets = [lib.NullErrorDetector()]
    for attr, pattern in data.regexes:
        dets.append(lib.RegExErrorDetector(attr, pattern))
    if data.constraints:
        dets.append(lib.ConstraintErrorDetector(constraints=data.constraints))
    if data.outlier_detection:
        dets.append(lib.GaussianOutlierErrorDetector())
    return dets


def scenario_model(lib, name):
    sc = generate_scenario(name, 2000, seed=0)
    return lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
        .setErrorDetectors(detectors(lib, sc)).setTargets(list(sc.targets))


def lookalike(name):
    if name == "hospital":
        return pd.read_csv(TESTDATA / "hospital.csv", dtype=str) \
            .astype({"tid": int})
    return pd.read_csv(TESTDATA / f"{name}.csv")


def fixture_model(lib, name, copies=1):
    """NULL + the fixture's constraint file; ``copies`` stacks the table
    that many times under fresh row ids."""
    df = lookalike(name)
    df = pd.concat([df.assign(tid=df["tid"] + 1000 * i)
                    for i in range(copies)], ignore_index=True)
    return lib.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
        lib.NullErrorDetector(),
        lib.ConstraintErrorDetector(
            constraint_path=str(TESTDATA / f"{name}_constraints.txt"))])


def _null_safe_equal(a, b):
    a, b = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
    na, nb = pd.isna(a), pd.isna(b)
    return (na & nb) | (~na & ~nb & (a.astype(str) == b.astype(str)))


class _RevertLedger:
    """Stands in for the JAX package's provenance ledger while its
    one-tuple DC minimization runs: keeps the cells it reverted (a
    ``dc_minimized_revert`` decision not cleared again by the fixpoint
    pass)."""

    def __init__(self):
        self.reverted = set()

    def record_decision(self, row_id, attr, decision, reason):
        if reason == "dc_minimized_revert":
            self.reverted.add((row_id, attr))

    def clear_decision(self, row_id, attr):
        self.reverted.discard((row_id, attr))


def traced_run(lib, model, **kw):
    """``model.run(**kw)`` plus what it decided along the way: the
    (row id, attribute) cells the one-tuple DC minimization reverted, and,
    for the JAX package, the logistic-head predictions whose top-two
    probability gap is under NEAR_TIE."""
    rm = j_model.RepairModel if lib is J else t_model.RepairModel
    orig_min, orig_repair = rm._minimize_one_tuple_dc_repairs, rm._repair
    reverted, ties = set(), set()

    def minimize(self, *args):
        if lib is T:
            out = orig_min(self, *args)
            reverted.update(self._dc_reverted)
            return out
        ledger, active = _RevertLedger(), j_model.active_ledger
        j_model.active_ledger = lambda: ledger
        try:
            out = orig_min(self, *args)
        finally:
            j_model.active_ledger = active
        reverted.update(ledger.reverted)
        return out

    def repair(self, models, continuous_columns, dirty_rows_df, *a, **k):
        for y, (m, features, transformers) in models:
            if not isinstance(m, j_linear.LogisticRegressionModel):
                continue
            miss = dirty_rows_df[y].isna().to_numpy()
            if miss.any():
                X = self._encode_features(
                    transformers, dirty_rows_df[features][miss])
                p = np.sort(np.asarray(m.predict_proba(X)), axis=1)
                rid = dirty_rows_df[self._row_id].to_numpy()[miss]
                ties.update((r, y) for r in rid[p[:, -1] - p[:, -2] < NEAR_TIE])
        return orig_repair(self, models, continuous_columns, dirty_rows_df,
                           *a, **k)

    rm._minimize_one_tuple_dc_repairs = minimize
    if lib is J:
        rm._repair = repair
    try:
        out = model.run(**kw)
    finally:
        rm._minimize_one_tuple_dc_repairs = orig_min
        rm._repair = orig_repair
    return out, reverted, ties


def assert_runs_match(got, want, ties):
    """Identical frames once the cells that differ are set aside, and
    every cell that differs (in value, or present in one frame only) is a
    JAX logistic-head prediction under the NEAR_TIE gap."""
    key = ["tid", "attribute"]
    m = want.merge(got, on=key, how="outer", suffixes=("_j", "_t"),
                   indicator=True)
    both = (m["_merge"] == "both").to_numpy()
    same = both & _null_safe_equal(m["repaired_j"], m["repaired_t"])
    differ = set(map(tuple, m.loc[~same, key].to_numpy().tolist()))
    print(f"{len(differ)} cells differ, all near-ties: "
          f"{sorted(differ)[:10]}; {len(ties)} near-ties in all")
    assert differ <= ties, sorted(differ - ties)[:20]

    def rest(frame):
        keep = [tuple(k) not in differ
                for k in frame[key].to_numpy().tolist()]
        return frame[keep].reset_index(drop=True)

    pd.testing.assert_frame_equal(rest(got), rest(want))


@pytest.mark.parametrize("name", SCENARIOS)
def test_detect_errors_only_gauntlet_matches_jax(name):
    want = scenario_model(J, name).run(detect_errors_only=True)
    got = scenario_model(T, name).run(detect_errors_only=True)
    assert len(got) > 0
    assert got.equals(want)


@pytest.mark.parametrize("name", ["adult", "hospital"])
def test_detect_errors_only_fixtures_match_jax(name):
    want = fixture_model(J, name).run(detect_errors_only=True)
    got = fixture_model(T, name).run(detect_errors_only=True)
    assert len(got) > 0
    assert got.equals(want)


def test_full_run_fd_categorical_matches_jax():
    """Default options with the runner's detectors: NULL, the `state`
    regex and the FD constraints (correlated_multi and numeric_regression
    are in tests/test_torch_detect_runs.py)."""
    want, _, ties = traced_run(J, scenario_model(J, "fd_categorical"))
    got, _, _ = traced_run(T, scenario_model(T, "fd_categorical"))
    assert len(got) > 0
    assert_runs_match(got, want, ties)


@pytest.mark.parametrize("copies", [1, 2])
def test_full_run_adult_matches_jax_and_minimizes_alike(copies):
    """The README's adult call (NULL + the one-tuple constraint file) at
    default options: identical frames, and the one-tuple DC minimization
    reverts the same cells in both packages. In the fixture alone weak
    labelling demotes each violating row's Relationship cell, so only Sex
    is left to repair; stacked twice, both cells of a violating row stay
    flagged and the minimization reverts one of them."""
    want, j_reverted, _ = traced_run(J, fixture_model(J, "adult", copies))
    counters.clear()
    got, t_reverted, _ = traced_run(T, fixture_model(T, "adult", copies))
    assert len(got) > 0
    assert got.equals(want)
    assert t_reverted == j_reverted
    assert counters["repair.dc_reverted"] == len(t_reverted)
    if copies == 2:
        assert len(t_reverted) >= 1


def test_default_detectors_match_jax():
    """No detectors set: NULL + DomainValues(autofill, min_count_thres=4)
    per target."""
    def model(lib):
        sc = generate_scenario("fd_categorical", 2000, seed=0)
        return lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
            .setTargets(list(sc.targets))

    assert model(J).run(detect_errors_only=True).equals(
        model(T).run(detect_errors_only=True))
    want, _, ties = traced_run(J, model(J))
    got, _, _ = traced_run(T, model(T))
    assert len(got) > 0
    assert_runs_match(got, want, ties)


def _truth_cells():
    sc = generate_scenario("fd_categorical", 2000, seed=0)
    return sc, pd.DataFrame(sorted(sc.truth), columns=["tid", "attribute"])


@pytest.mark.parametrize("given_as", ["frame", "table name"])
def test_error_cells_match_jax(given_as):
    """setErrorCells with the injected cells, as a DataFrame and as a
    registered table: no detection, no demotion, the same repairs."""
    sc, cells = _truth_cells()
    out = []
    for lib in (J, T):
        error_cells = cells
        if given_as == "table name":
            error_cells = lib.delphi.register_table("fd_truth_cells", cells)
        m = lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
            .setTargets(list(sc.targets)).setErrorCells(error_cells)
        detected = m.run(detect_errors_only=True)
        assert len(detected) == len(cells)
        out.append(traced_run(lib, m))
    (want, _, ties), (got, _, _) = out
    assert_runs_match(got, want, ties)


def test_repair_validation_matches_jax():
    """repair_validation_enabled: the NULL repairs that would break the
    one-tuple constraint (region_1 on channel ch_2) are dropped, the same
    ones in both packages."""
    sc = generate_scenario("fd_categorical", 2000, seed=0)
    constraint = 't1&EQ(t1.region,"region_1")&EQ(t1.channel,"ch_2")'
    runs = {}
    for lib in (J, T):
        for validate in (False, True):
            m = lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
                .setTargets(list(sc.targets)).setErrorDetectors([
                    lib.NullErrorDetector(),
                    lib.ConstraintErrorDetector(constraints=constraint)])
            m.repair_validation_enabled = validate
            runs[lib, validate] = traced_run(lib, m)
    for validate in (False, True):
        (want, _, ties), (got, _, _) = runs[J, validate], runs[T, validate]
        assert_runs_match(got, want, ties)

    def dropped(lib):
        key = ["tid", "attribute"]
        kept = set(map(tuple, runs[lib, True][0][key].to_numpy().tolist()))
        return {k for k in map(tuple, runs[lib, False][0][key].to_numpy()
                               .tolist()) if k not in kept}

    assert dropped(T) == dropped(J)
    assert len(dropped(T)) > 0
