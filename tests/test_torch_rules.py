"""Rule repairs of the port against the JAX package's, on the CPU: the
update cost functions (native and pure-Python Levenshtein, user-defined),
regex-structure repair, the functional dependencies read from denial
constraints and data, the encoded table's rule-repair updates, and whole
``setRepairByRules(True)`` runs (the hospital example's set-up on the
hospital lookalike; a 2k-row fd_categorical table with regex and
nearest-value repairs under a Levenshtein cost function), whose frames and
chosen FD rule models must be identical.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import costs as j_costs
from delphi_tpu import depgraph as j_depgraph
from delphi_tpu import model as j_model
from delphi_tpu import regex_repair as j_regex
from delphi_tpu import table as j_table
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu_torch import costs as t_costs
from delphi_tpu_torch import depgraph as t_depgraph
from delphi_tpu_torch import model as t_model
from delphi_tpu_torch import regex_repair as t_regex
from delphi_tpu_torch import table as t_table
from delphi_tpu_torch.utils import counters

from conftest import TESTDATA, load_testdata

# the regex and nearest-value rules are off by default; an option's string
# turns it off when non-empty (Python truthiness, as in the JAX package)
RULES_ON = {"model.rule.repair_by_regex.disabled": "",
            "model.rule.repair_by_nearest_values.disabled": ""}


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


@pytest.fixture(params=["native", "python"])
def levenshtein_backend(request, monkeypatch):
    """Both packages on the native batch distance, then both on the
    pure-Python path."""
    if request.param == "python":
        monkeypatch.setattr(j_costs, "get_levenshtein", lambda: None)
        monkeypatch.setattr(t_costs, "get_levenshtein", lambda: None)
    elif t_costs.get_levenshtein() is None:
        pytest.skip("native/build/libdelphi_native.so is not built")
    return request.param


# -- costs -------------------------------------------------------------------

WORDS = ["kitten", "sitting", "abc", "abd", "", None, "café", "cafe",
         "state_01", "tsate_01", "stxte_01", "state01", "100", "100.0"]


def test_levenshtein_matches_jax(levenshtein_backend):
    for targets in ([], ["state"]):
        jc, tc = j_costs.Levenshtein(targets), t_costs.Levenshtein(targets)
        assert str(tc) == str(jc) and tc.targets == jc.targets
        for x in WORDS:
            assert tc.compute_many(x, WORDS) == jc.compute_many(x, WORDS), x
            for y in WORDS:
                assert tc.compute(x, y) == jc.compute(x, y), (x, y)
    assert t_costs.Levenshtein().compute("kitten", "sitting") == 3.0


def test_user_defined_cost_function_matches_jax():
    def f(x, y):
        return float(len(x) * 10 + len(y))

    jc = j_costs.UserDefinedUpdateCostFunction(f, targets=["a"])
    tc = t_costs.UserDefinedUpdateCostFunction(f, targets=["a"])
    assert str(tc) == str(jc)
    for x in WORDS:
        assert tc.compute_many(x, WORDS) == jc.compute_many(x, WORDS)
    for bad in (lambda x, y: "not a float", lambda x: 1.0):
        with pytest.raises(ValueError, match="float cost value"):
            t_costs.UserDefinedUpdateCostFunction(bad)


# -- regex structure repair --------------------------------------------------

@pytest.mark.parametrize("pattern,cases", [
    ("^[0-9]{1,3} patients$", [
        ("32 patixxts", "32 patients"),
        ("619 paxienxs", "619 patients"),
        ("x2 patixxts", None)]),
    ("^[0-9]{1,3}%", [
        ("33x", "33%"),
        ("x2%", None)]),
    ("^[0-9]{2}-[0-9]{2}-[0-9]{2}-[0-9]{2}$", [
        ("23.39.23.11", "23-39-23-11"),
        ("23.x9.2x.1x", None)]),
    ("^state_[0-9]{2}$", [
        ("tsate_07", "state_07"), ("state07", "state_07"),
        ("stxte_11", "state_11"), ("s_1", None), (None, None)]),
])
def test_regex_structure_repair_matches_jax(pattern, cases):
    assert t_regex.parse(pattern) == [
        (t_regex.RegexTokenType(t.value), s) for t, s in j_regex.parse(pattern)]
    jr, tr = j_regex.RegexStructureRepair(pattern), \
        t_regex.RegexStructureRepair(pattern)
    for dirty, expected in cases:
        assert tr(dirty) == jr(dirty) == expected, (pattern, dirty)


def test_regex_tokenize_rejects_like_jax():
    for pattern in ("^(a|b)$", "[0-9]{2}\\d"):
        with pytest.raises(ValueError) as want:
            j_regex.tokenize(pattern)
        with pytest.raises(ValueError) as got:
            t_regex.tokenize(pattern)
        assert str(got.value) == str(want.value)


# -- functional dependencies ---------------------------------------------------

def test_functional_deps_match_jax():
    cols = ["tid", "city", "state", "region", "zip"]
    cases = [
        ("", "city->state;state->region", ["state", "region"]),
        ("", "city->state;state->region", ["region"]),
        ("", "city->state;state->city", ["state", "city"]),
        ("", "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city);zip->state",
         ["city", "state"]),
        (str(TESTDATA / "hospital_constraints.txt"), "", []),
    ]
    hospital_cols = list(load_testdata("hospital.csv", dtype=str).columns)
    for path, stmts, targets in cases:
        columns = hospital_cols if path else cols
        targets = targets or hospital_cols
        want = j_depgraph.compute_functional_deps(
            pd.DataFrame(columns=columns), path, stmts, targets)
        got = t_depgraph.compute_functional_deps(
            pd.DataFrame(columns=columns), path, stmts, targets)
        assert got == want and (got or path), (stmts, targets)


def test_functional_dep_map_matches_jax():
    rng = np.random.RandomState(3)
    n = 500
    x = rng.randint(0, 30, n)
    df = pd.DataFrame({
        "x": [f"x{v}" for v in x],
        "y": [f"y{v % 7}" if i % 50 else f"y{(v + 1) % 7}"
              for i, v in enumerate(x)],
        "n": (x % 5).astype(float),
    })
    df.loc[rng.rand(n) < 0.1, "y"] = None
    df.loc[rng.rand(n) < 0.1, "n"] = np.nan
    for a, b, functional in (("x", "y", True), ("x", "n", True),
                             ("n", "x", False)):
        want = j_depgraph.compute_functional_dep_map(df, a, b)
        assert t_depgraph.compute_functional_dep_map(df, a, b) == want
        assert bool(want) == functional


def test_rule_models_match_jax():
    fd = {"a": "1", "b": "2", "c": "1"}
    X = pd.DataFrame({"x": ["a", "b", "zz", "c"]})
    jm, tm = j_model.FunctionalDepModel("x", fd), \
        t_model.FunctionalDepModel("x", fd)
    assert tm.classes_.tolist() == jm.classes_.tolist() == ["1", "2"]
    assert tm.predict(X) == jm.predict(X) == ["1", "2", None, "1"]
    for p, q in zip(tm.predict_proba(X), jm.predict_proba(X)):
        assert (p is None and q is None) or p.tolist() == q.tolist()
    for v in ("v", None):
        jp, tp = j_model.PoorModel(v), t_model.PoorModel(v)
        assert tp.classes_.tolist() == jp.classes_.tolist()
        assert tp.predict(X) == jp.predict(X)


def test_table_with_updates_matches_jax():
    df = pd.DataFrame({"tid": range(6), "s": ["a", "b", None, "a", "c", "b"],
                       "i": [1, 2, 3, 4, 5, 6],
                       "f": [0.5, 1.5, np.nan, 2.5, 3.5, 4.5]})
    cells = [(0, "s", "z"), (2, "s", "a"), (1, "i", "7.6"), (3, "i", "-0.4"),
             (4, "f", "-0.0"), (2, "f", "9.25"), (5, "s", None)]
    want = j_table.encode_table(df, "tid").with_updates(cells)
    got = t_table.encode_table(df, "tid").with_updates(cells)
    for jc, tc in zip(want.columns, got.columns):
        assert tc.codes.tolist() == jc.codes.tolist()
        assert tc.vocab.tolist() == jc.vocab.tolist()
        if jc.numeric is not None:
            np.testing.assert_array_equal(tc.numeric, jc.numeric)
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())


# -- whole runs ----------------------------------------------------------------

def _traced(lib, model, **kw):
    """(frame, target -> FD rule x) of one run of ``model``."""
    mod = j_model if lib is J else t_model
    fds = {}
    orig = mod.RepairModel._build_repair_models

    def build(self, *args, **kwargs):
        models = orig(self, *args, **kwargs)
        fds.update({y: m.x for y, (m, _, _) in models
                    if isinstance(m, mod.FunctionalDepModel)})
        return models

    mod.RepairModel._build_repair_models = build
    try:
        return model.run(**kw), fds
    finally:
        mod.RepairModel._build_repair_models = orig


def hospital_model(lib, df, **opts):
    m = lib.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
        lib.NullErrorDetector(),
        lib.ConstraintErrorDetector(
            constraint_path=str(TESTDATA / "hospital_constraints.txt"))]) \
        .setDiscreteThreshold(100).setRepairByRules(True)
    for k, v in opts.items():
        m = m.option(k, v)
    return m


@pytest.mark.parametrize("opts", [{}, {"model.hp.max_evals": "1"}])
def test_hospital_rules_run_matches_jax(opts):
    """The hospital example's set-up (NULL + constraint file detectors,
    discrete threshold 100, FD rule repairs)."""
    df = load_testdata("hospital.csv", dtype=str)
    want, j_fds = _traced(J, hospital_model(J, df, **opts))
    counters.clear()
    got, t_fds = _traced(T, hospital_model(T, df, **opts))
    assert len(got) > 0 and t_fds and t_fds == j_fds
    assert counters.get("train.fd_rule_models") == len(t_fds)
    pd.testing.assert_frame_equal(got, want)


def fd_rules_model(lib, df, cost_targets=("state",), **kw):
    sc = generate_scenario("fd_categorical", 10, seed=0)
    dets = [lib.NullErrorDetector(),
            lib.ConstraintErrorDetector(constraints=sc.constraints)]
    dets += [lib.RegExErrorDetector(a, r) for a, r in sc.regexes]
    m = lib.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors(dets) \
        .setRepairByRules(True) \
        .setUpdateCostFunction(lib.Levenshtein(targets=list(cost_targets)))
    for k, v in {**RULES_ON, **kw}.items():
        m = m.option(k, v)
    return m


def fd_table():
    """The 2k-row fd_categorical scenario with its NULL state cells given a
    typo instead: the JAX package's regex repair raises TypeError on a NULL
    current value that reads back as NaN, as every NULL does from a
    string-dtype frame."""
    df = generate_scenario("fd_categorical", 2000, seed=0).dirty
    df = df.astype(object).where(df.notna(), None)
    df["state"] = [v if v is not None else "stat_00" for v in df["state"]]
    return df


@pytest.mark.parametrize("cost_targets", [("state",), ()])
def test_fd_categorical_rules_run_matches_jax(cost_targets):
    """Regex-structure and nearest-value repairs (Levenshtein, on ``state``
    or on every target) and FD rule models, at default model options."""
    df = fd_table()
    want, j_fds = _traced(J, fd_rules_model(J, df, cost_targets))
    counters.clear()
    got, t_fds = _traced(T, fd_rules_model(T, df, cost_targets))
    assert t_fds == j_fds
    assert counters.get("rules.regex_repairs", 0) > 0
    assert counters.get("rules.nearest_value_repairs", 0) > 0
    pd.testing.assert_frame_equal(got, want)


def test_rules_repair_data_matches_jax():
    df = fd_table()
    want, _ = _traced(J, fd_rules_model(J, df, **{"model.hp.max_evals": "1"}),
                      repair_data=True)
    got, _ = _traced(T, fd_rules_model(T, df, **{"model.hp.max_evals": "1"}),
                     repair_data=True)
    pd.testing.assert_frame_equal(got, want)


def test_regex_rule_leaves_nan_current_values_to_the_models():
    """A NULL that reads back as NaN is not handed to the regex: the cell
    goes to the models, like a None."""
    df = generate_scenario("fd_categorical", 600, seed=1).dirty
    got = fd_rules_model(T, df, **{"model.hp.max_evals": "1"}).run()
    nulls = set(df["tid"][df["state"].isna()])
    state = got[got["attribute"] == "state"]
    assert nulls and nulls <= set(state["tid"])
    assert state[state["tid"].isin(nulls)]["repaired"].notna().all()


def test_nearest_values_reject_pmf_modes():
    df = fd_table()
    for lib in (J, T):
        with pytest.raises(ValueError, match="Cannot repair data by nearest"):
            fd_rules_model(lib, df).run(compute_repair_prob=True)
