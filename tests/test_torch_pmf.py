"""The PMF, score and maximal-likelihood modes of the port against the JAX
package's, on the CPU, and the chunked repair paths against the one-shot
ones.

Tolerance: probabilities within ``PROB_TOL`` (1e-4) absolute; scores,
which are log-probability ratios over 1 + cost, within ``PROB_TOL``
relative and absolute. Class lists are held equal wherever two adjacent
probabilities differ by more than ``PROB_TOL``; a cell whose probability
sits within ``PROB_TOL`` of the ``P > threshold`` cut or the
maximal-likelihood percentile may fall on either side, and each test
bounds how many such cells there are (none on these tables).

End to end, the packages train on a 2k-row ``missing_heavy`` table (no
continuous column, no logistic head): there their probabilities agree to
about 2e-7. On the 20-row adult lookalike the GBDT trees of the two
packages split differently where training rows tie exactly (the same
partition from two features, last-ulp gains), which moves probabilities
by up to 1e-3 (``ROADMAP.md`` queue 3); there the port runs its PMF, score
and maximal-likelihood code on the JAX package's trees (``from_state``),
holding that code to the same tolerance.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import model as j_model
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu_torch import model as t_model
from delphi_tpu_torch.models import gbdt as t_gbdt
from delphi_tpu_torch.utils import counters

from conftest import load_testdata
from test_torch_gbdt import _state

PROB_TOL = 1e-4
KEY = ["tid", "attribute"]


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


@pytest.fixture(scope="module")
def adult():
    return load_testdata("adult.csv")


def _adult_model(lib, df, *dets):
    return lib.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector(), *dets])


_MH = {}


def _missing_heavy():
    if "df" not in _MH:
        df = generate_scenario("missing_heavy", 2000, seed=0).dirty
        _MH["df"] = df.astype(object).where(df.notna(), None)
    return _MH["df"]


def _mh_model(lib, **opts):
    m = lib.delphi.repair.setInput(_missing_heavy()).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .setUpdateCostFunction(lib.Levenshtein()).setRepairDelta(500) \
        .option("error.max_attrs_to_compute_pairwise_stats", "4")
    for k, v in opts.items():
        m = m.option(k, v)
    return m


def _null_eq(a, b):
    na, nb = pd.isna(a), pd.isna(b)
    return (na and nb) or (not na and not nb and a == b)


def assert_pmfs_match(got, want):
    """Candidate-PMF frames: the same cells in the same order, current
    values equal, probabilities within PROB_TOL, class lists equal up to
    near-ties. Returns how many cells sit on the ``P > threshold`` cut
    (their top-k lists differ in length)."""
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[KEY], want[KEY])
    on_cut = 0
    for g, w in zip(got.itertuples(index=False), want.itertuples(index=False)):
        assert _null_eq(g.current_value, w.current_value)
        gc, gp = [e["class"] for e in g.pmf], [e["prob"] for e in g.pmf]
        wc, wp = [e["class"] for e in w.pmf], [e["prob"] for e in w.pmf]
        if len(gc) != len(wc):
            on_cut += 1
            continue
        by_class = dict(zip(gc, gp))
        for c, p in zip(wc, wp):
            assert c in by_class and abs(by_class[c] - p) <= PROB_TOL, (g, w)
        for j in range(len(wp) - 1):
            if wp[j] - wp[j + 1] > PROB_TOL:
                assert set(gc[:j + 1]) == set(wc[:j + 1]), (g, w)
    return on_cut


def _top_two_gaps(pmf_frame):
    return np.array([p[0]["prob"] - p[1]["prob"] if len(p) > 1 else 1.0
                     for p in pmf_frame["pmf"]])


def assert_scores_match(got, want, gaps):
    """Score frames: the same cells and current values, the same repairs
    wherever the top-two gap exceeds PROB_TOL, scores within PROB_TOL."""
    pd.testing.assert_frame_equal(
        got[KEY + ["current_value"]], want[KEY + ["current_value"]])
    tie = gaps <= PROB_TOL
    same = got["repaired"].to_numpy() == want["repaired"].to_numpy()
    assert (same | tie).all()
    np.testing.assert_allclose(got["score"].to_numpy()[same],
                               want["score"].to_numpy()[same],
                               rtol=PROB_TOL, atol=PROB_TOL)


# -- the maximal-likelihood checks ---------------------------------------------

@pytest.mark.parametrize("case", ["no delta", "no cost function",
                                  "cost targets", "continuous",
                                  "exclusive", "exclusive prob"])
def test_mode_checks_raise_like_jax(adult, case):
    def build(lib):
        m = _adult_model(lib, adult)
        if case == "no cost function":
            m = m.setRepairDelta(3)
        elif case == "cost targets":
            m = m.setRepairDelta(3).setUpdateCostFunction(
                lib.Levenshtein(targets=["Sex"]))
        elif case == "continuous":
            df = adult.assign(Hours=np.arange(len(adult), dtype=float))
            m = _adult_model(lib, df).setRepairDelta(3) \
                .setUpdateCostFunction(lib.Levenshtein())
        return m

    kw = {"exclusive": dict(detect_errors_only=True, repair_data=True),
          "exclusive prob": dict(compute_repair_candidate_prob=True,
                                 compute_repair_prob=True)}.get(
        case, dict(maximal_likelihood_repair=True))
    with pytest.raises(ValueError) as want:
        build(J).run(**kw)
    with pytest.raises(ValueError) as got:
        build(T).run(**kw)
    assert str(got.value) == str(want.value)


# -- adult: the JAX package's trees under the port's PMF code ------------------

def _adult_runs(adult, **kw):
    """(JAX frame, port frame) of one mode on adult, the port predicting
    with the JAX package's fitted trees."""
    trees = {}
    j_orig = j_model.RepairModel._build_repair_models
    t_orig = t_model.RepairModel._build_repair_models

    def j_build(self, *args, **kwargs):
        models = j_orig(self, *args, **kwargs)
        trees.update({y: m for y, (m, _, _) in models})
        return models

    def t_build(self, *args, **kwargs):
        return [(y, (t_gbdt.GradientBoostedTreesModel.from_state(
            _state(trees[y])), f, tr)) for y, (_, f, tr) in
            t_orig(self, *args, **kwargs)]

    def build(lib):
        # one config: the JAX package's trees replace the port's anyway
        return _adult_model(lib, adult).setRepairDelta(3) \
            .setUpdateCostFunction(lib.Levenshtein()) \
            .option("model.hp.max_evals", "1")

    j_model.RepairModel._build_repair_models = j_build
    t_model.RepairModel._build_repair_models = t_build
    try:
        return build(J).run(**kw), build(T).run(**kw)
    finally:
        j_model.RepairModel._build_repair_models = j_orig
        t_model.RepairModel._build_repair_models = t_orig


def test_adult_candidate_pmfs_match_jax(adult):
    want, got = _adult_runs(adult, compute_repair_candidate_prob=True)
    assert len(got) == 7
    for pmf in got["pmf"]:
        probs = [e["prob"] for e in pmf]
        assert len(pmf) >= 1 and probs == sorted(probs, reverse=True)
    assert assert_pmfs_match(got, want) == 0


def test_adult_repair_probs_match_jax(adult):
    want, got = _adult_runs(adult, compute_repair_prob=True)
    assert sorted(got.columns) == ["attribute", "current_value", "prob",
                                   "repaired", "tid"]
    assert len(got) == 7 and ((got["prob"] > 0) & (got["prob"] <= 1)).all()
    pd.testing.assert_frame_equal(got.drop(columns=["prob"]),
                                  want.drop(columns=["prob"]))
    np.testing.assert_allclose(got["prob"], want["prob"], atol=PROB_TOL)


def test_adult_scores_match_jax(adult):
    gaps = _top_two_gaps(_adult_runs(
        adult, compute_repair_candidate_prob=True)[0])
    want, got = _adult_runs(adult, compute_repair_score=True)
    assert list(got.columns) == ["tid", "attribute", "current_value",
                                 "repaired", "score"]
    assert_scores_match(got, want, gaps)


@pytest.mark.parametrize("repair_data", [False, True])
def test_adult_maximal_likelihood_matches_jax(adult, repair_data):
    want, got = _adult_runs(adult, maximal_likelihood_repair=True,
                            repair_data=repair_data)
    if not repair_data:
        assert sorted(got.columns) == ["attribute", "current_value",
                                       "repaired", "tid"]
        assert 1 <= len(got) <= 7
    pd.testing.assert_frame_equal(got, want)


# -- missing_heavy: both packages end to end -----------------------------------

_RUNS = {}


def _mh_run(lib, mode, **opts):
    key = (lib.__name__, mode, tuple(sorted(opts.items())))
    if key not in _RUNS:
        kw = {mode: True} if mode != "ml_data" else \
            dict(maximal_likelihood_repair=True, repair_data=True)
        _RUNS[key] = _mh_model(lib, **opts).run(**kw)
    return _RUNS[key]


def test_missing_heavy_candidate_pmfs_match_jax():
    """At default options (the CV grid search for every target)."""
    want = _mh_run(J, "compute_repair_candidate_prob")
    got = _mh_run(T, "compute_repair_candidate_prob")
    assert len(got) == 1320
    assert assert_pmfs_match(got, want) == 0


FAST = {"model.hp.max_evals": "1"}


def test_missing_heavy_repair_probs_match_jax():
    want = _mh_run(J, "compute_repair_prob", **FAST)
    got = _mh_run(T, "compute_repair_prob", **FAST)
    gaps = _top_two_gaps(_mh_run(J, "compute_repair_candidate_prob", **FAST))
    pd.testing.assert_frame_equal(got[KEY + ["current_value"]],
                                  want[KEY + ["current_value"]])
    same = got["repaired"].to_numpy() == want["repaired"].to_numpy()
    assert (same | (gaps <= PROB_TOL)).all()
    np.testing.assert_allclose(got["prob"], want["prob"], atol=PROB_TOL)


def test_missing_heavy_scores_and_maximal_likelihood_match_jax():
    gaps = _top_two_gaps(_mh_run(J, "compute_repair_candidate_prob", **FAST))
    want = _mh_run(J, "compute_repair_score", **FAST)
    got = _mh_run(T, "compute_repair_score", **FAST)
    assert_scores_match(got, want, gaps)
    # the selection keeps score >= the 1 - delta / cells percentile; many
    # cells share one score, so the cut holds a block of them (38 here),
    # which either package keeps whole: a cell may change sides only
    # within PROB_TOL of the cut, and none does on this table
    pct = (1.0 - 500 / len(want)) * 100.0
    w, g = want["score"].to_numpy(), got["score"].to_numpy()
    on_cut = np.abs(w - np.percentile(w, pct)) <= PROB_TOL
    flipped = (w >= np.percentile(w, pct)) != (g >= np.percentile(g, pct))
    assert not (flipped & ~on_cut).any()
    assert flipped.sum() == 0
    ml_want = _mh_run(J, "maximal_likelihood_repair", **FAST)
    ml_got = _mh_run(T, "maximal_likelihood_repair", **FAST)
    assert len(ml_got) >= 500
    pd.testing.assert_frame_equal(ml_got, ml_want)
    data_want = _mh_run(J, "ml_data", **FAST)
    data_got = _mh_run(T, "ml_data", **FAST)
    pd.testing.assert_frame_equal(data_got, data_want)


# -- chunked repair equals the one-shot block ----------------------------------

def _records(frame):
    """Rows as dicts, NULLs as None (a string column of the one-shot frame
    holds NaN where the concatenated chunks hold None)."""
    return frame.astype(object).where(frame.notna(), None).to_dict("records")


@pytest.mark.parametrize("mode", ["compute_repair_candidate_prob",
                                  "compute_repair_prob",
                                  "compute_repair_score",
                                  "maximal_likelihood_repair"])
def test_pmf_modes_chunked_equal_whole_block(mode, monkeypatch):
    whole = _mh_run(T, mode, **FAST)
    monkeypatch.setenv("DELPHI_REPAIR_CHUNK_ROWS", "150")
    counters.clear()
    chunked = _mh_model(T, **FAST).run(**{mode: True})
    assert counters["repair.chunks"] > 1
    assert _records(chunked) == _records(whole)


_ONE_TUPLE = 't1&EQ(t1.Sex,"Female")&EQ(t1.Relationship,"Husband")'


@pytest.mark.parametrize("chunk", ["1", "2", "3"])
def test_candidates_chunked_equal_whole_block(adult, chunk, monkeypatch):
    """Candidates only, with the one-tuple DC minimization per chunk."""
    def run():
        return _adult_model(T, adult, T.ConstraintErrorDetector(
            constraints=_ONE_TUPLE)).option("model.hp.max_evals", "1").run()

    whole = run()
    monkeypatch.setenv("DELPHI_REPAIR_CHUNK_ROWS", chunk)
    counters.clear()
    chunked = run()
    assert counters["repair.chunks"] > 1
    assert len(whole) and _records(chunked) == _records(whole)


def test_candidates_chunked_match_jax_chunked(adult, monkeypatch):
    monkeypatch.setenv("DELPHI_REPAIR_CHUNK_ROWS", "2")
    want, got = (_adult_model(lib, adult, lib.ConstraintErrorDetector(
        constraints=_ONE_TUPLE)).option("model.hp.max_evals", "1").run()
        for lib in (J, T))
    pd.testing.assert_frame_equal(got, want)


def test_pmf_chunked_matches_jax_chunked(adult, monkeypatch):
    monkeypatch.setenv("DELPHI_REPAIR_CHUNK_ROWS", "2")
    want, got = _adult_runs(adult, compute_repair_candidate_prob=True)
    assert assert_pmfs_match(got, want) == 0
    want, got = _adult_runs(adult, maximal_likelihood_repair=True)
    pd.testing.assert_frame_equal(got, want)
