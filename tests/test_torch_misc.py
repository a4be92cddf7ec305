"""``delphi.misc`` of the port against the JAX package's, on the CPU: every
operation on the adult lookalike (and small tables), the q-gram features,
k-means and bisecting k-means labels on the same features (held equal),
the degenerate-row split, the dependency graph's dot text, and the option
checks.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.ops import cluster as j_cluster
from delphi_tpu.session import AnalysisException as JAnalysisException
from delphi_tpu_torch.ops import cluster as t_cluster
from delphi_tpu_torch.session import AnalysisException as TAnalysisException
from delphi_tpu_torch.session import get_session as t_session

from conftest import load_testdata


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


@pytest.fixture
def register(session):
    """Registers a frame under one name in both packages' catalogs."""
    def reg(name, df):
        session.register(name, df)
        t_session().register(name, df)
    yield reg
    for name in list(t_session().table_names()):
        t_session().drop(name)


@pytest.fixture
def adult(register):
    df = load_testdata("adult.csv")
    register("adult", df)
    return df


def both(op, opts):
    """(JAX result, port result) of one misc operation."""
    return tuple(getattr(lib.delphi.misc.options(dict(opts)), op)()
                 for lib in (J, T))


def assert_same_error(op, opts, exc=ValueError, match=None):
    with pytest.raises(exc, match=match) as want:
        getattr(J.delphi.misc.options(dict(opts)), op)()
    with pytest.raises(exc, match=match) as got:
        getattr(T.delphi.misc.options(dict(opts)), op)()
    assert str(got.value) == str(want.value)


def test_misc_is_a_repair_misc():
    assert isinstance(T.delphi.misc, T.RepairMisc)


@pytest.mark.parametrize("op", ["flatten", "repair", "describe",
                                "splitInputTable", "injectNull",
                                "toHistogram", "toErrorMap",
                                "generateDepGraph"])
def test_required_options_like_jax(op):
    assert_same_error(op, {}, match="Required options not found")


def test_flatten_matches_jax(adult):
    want, got = both("flatten", {"table_name": "adult", "row_id": "tid"})
    assert len(got) == 20 * 7 and got["value"].isna().sum() == 7
    pd.testing.assert_frame_equal(got, want)


def test_repair_matches_jax(adult, register):
    register("predicted", pd.DataFrame({
        "tid": [3, 12, 16], "attribute": ["Sex", "Age", "Income"],
        "repaired": ["Female", "18-21", "MoreThan50K"]}))
    want, got = both("repair", {"repair_updates": "predicted",
                                "table_name": "adult", "row_id": "tid"})
    assert got[got.tid == 3]["Sex"].iloc[0] == "Female"
    pd.testing.assert_frame_equal(got, want)
    register("int_base", pd.DataFrame({"tid": [0, 1, 2], "v": [10, 20, 30],
                                       "f": [0.5, 1.5, 2.5],
                                       "w": ["a", "b", "c"]}))
    register("int_updates", pd.DataFrame({
        "tid": [0, 1, 2, 9], "attribute": ["v", "f", "v", "v"],
        "repaired": ["14.7", "3", None, "1"]}))
    want, got = both("repair", {"repair_updates": "int_updates",
                                "table_name": "int_base", "row_id": "tid"})
    pd.testing.assert_frame_equal(got, want)
    register("bad_updates", pd.DataFrame({"tid": [0], "attribute": ["v"]}))
    with pytest.raises(TAnalysisException, match="must have"):
        T.delphi.misc.options({"repair_updates": "bad_updates",
                               "table_name": "int_base",
                               "row_id": "tid"}).repair()


def test_describe_matches_jax(adult, register):
    want, got = both("describe", {"table_name": "adult"})
    assert got.set_index("attrName").loc["Sex", "nullCnt"] == 3
    pd.testing.assert_frame_equal(got, want)
    register("nums", pd.DataFrame({"id": range(50),
                                   "x": np.linspace(-3, 7, 50),
                                   "n": [None] * 50}))
    want, got = both("describe", {"table_name": "nums", "num_bins": "5"})
    pd.testing.assert_frame_equal(got, want)


def test_inject_null_matches_jax(adult, register):
    opts = {"table_name": "adult", "target_attr_list": "Sex,Age",
            "null_ratio": "0.3", "seed": "7"}
    want, got = both("injectNull", opts)
    assert got["Sex"].isna().sum() > 3
    pd.testing.assert_frame_equal(got, want)
    register("t10", pd.DataFrame({"id": range(10), "v": [1] * 10,
                                  "w": ["y"] * 10}))
    want, got = both("injectNull", {"table_name": "t10",
                                    "target_attr_list": "v",
                                    "null_ratio": "1.0"})
    assert got["v"].isna().all()
    pd.testing.assert_frame_equal(got, want)
    for bad in ({"null_ratio": "nope"}, {"null_ratio": "0"},
                {"seed": "-1"}):
        assert_same_error("injectNull", {"table_name": "t10",
                                         "target_attr_list": "v", **bad})
    assert_same_error("injectNull", {"table_name": "t10",
                                     "target_attr_list": "zz"},
                      exc=(JAnalysisException, TAnalysisException))


def test_to_histogram_matches_jax(adult):
    want, got = both("toHistogram", {"table_name": "adult",
                                     "targets": "Income,Sex,Age"})
    assert list(got["attribute"]) == ["Income", "Sex", "Age"]
    pd.testing.assert_frame_equal(got, want)


def test_to_error_map_matches_jax(adult, register):
    register("err_cells", pd.DataFrame({"tid": [3, 5, 5],
                                        "attribute": ["Sex", "Age", "Sex"]}))
    want, got = both("toErrorMap", {"table_name": "adult", "row_id": "tid",
                                    "error_cells": "err_cells"})
    assert got.set_index("tid")["error_map"].loc[5] == "*---*--"
    pd.testing.assert_frame_equal(got, want)


# -- splitInputTable and its clustering ----------------------------------------

@pytest.mark.parametrize("alg,k", [("bisect-kmeans", 4), ("kmeans++", 4),
                                   ("kmeans++", 2), ("bisect-kmeans", 2)])
def test_split_input_table_matches_jax(adult, alg, k):
    opts = {"table_name": "adult", "row_id": "tid", "k": str(k),
            "clustering_alg": alg}
    want, got = both("splitInputTable", opts)
    assert list(got.columns) == ["tid", "k"] and len(got) == 20
    assert got["k"].nunique() == k
    pd.testing.assert_frame_equal(got, want)
    opts["target_attr_list"] = "Age,Sex,Income"
    want, got = both("splitInputTable", opts)
    pd.testing.assert_frame_equal(got, want)


def test_split_input_table_checks_like_jax(adult):
    base = {"table_name": "adult", "row_id": "tid"}
    assert_same_error("splitInputTable", {**base, "k": "x"},
                      match="must be an integer")
    assert_same_error("splitInputTable", {**base, "k": "2",
                                          "clustering_alg": "dbscan"},
                      match="Unknown clustering")
    assert_same_error("splitInputTable", {**base, "k": "2",
                                          "target_attr_list": "nope"},
                      exc=(JAnalysisException, TAnalysisException))


def _scenario_frame(name, rows):
    df = generate_scenario(name, rows, seed=0).dirty
    return df.drop(columns=["tid"])


@pytest.fixture(params=["native", "python"])
def qgram_backend(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(j_cluster, "get_qgram", lambda: None)
        monkeypatch.setattr(t_cluster, "get_qgram", lambda: None)
    elif t_cluster.get_qgram() is None:
        pytest.skip("native/build/libdelphi_native.so is not built")
    return request.param


@pytest.mark.parametrize("q", [1, 2, 3])
def test_qgram_features_match_jax(qgram_backend, q):
    for name in ("fd_categorical", "numeric_regression"):
        df = _scenario_frame(name, 300)
        got = t_cluster.qgram_features(df, q)
        assert got.dtype == np.float32 and got.shape == (300, 1024)
        np.testing.assert_array_equal(got, j_cluster.qgram_features(df, q))


@pytest.mark.parametrize("name", ["fd_categorical", "missing_heavy",
                                  "numeric_regression"])
def test_kmeans_labels_match_jax(name):
    """Both Lloyd loops from the same k-means++ seeds on the same q-gram
    features: identical labels."""
    X = j_cluster.qgram_features(_scenario_frame(name, 1500), 2)
    for k, seed in ((2, 0), (3, 1), (5, 2)):
        np.testing.assert_array_equal(t_cluster.kmeans(X, k, seed=seed),
                                      j_cluster.kmeans(X, k, seed=seed))
    for k in (2, 4, 7):
        np.testing.assert_array_equal(t_cluster.bisecting_kmeans(X, k),
                                      j_cluster.bisecting_kmeans(X, k))


def test_kmeans_blocks_do_not_change_labels(monkeypatch):
    X = j_cluster.qgram_features(_scenario_frame("fd_categorical", 800), 2)
    want = t_cluster.kmeans(X, 3, seed=4)
    monkeypatch.setattr(t_cluster, "BLOCK_BYTES", 3 * 1024 * 4 * 37)
    np.testing.assert_array_equal(t_cluster.kmeans(X, 3, seed=4), want)


def test_degenerate_rows_match_jax():
    X = np.zeros((6, 8), dtype=np.float32)
    got = t_cluster.bisecting_kmeans(X, 3)
    assert len(set(got.tolist())) == 3
    np.testing.assert_array_equal(got, j_cluster.bisecting_kmeans(X, 3))
    for fn in ("kmeans", "bisecting_kmeans"):
        empty = getattr(t_cluster, fn)(np.zeros((0, 8), np.float32), 3)
        assert empty.dtype == np.int64 and empty.shape == (0,)
    np.testing.assert_array_equal(t_cluster.kmeans(X[:2], 5),
                                  j_cluster.kmeans(X[:2], 5))


# -- generateDepGraph ----------------------------------------------------------

def _dot(lib, tmp_path, opts):
    path = str(tmp_path / lib.__name__)
    lib.delphi.misc.options({**opts, "path": path}).generateDepGraph()
    with open(os.path.join(path, "depgraph.dot")) as f:
        return f.read()


@pytest.mark.parametrize("opts", [
    {"pairwise_attr_stat_threshold": "2.0"},
    {"pairwise_attr_stat_threshold": "2.0", "edge_label": "1",
     "max_attr_value_num": "2", "max_attr_value_length": "4"},
    {"pairwise_attr_stat_threshold": "1.0",
     "target_attr_list": "Sex,Relationship,Income,Age"},
])
def test_dep_graph_dot_matches_jax(adult, tmp_path, opts):
    opts = {"table_name": "adult", **opts}
    want = _dot(J, tmp_path, opts)
    got = _dot(T, tmp_path, opts)
    assert got.startswith("digraph {") and got == want


def test_dep_graph_fd_table_matches_jax(register, tmp_path):
    df = generate_scenario("fd_categorical", 2000, seed=0).dirty
    register("fd", df)
    opts = {"table_name": "fd", "pairwise_attr_stat_threshold": "1.5",
            "edge_label": "1"}
    want = _dot(J, tmp_path, opts)
    assert _dot(T, tmp_path, opts) == want


def test_dep_graph_checks_like_jax(adult, tmp_path):
    assert_same_error("generateDepGraph", {
        "table_name": "adult", "path": str(tmp_path / "g0"),
        "pairwise_attr_stat_threshold": "0.00001"},
        exc=(JAnalysisException, TAnalysisException),
        match="No highly-correlated")
    assert_same_error("generateDepGraph", {
        "table_name": "adult", "path": str(tmp_path / "g1"),
        "max_domain_size": "1"},
        exc=(JAnalysisException, TAnalysisException),
        match="At least two")
    opts = {"table_name": "adult", "path": str(tmp_path / "g2"),
            "pairwise_attr_stat_threshold": "2.0"}
    T.delphi.misc.options(opts).generateDepGraph()
    with pytest.raises(TAnalysisException, match="already exists"):
        T.delphi.misc.options(opts).generateDepGraph()
    T.delphi.misc.options({**opts, "overwrite": "1"}).generateDepGraph()
