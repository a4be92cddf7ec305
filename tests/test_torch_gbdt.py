"""The port's GBDT against the JAX package's: bin edges, one tree's
splits and leaves on the same inputs, and inference from the JAX-fitted
state (``GradientBoostedTreesModel.from_state``) for all three
objectives. Runs on the CPU; the JAX side takes its CPU (scatter
histogram) route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delphi_tpu.models import gbdt as j_gbdt
from delphi_tpu_torch import set_device
from delphi_tpu_torch.models import gbdt as t_gbdt


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield
    set_device(None)


def _features(rng, n):
    X = np.column_stack([
        rng.integers(0, 7, n).astype(np.float64),          # few values
        rng.normal(size=n),                                 # quantiles
        np.round(rng.uniform(0, 3, n), 1),                  # ~31 values
        np.full(n, 2.5),                                    # constant
    ])
    X[rng.random(n) < 0.1, 1] = np.nan
    X[rng.random(n) < 0.05, 0] = np.nan
    return X


@pytest.mark.parametrize("max_bin", [63, 8])
def test_binner_edges_identical(max_bin):
    X = _features(np.random.default_rng(max_bin), 1500)
    jb = j_gbdt._Binner(max_bin).fit(X)
    tb = t_gbdt._Binner(max_bin).fit(X)
    assert len(jb.edges) == len(tb.edges)
    for ej, et in zip(jb.edges, tb.edges):
        np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(jb.transform(X), tb.transform(X))


TREE_CASES = [
    # (objective-like channels, depth, reg_lambda, min_child_weight,
    #  min_child_samples)
    ("binary", 5, 1.0, 1.0, 0.0),
    ("regression", 3, 3.0, 1.0, 0.0),
    ("binary", 4, 0.15, 0.5, 5.0),
]


@pytest.mark.parametrize("kind,depth,lam,mcw,mcs", TREE_CASES)
def test_build_tree_identical_splits(kind, depth, lam, mcw, mcs):
    """Same bins, grad, hess and weight: feat and thr identical, leaves
    within 1e-5 (the JAX leaf sums are a matmul, the port's a sequential
    segment sum)."""
    rng = np.random.default_rng(depth)
    n, n_bins = 1200, 64
    bins = j_gbdt._Binner(n_bins - 1).fit(_features(rng, n)).transform(
        _features(rng, n))
    weight = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    weight[rng.random(n) < 0.05] = 0.0
    if kind == "binary":
        p = rng.uniform(0.05, 0.95, n).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32)
        grad = ((p - y) * weight).astype(np.float32)
        hess = (np.maximum(p * (1 - p), 1e-6) * weight).astype(np.float32)
    else:
        grad = (rng.normal(size=n).astype(np.float32) * weight)
        hess = weight.copy()
    use_counts = mcs > 0
    jf, jt, jl, _ = j_gbdt._build_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(weight), depth, n_bins, 1 << depth, lam, 0.0, mcw, mcs,
        use_scatter=True, use_counts=use_counts,
        hess_is_weight=kind == "regression")
    tf, tt, tl, _ = t_gbdt._build_trees(
        torch.from_numpy(bins).long(), torch.from_numpy(grad)[None],
        torch.from_numpy(hess)[None], torch.from_numpy(weight), depth,
        n_bins, lam, 0.0, mcw, mcs, use_counts=use_counts,
        hess_is_weight=kind == "regression")
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
    assert (np.asarray(jt) < n_bins).any(), "the tree must split"
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)


def _state(m):
    return {
        "edges": [np.asarray(e) for e in m._binner.edges],
        "trees": tuple(np.asarray(t) for t in m._trees),
        "base": np.asarray(m._base),
        "objective": m._objective,
        "k": m._k,
        "classes": np.asarray(m._classes),
        "fit_class_weights": getattr(m, "_fit_class_weights", None),
        "log_target": getattr(m, "_log_target", False),
        "n_estimators": m.n_estimators,
        "max_depth": m.max_depth,
    }


def _task(kind, rng, n):
    X = _features(rng, n)
    signal = np.nan_to_num(X[:, 1]) + 0.5 * np.nan_to_num(X[:, 0])
    if kind == "binary":
        y = np.where(signal + rng.normal(0, 0.3, n) > 1.0, "yes", "no")
    elif kind == "multiclass":
        y = np.array([f"c{int(v) % 5}" for v in
                      np.clip(signal + X[:, 2], 0, 20)], dtype=object)
    else:
        y = 3.0 * signal - X[:, 2] + rng.normal(0, 0.1, n)
    return X, y


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_from_state_predicts_like_jax(kind):
    rng = np.random.default_rng(len(kind))
    X, y = _task(kind, rng, 1200)
    X_test, _ = _task(kind, rng, 500)
    discrete = kind != "regression"
    n_class = len(np.unique(y)) if discrete else 0
    jm = j_gbdt.GradientBoostedTreesModel(
        is_discrete=discrete, num_class=n_class, max_depth=3,
        n_estimators=60, reg_lambda=3.0, learning_rate=0.1).fit(X, y)
    tm = t_gbdt.GradientBoostedTreesModel.from_state(_state(jm))
    want, got = jm.predict(X_test), tm.predict(X_test)
    if discrete:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tm.predict_proba(X_test),
                                   jm.predict_proba(X_test), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_fit_matches_jax_fit(kind):
    """The port's own fit on the same data: identical first-round splits,
    identical class predictions, regression within 1e-5 relative plus 1e-6
    absolute (each round's f32 leaves differ from the JAX matmul sums in
    the last ulp, which near-zero predictions cannot absorb relatively)."""
    rng = np.random.default_rng(7 + len(kind))
    X, y = _task(kind, rng, 900)
    X_test, _ = _task(kind, rng, 300)
    discrete = kind != "regression"
    n_class = len(np.unique(y)) if discrete else 0
    kw = dict(is_discrete=discrete, num_class=n_class, max_depth=3,
              n_estimators=40, reg_lambda=1.0, learning_rate=0.1)
    jm = j_gbdt.GradientBoostedTreesModel(**kw).fit(X, y)
    tm = t_gbdt.GradientBoostedTreesModel(**kw).fit(X, y)
    assert tm.n_estimators == jm.n_estimators
    np.testing.assert_array_equal(tm._trees[0][0], np.asarray(jm._trees[0][0]))
    np.testing.assert_array_equal(tm._trees[1][0], np.asarray(jm._trees[1][0]))
    if discrete:
        np.testing.assert_array_equal(tm.predict(X_test), jm.predict(X_test))
    else:
        np.testing.assert_allclose(tm.predict(X_test), jm.predict(X_test),
                                   rtol=1e-5, atol=1e-6)


def test_transcendentals_round_the_f64_result():
    """``_exp``, ``_log`` and ``_sigmoid`` give the f64 result rounded to
    f32 (then f32 arithmetic for the sigmoid), bits that do not depend on
    the device's f32 ``exp``."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 6, 100_000).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        t_gbdt._exp(t).numpy(), np.exp(x.astype(np.float64)).astype(np.float32))
    pos = np.abs(x) + np.float32(1e-3)
    np.testing.assert_array_equal(
        t_gbdt._log(torch.from_numpy(pos)).numpy(),
        np.log(pos.astype(np.float64)).astype(np.float32))
    e = np.exp(-x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        t_gbdt._sigmoid(t).numpy(),
        np.float32(1) / (np.float32(1) + e))
