"""The port's logistic and MLP heads against the JAX package's, on the CPU:
class predictions identical and probabilities within 1e-4 on the gather
(factored one-hot) and dense routes, inference from JAX-fitted params
within 1e-5, and an MLP fit from JAX's initial params within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from delphi_tpu.models import encoding as j_enc
from delphi_tpu.models import linear as j_lin
from delphi_tpu_torch import set_device
from delphi_tpu_torch.models import encoding as t_enc
from delphi_tpu_torch.models import linear as t_lin
from delphi_tpu_torch.ops.kernels import linear as k_lin


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    # one intra-op thread: the CPU kernels' reduction order follows the
    # thread count, and the test workers share the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_device(None)


def _frame(k, seed, n=1200):
    """Three categorical features and one numeric; y has ``k`` classes
    driven by a latent column, with 3% of labels redrawn."""
    rng = np.random.default_rng(seed)
    latent = rng.integers(0, k, n)
    df = pd.DataFrame({
        "a": [f"a{v}" for v in latent],
        "b": [f"b{v % 7}" for v in latent + rng.integers(0, 2, n)],
        "c": [f"c{v}" for v in rng.integers(0, 5, n)],
        "x": latent * 0.5 + rng.normal(0, 1, n),
    })
    df.loc[rng.random(n) < 0.1, "a"] = None
    noisy = rng.random(n) < 0.03
    y = np.where(noisy, rng.integers(0, k, n), latent)
    return df, pd.Series([f"y{v}" for v in y])


def _designs(enc_mod, df, compact):
    enc = enc_mod.FeatureEncoder(["a", "b", "c", "x"], ["x"])
    return enc.fit_transform_compact(df) if compact else enc.fit_transform(df)


@pytest.mark.parametrize("k", [30, 50])
@pytest.mark.parametrize("route", ["gather", "dense"])
def test_logistic_head_matches_jax(k, route):
    """100 Adam steps, short of the plateau (these fits exit after 127 to
    170): near it the loss moves about 1e-6 a step, and the two packages'
    f32 sums can end the fit one step apart, which moves probabilities by
    up to 1e-3 (class predictions stayed equal). The exit rule itself is
    tested below."""
    df, y = _frame(k, k)
    compact = route == "gather"
    jm = j_lin.LogisticRegressionModel(n_steps=100).fit(
        _designs(j_enc, df, compact), y)
    tm = t_lin.LogisticRegressionModel(n_steps=100).fit(
        _designs(t_enc, df, compact), y)
    assert tm.n_steps_run_ == 100
    assert (tm._compact is not None) == compact
    test_df, _ = _frame(k, k + 100, n=600)
    Xj, Xt = _designs(j_enc, test_df, compact), _designs(t_enc, test_df,
                                                         compact)
    pj, pt = jm.predict_proba(Xj), tm.predict_proba(Xt)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tm.predict(Xt), jm.predict(Xj))
    np.testing.assert_allclose(tm.loss_, jm.loss_, rtol=1e-4)


def test_logistic_from_jax_state_predicts_like_jax():
    df, y = _frame(40, 7)
    for compact in (True, False):
        X, Xt = _designs(j_enc, df, compact), _designs(t_enc, df, compact)
        jm = j_lin.LogisticRegressionModel().fit(X, y)
        tm = t_lin.LogisticRegressionModel.from_state({
            "classes": jm.classes_,
            "params": tuple(np.asarray(p) for p in jm._params),
            "compact": jm._compact})
        np.testing.assert_allclose(tm.predict_proba(Xt), jm.predict_proba(X),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(tm.predict(Xt), jm.predict(X))


def _regression(seed, n=800):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"u": rng.normal(size=n), "v": rng.uniform(0, 2, n),
                       "g": [f"g{v}" for v in rng.integers(0, 4, n)]})
    y = pd.Series(2.0 * df["u"] - df["v"] ** 2
                  + df["g"].str[1:].astype(float) + rng.normal(0, 0.1, n))
    return df, y


def _mlp_design(enc_mod, df):
    return enc_mod.FeatureEncoder(["u", "v", "g"], ["u", "v"]).fit_transform(df)


def test_mlp_from_jax_state_predicts_like_jax():
    df, y = _regression(3)
    X = _mlp_design(j_enc, df)
    jm = j_lin.MLPRegressorModel(n_steps=120).fit(X, y)
    tm = t_lin.MLPRegressorModel.from_state({
        "params": {k: np.asarray(v) for k, v in jm._params.items()},
        "y_mean": jm._y_mean, "y_std": jm._y_std})
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-5,
                               atol=1e-6)


def _jax_mlp_init(d_pad, hidden, seed):
    """The JAX package's initial MLP draw (linear.py `_fit_mlp_regressor`)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "w1": np.asarray(jax.random.normal(k1, (d_pad, hidden), jnp.float32)
                         * jnp.sqrt(2.0 / max(d_pad, 1))),
        "b1": np.zeros(hidden, np.float32),
        "w2": np.asarray(jax.random.normal(k2, (hidden, hidden), jnp.float32)
                         * jnp.sqrt(2.0 / hidden)),
        "b2": np.zeros(hidden, np.float32),
        "w3": np.asarray(jax.random.normal(k3, (hidden, 1), jnp.float32)
                         * jnp.sqrt(2.0 / hidden)),
        "b3": np.zeros(1, np.float32),
    }


def test_mlp_fit_from_jax_init_matches_jax():
    """60 Adam steps from the same initial params: predictions within 1e-3
    of the predictions' mean magnitude. Adam's normalised steps turn the
    two packages' f32 roundings in near-zero gradients into lr-sized
    moves, so the fits drift apart step by step (about 7e-3 after 150)."""
    df, y = _regression(5)
    X = _mlp_design(j_enc, df)
    jm = j_lin.MLPRegressorModel(n_steps=60).fit(X, y)
    init = _jax_mlp_init(t_lin._pad_cols(X).shape[1], 64, 42)
    tm = t_lin.MLPRegressorModel(n_steps=60).fit(_mlp_design(t_enc, df), y,
                                                 init=init)
    assert tm.n_steps_run_ == 60
    want = jm.predict(X)
    np.testing.assert_allclose(tm.predict(X), want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).mean())
    np.testing.assert_allclose(tm.loss_, jm.loss_, rtol=1e-3)


def test_mlp_seeded_init_is_device_independent():
    """The port's own draw comes from a CPU generator seeded with ``seed``:
    the same parameters whatever the device, and a different seed gives a
    different draw."""
    a, b = t_lin._mlp_init(8, 16, 42), t_lin._mlp_init(8, 16, 42)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w1"], t_lin._mlp_init(8, 16, 43)["w1"])


def test_adam_exit_rule_counts_applied_updates():
    """The loop stops at the first step past the minimum whose loss moved
    by at most tol * (1 + |loss|); a constant loss stops at the minimum."""
    adam = t_lin._FlatAdam([(3,)], torch.device("cpu"))
    steps, loss = t_lin._adam_until_plateau(
        adam, t_lin._autograd_step(adam, lambda p: (p * 0.0).sum() + 1.0),
        0.1, 300, 20, 1e-6)
    assert steps == 20 and loss == 1.0
    adam = t_lin._FlatAdam([(2,)], torch.device("cpu"),
                           [np.full(2, 5.0, np.float32)])
    steps, _ = t_lin._adam_until_plateau(
        adam, t_lin._autograd_step(adam, lambda q: (q ** 2).sum()), 0.1, 7,
        20, 1e-6)
    assert steps == 7


def test_gather_backward_equals_index_add():
    """K10b's plain version: the gradient of the gathered logits, each
    vocabulary id's occurrences added in row-major order, equals
    ``index_add_`` (which adds its source rows in that order on one
    thread) bit for bit; with l2 = 0 and no continuous column, ``gb`` is
    the column sum (another order: within 1e-5)."""
    rng = np.random.default_rng(2)
    gid = torch.from_numpy(rng.integers(0, 11, (40, 3)))
    g = torch.from_numpy(rng.standard_normal((40, 5)).astype(np.float32))
    plan = k_lin.gather_plan(gid, torch.zeros((40, 0)),
                             torch.zeros(40, dtype=torch.int64),
                             torch.ones(40), 1.0, 0.0, 11, 5)
    W = torch.from_numpy(rng.standard_normal((11, 5)).astype(np.float32))
    gW, gWc, gb = torch.empty(11, 5), torch.empty(0, 5), torch.empty(5)
    k_lin.logreg_backward_plain(plan, g, W, torch.zeros((0, 5)), gW, gWc, gb)
    want = torch.zeros(11, 5).index_add_(0, gid.reshape(-1),
                                         g.repeat_interleave(3, dim=0))
    assert torch.equal(gW, want)
    assert torch.allclose(gb, g.sum(0), rtol=1e-5, atol=1e-5)


def test_class_weights_and_f1_match_jax():
    counts = np.array([5.0, 40.0, 1.0, 300.0])
    for damped in (True, False):
        np.testing.assert_array_equal(
            t_enc.balanced_class_weights(counts, 346, damped=damped),
            j_enc.balanced_class_weights(counts, 346, damped=damped))
    rng = np.random.default_rng(8)
    yt, yp = rng.integers(0, 5, 200), rng.integers(0, 6, 200)
    assert t_enc.f1_macro(yt, yp) == j_enc.f1_macro(yt, yp)
