"""K3 (``gbdt_hist``, ``gbdt_split``, ``gbdt_route``) and K4
(``gbdt_predict``) of ``delphi_tpu_torch.ops.kernels.gbdt``: their plain
versions against the JAX package's ``_build_tree`` (its CPU scatter
route, level by level), ``_boost``, ``_predict_tree`` and
``_predict_boosted``, and the wrappers' dispatch. Inputs come from numpy
seeds. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); here every call takes the plain version.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from delphi_tpu.models import gbdt as j_gbdt
from delphi_tpu_torch import set_device
from delphi_tpu_torch.models import gbdt as t_gbdt
from delphi_tpu_torch.ops.kernels import build
from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield
    set_device(None)


def _channels(rng, n, C, zero_rows=0):
    """grad, hess, weight for C channels: 2 is L2 (the hessian is the
    weight), 3 adds the weight channel, 4 the row counts. The last
    ``zero_rows`` rows are padding (weight 0)."""
    weight = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    weight[rng.random(n) < 0.05] = 0.0
    if zero_rows:
        weight[-zero_rows:] = 0.0
    if C == 2:
        grad = (rng.normal(size=n) * weight).astype(np.float32)
        return grad, weight.copy(), weight
    p = rng.uniform(0.05, 0.95, n).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    grad = ((p - y) * weight).astype(np.float32)
    hess = (np.maximum(p * (1 - p), 1e-6) * weight).astype(np.float32)
    return grad, hess, weight


def _jax_hist(bins, node, vals, n_level, n_bins):
    """The JAX package's scatter histogram of one level (``_build_tree``'s
    CPU route, :157-163): [C, n_level, d, n_bins]."""
    n, d = bins.shape
    C = vals.shape[0]
    seg = (node[:, None] * d + jnp.arange(d)[None, :]) * n_bins + bins
    data = jnp.broadcast_to(vals[:, :, None], (C, n, d))
    return jax.vmap(lambda v: jax.ops.segment_sum(
        v.reshape(-1), seg.reshape(-1), num_segments=n_level * d * n_bins))(
        data.reshape(C, n * d)).reshape(C, n_level, d, n_bins)


# (depth, n_bins, d, C, reg_lambda, min_child_weight, min_child_samples)
LEVEL_CASES = [
    (3, 8, 1, 2, 1.0, 1.0, 0.0),
    (5, 33, 5, 3, 0.15, 0.5, 0.0),
    (5, 256, 5, 4, 1.0, 1.0, 5.0),
    (3, 33, 1, 4, 3.0, 1.0, 20.0),
    (5, 8, 5, 2, 1.0, 1.0, 0.0),
    (3, 256, 1, 3, 1.0, 1.0, 0.0),
    # the card's K3a / K3b edges: 16 bins (one cumsum block) and 17 (a
    # partial second block), the gauntlet's 55 features and 9 (K3b's
    # chunks of eight features of 64 bins, the last one partial)
    (4, 16, 3, 2, 1.0, 1.0, 0.0),
    (4, 17, 3, 3, 1.0, 1.0, 0.0),
    (3, 17, 2, 4, 1.0, 1.0, 5.0),
    (3, 64, 55, 3, 1.0, 1.0, 0.0),
    (4, 64, 9, 2, 1.0, 1.0, 0.0),
    # depth 7: the card's K3c at level 6 (64 split words a tree)
    (7, 16, 3, 3, 1.0, 1.0, 0.0),
]

# (depth, n_bins, d, C, reg_lambda, min_child_weight, min_child_samples, n,
# kind): n below one window of the card's K3a (1,024 node ids) and one
# past whole rounds (2,048 staged rows); one bin (every gain -inf, so
# every node takes the sentinel and every right child is empty); kinds of
# _level_inputs
EDGE_LEVEL_CASES = [
    (3, 1, 2, 2, 1.0, 1.0, 0.0, 700, ""),
    (4, 64, 4, 3, 1.0, 1.0, 0.0, 2049, "skew"),
    (3, 17, 3, 4, 1.0, 1.0, 5.0, 4097, ""),
    (3, 33, 3, 3, 1.0, 1.0, 0.0, 1025, "special"),
    (2, 16, 3, 3, 1.0, 1.0, 0.0, 600, "nan"),
]


def _level_inputs(rng, n, n_bins, d, C, kind):
    """bins, grad, hess, weight of one tree. Kinds: "skew" puts about 80%
    of each feature's rows in bin 3, "special" sets some gradients to
    -0.0 and one row's weight (a channel of its own at C >= 3) to +inf,
    "nan" one gradient to NaN (every gain at the root is NaN: the
    sentinel)."""
    bins = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    bins[rng.random(n) < 0.1, 0] = 0          # missing values
    if kind == "skew":
        bins[rng.random((n, d)) < 0.8] = min(3, n_bins - 1)
    grad, hess, weight = _channels(rng, n, C, zero_rows=37)
    if kind == "special":
        grad[rng.choice(n - 37, 20, replace=False)] = -0.0
        weight[5] = np.inf
        bins[5, 0] = n_bins - 1
    if kind == "nan":
        grad[7] = np.nan
    return bins, grad, hess, weight


def _levels_against_jax(bins, grad, hess, weight, depth, n_bins, C, lam, mcw,
                        mcs, nan_rows=()):
    """The plain level programs against ``_build_tree`` on one tree;
    returns the JAX package's thresholds. The leaves are compared but
    where ``nan_rows`` hold a NaN gradient: JAX's leaf sums are a matmul
    with the one-hot node matrix, whose 0 * NaN spreads the NaN to every
    leaf, while the port's sums leave it in its row's leaf."""
    n, d = bins.shape
    use_counts = C == 4
    hess_is_weight = C == 2
    jf, jt, jl, jnode = j_gbdt._build_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(weight), depth, n_bins, 1 << depth, lam, 0.0, mcw, mcs,
        use_scatter=True, use_counts=use_counts,
        hess_is_weight=hess_is_weight)

    chans = [grad, hess] + ([] if hess_is_weight else [weight])
    w_slot = 1 if hess_is_weight else 2
    c_slot = len(chans) if use_counts else -1
    if use_counts:
        chans.append((weight > 0).astype(np.float32))
    assert len(chans) == C
    vals = torch.from_numpy(np.stack(chans, -1))[None]
    tbins = torch.from_numpy(bins).long()
    feat = torch.zeros((1, (1 << depth) - 1), dtype=torch.int64)
    thr = torch.full_like(feat, n_bins)
    node = None
    for level in range(depth):
        h = k_gbdt.hist(vals, node, tbins, 1 << level, n_bins)
        at = np.zeros(n, np.int32) if node is None else node[0].numpy()
        want = _jax_hist(jnp.asarray(bins), jnp.asarray(at),
                         jnp.asarray(np.stack(chans)), 1 << level, n_bins)
        np.testing.assert_array_equal(
            h[0].permute(3, 0, 1, 2).numpy(), np.asarray(want))
        k_gbdt.split(h, feat, thr, level, n_bins, lam, 0.0, mcw, mcs,
                     w_slot, c_slot)
        node = k_gbdt.route(node, tbins, feat, thr, level)
    np.testing.assert_array_equal(feat[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(thr[0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(node[0].numpy(), np.asarray(jnode))
    gh = k_gbdt.hist(torch.from_numpy(np.stack([grad, hess], -1))[None],
                     node, None, 1 << depth, 1)[0, :, 0, 0]
    leaf = -gh[:, 0] / (gh[:, 1] + lam)
    if len(nan_rows):
        at = np.unique(node[0].numpy()[list(nan_rows)])
        assert np.isnan(np.asarray(jl)).all()
        assert np.isnan(leaf.numpy()[at]).all()
        assert not np.isnan(np.delete(leaf.numpy(), at)).any()
        return np.asarray(jt)
    np.testing.assert_allclose(leaf.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    return np.asarray(jt)


@pytest.mark.parametrize("depth,n_bins,d,C,lam,mcw,mcs", LEVEL_CASES)
def test_plain_levels_match_jax_build_tree(depth, n_bins, d, C, lam, mcw,
                                           mcs):
    """Level by level: the plain histograms equal the JAX scatter
    histograms bit for bit (both add each bin's rows in row order), the
    splits equal ``_build_tree``'s feat / thr, the final nodes its nodes,
    the leaves within 1e-5 (JAX sums them with a matmul)."""
    rng = np.random.default_rng(depth * 1000 + n_bins + d + C)
    n = 1500
    bins = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    bins[rng.random(n) < 0.1, 0] = 0          # missing values
    grad, hess, weight = _channels(rng, n, C, zero_rows=37)
    jt = _levels_against_jax(bins, grad, hess, weight, depth, n_bins, C,
                             lam, mcw, mcs)
    assert (jt < n_bins).any(), "the tree must split"


@pytest.mark.parametrize("depth,n_bins,d,C,lam,mcw,mcs,n,kind",
                         EDGE_LEVEL_CASES)
def test_plain_edge_levels_match_jax_build_tree(depth, n_bins, d, C, lam,
                                                mcw, mcs, n, kind):
    """The same check at the card kernels' edges: histograms with -0.0,
    +inf and NaN bit for bit the JAX package's (NaN where it has NaN),
    splits and nodes equal (leaves as :func:`_levels_against_jax` says).
    One bin or a NaN gradient leaves every node the sentinel (feature 0,
    threshold n_bins) in both packages; the other cases split."""
    rng = np.random.default_rng(depth * 1000 + n_bins + d + C + n)
    bins, grad, hess, weight = _level_inputs(rng, n, n_bins, d, C, kind)
    jt = _levels_against_jax(bins, grad, hess, weight, depth, n_bins, C,
                             lam, mcw, mcs,
                             nan_rows=np.flatnonzero(np.isnan(grad)))
    if n_bins == 1 or kind == "nan":
        assert (jt == n_bins).all()
    else:
        assert (jt < n_bins).any(), "the tree must split"


def test_hist_plain_adds_rows_in_order_from_zero():
    """Every bin of every channel is 0.0 + its rows' values in increasing
    row order in f32 (``np.add.at`` adds one index at a time, in order),
    per-model bins read through the tree-to-model map."""
    rng = np.random.default_rng(7)
    M, per_round, n, d, n_bins, L = 2, 3, 400, 3, 33, 4
    T = M * per_round
    for C in (1, 2, 3, 4):
        vals = rng.normal(size=(T, n, C)).astype(np.float32) \
            * np.float32(1e3) ** rng.integers(-2, 3, (T, n, C))
        vals = vals.astype(np.float32)
        node = rng.integers(0, L, (T, n)).astype(np.int32)
        bins = rng.integers(0, n_bins, (M, n, d))
        got = k_gbdt.hist(torch.from_numpy(vals), torch.from_numpy(node),
                          torch.from_numpy(bins), L, n_bins, per_round)
        want = np.zeros((T, L, d, n_bins, C), np.float32)
        for t in range(T):
            for f in range(d):
                for c in range(C):
                    np.add.at(want[t, :, f, :, c],
                              (node[t], bins[t // per_round, :, f]),
                              vals[t, :, c])
        np.testing.assert_array_equal(got.numpy(), want)
        # the same trees with the bins materialised per tree
        again = k_gbdt.hist(torch.from_numpy(vals), torch.from_numpy(node),
                            torch.from_numpy(np.repeat(bins, per_round, 0)),
                            L, n_bins)
        assert torch.equal(got, again)


@pytest.mark.parametrize("n,n_bins,C", [(700, 16, 1), (2049, 256, 3),
                                         (4097, 17, 4), (1025, 1, 2)])
def test_hist_plain_edges_match_add_at(n, n_bins, C):
    """The plain histograms at the card kernel's edges against
    ``np.add.at`` (one index at a time, in order, from 0.0): -0.0, +inf,
    -inf and NaN values, a bin holding about 80% of the rows, a node
    without rows, n below a window of node ids (1,024) and one past whole
    rounds (2,048), 1 to 256 bins, every C. Equal bit for bit, NaN where
    the reference has NaN."""
    rng = np.random.default_rng(n + n_bins + C)
    M, per_round, d, L = 2, 2, 3, 4
    T = M * per_round
    vals = rng.normal(size=(T, n, C)).astype(np.float32)
    flat = vals.reshape(-1)
    at = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[at] = np.resize(np.float32([-0.0, np.inf, -np.inf, np.nan]),
                         at.size)
    node = rng.integers(0, L, (T, n)).astype(np.int32)
    node[node == 2] = 1                        # node 2 has no rows
    bins = rng.integers(0, n_bins, (M, n, d))
    bins[rng.random((M, n, d)) < 0.8] = min(3, n_bins - 1)
    got = k_gbdt.hist(torch.from_numpy(vals), torch.from_numpy(node),
                      torch.from_numpy(bins), L, n_bins, per_round).numpy()
    want = np.zeros((T, L, d, n_bins, C), np.float32)
    with np.errstate(invalid="ignore"):        # inf + -inf
        for t in range(T):
            for f in range(d):
                for c in range(C):
                    np.add.at(want[t, :, f, :, c],
                              (node[t], bins[t // per_round, :, f]),
                              vals[t, :, c])
    assert np.isnan(want).any() and (want[:, 2] == 0).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    zero = np.float32(0.0)
    np.testing.assert_array_equal(
        np.where(np.isnan(got), zero, got).view(np.int32),
        np.where(np.isnan(want), zero, want).view(np.int32))


def test_split_first_maximum_and_sentinels():
    """Duplicate columns give equal gains: the first feature wins, as in
    ``_build_tree``; a node every split of which is masked, and a
    tree whose ``min_split_gain`` no split beats, take the sentinel
    (feature 0, threshold n_bins), as in ``_build_tree``."""
    rng = np.random.default_rng(11)
    n, d, n_bins, depth = 800, 5, 33, 3
    bins = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    bins[:, 2] = bins[:, 0]
    bins[:, 3] = bins[:, 0]
    # the first column carries the signal, so columns 0, 2 and 3 tie
    grad = np.where(bins[:, 0] > 16, 1.0, -1.0).astype(np.float32)
    hess = np.ones(n, np.float32)
    weight = np.ones(n, np.float32)
    for lam, msg, mcw, mcs in ((1.0, 0.0, 1.0, 0.0), (1.0, 0.0, 1e9, 0.0),
                               (1.0, 1e9, 1.0, 0.0), (1.0, 0.0, 1.0, 1e9)):
        use_counts = mcs > 0
        jf, jt, jl, _ = j_gbdt._build_tree(
            jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
            jnp.asarray(weight), depth, n_bins, 1 << depth, lam, msg, mcw,
            mcs, use_scatter=True, use_counts=use_counts)
        tf, tt, tl, _ = t_gbdt._build_trees(
            torch.from_numpy(bins).long(), torch.from_numpy(grad)[None],
            torch.from_numpy(hess)[None], torch.from_numpy(weight), depth,
            n_bins, lam, msg, mcw, mcs, use_counts=use_counts)
        np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt))
        if mcw > 1 or msg > 1 or mcs > 1:
            assert (tt[0] == n_bins).all() and (tf[0] == 0).all()
        else:
            assert tf[0, 0] == 0 and tt[0, 0] == 16


def test_split_per_tree_hyperparameters_and_nan_gain():
    """Per-tree f32 hyperparameters equal the same floats one tree at a
    time; a NaN gain is the maximum (``torch.argmax``'s rule) and never
    splits (NaN > min_split_gain is false)."""
    rng = np.random.default_rng(3)
    T, L, d, B, C = 3, 2, 2, 20, 3
    h = torch.from_numpy(rng.uniform(0.1, 2.0, (T, L, d, B, C))
                         .astype(np.float32))
    lam = torch.tensor([1.0, 0.1, 7.5])
    mcw = torch.tensor([0.5, 1.0, 3.0])
    width = 2 * L - 1
    feat = torch.zeros((T, width), dtype=torch.int64)
    thr = torch.full_like(feat, B)
    k_gbdt.split(h, feat, thr, 1, B, lam, 0.0, mcw, 0.0, 2, -1)
    for t in range(T):
        f1 = torch.zeros((1, width), dtype=torch.int64)
        t1 = torch.full_like(f1, B)
        k_gbdt.split(h[t:t + 1], f1, t1, 1, B, float(lam[t]), 0.0,
                     float(mcw[t]), 0.0, 2, -1)
        assert torch.equal(f1[0], feat[t]) and torch.equal(t1[0], thr[t])
    h[0, 0, 1, 5, 0] = float("nan")
    feat.zero_()
    thr.fill_(B)
    k_gbdt.split(h, feat, thr, 1, B, lam, 0.0, mcw, 0.0, 2, -1)
    assert feat[0, 1] == 0 and thr[0, 1] == B


def test_boost_multiclass_per_model_bins_match_jax():
    """Two models of four class trees each, with their own bins (the
    tree-to-model map t // 4), through ``_boost``: each model's trees
    equal the JAX package's ``_boost`` on that model's bins, margins
    within 1e-5 (JAX's leaf sums are a matmul)."""
    rng = np.random.default_rng(21)
    M, k, n, d, n_bins, depth, rounds = 2, 4, 600, 3, 17, 3, 2
    bins = rng.integers(0, n_bins, (M, n, d)).astype(np.int32)
    y = rng.integers(0, k, (M, n)).astype(np.float32)
    w = np.ones((M, n), np.float32)
    w[:, -25:] = 0.0                           # padded rows
    F0 = np.zeros((M, k, n), np.float32)
    F, (tf, tt, tl) = t_gbdt._boost(
        torch.from_numpy(bins).long(), torch.from_numpy(y),
        torch.from_numpy(w), torch.from_numpy(F0), rounds, depth, n_bins,
        "multiclass", k, 0.1, 1.0, 0.0, 1.0, 0.0, use_counts=False)
    for m in range(M):
        jF, (jf, jt, jl) = j_gbdt._boost(
            jnp.asarray(bins[m]), jnp.asarray(y[m]), jnp.asarray(w[m]),
            jnp.asarray(F0[m].T), rounds, depth, n_bins, 1 << depth,
            "multiclass", k, 0.1, 1.0, 0.0, 1.0, 0.0, use_counts=False)
        rows = slice(m * k, (m + 1) * k)
        np.testing.assert_array_equal(tf[:, rows].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tt[:, rows].numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl[:, rows].numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(F[m].numpy(), np.asarray(jF).T,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("objective,k,depth,n,R,d,kind", [
    pytest.param("multiclass", 4, 5, 700, 12, 5, "", id="multiclass-4-5"),
    pytest.param("binary", 1, 3, 700, 12, 5, "", id="binary-1-3"),
    pytest.param("regression", 1, 5, 700, 12, 5, "", id="regression-1-5"),
    # the card's K4 at its edges: depth 1, depth 7 past many staged chunks
    # of rounds, the gauntlet's 55 features, thresholds only 0, n_bins - 1
    # and the sentinel n_bins, a NaN leaf (and -0.0 and +inf ones)
    pytest.param("multiclass", 3, 1, 700, 12, 5, "", id="depth1"),
    pytest.param("binary", 1, 7, 40, 300, 5, "", id="depth7-300-rounds"),
    pytest.param("multiclass", 4, 3, 300, 25, 55, "", id="d55"),
    pytest.param("multiclass", 4, 5, 700, 12, 5, "sentinel", id="sentinel"),
    pytest.param("regression", 1, 3, 500, 20, 4, "nan", id="nan-leaf")])
def test_predict_plain_matches_jax(objective, k, depth, n, R, d, kind):
    """The plain traversal against ``_predict_tree`` per tree and
    ``_predict_boosted``: equal bit for bit, since JAX's scan adds each
    round's leaves to the carry in f32 in round order, as the port does
    (the stated tolerance, 1e-6, is never used; a NaN equals a NaN)."""
    rng = np.random.default_rng(k + depth)
    n_bins = 33
    width = (1 << depth) - 1
    bins = rng.integers(0, n_bins, (n, d)).astype(np.int32)
    feats = rng.integers(0, d, (R, k, width)).astype(np.int32)
    if kind == "sentinel":
        thrs = rng.choice(np.int32([0, n_bins - 1, n_bins]), (R, k, width))
    else:
        thrs = rng.integers(0, n_bins + 1, (R, k, width)).astype(np.int32)
    leaves = rng.normal(0, 0.3, (R, k, width + 1)).astype(np.float32)
    if kind == "nan":
        leaves[R // 2, 0, :3] = [np.nan, -0.0, np.inf]
    base = rng.normal(0, 1, k).astype(np.float32)
    got = k_gbdt.predict(
        torch.from_numpy(bins).long(), torch.from_numpy(feats).long(),
        torch.from_numpy(thrs).long(), torch.from_numpy(leaves), depth,
        torch.from_numpy(base), objective == "multiclass").numpy()
    want = np.asarray(j_gbdt._predict_boosted(
        jnp.asarray(bins), jnp.asarray(feats), jnp.asarray(thrs),
        jnp.asarray(leaves), R, depth, objective, k, jnp.asarray(base)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, want)
    if kind == "nan":
        assert np.isnan(got).any() and not np.isnan(got).all()
    one = np.asarray(j_gbdt._predict_tree(
        jnp.asarray(bins), jnp.asarray(feats[0, 0]), jnp.asarray(thrs[0, 0]),
        jnp.asarray(leaves[0, 0]), depth))
    first = k_gbdt.predict(
        torch.from_numpy(bins).long(), torch.from_numpy(feats[:1, :1]).long(),
        torch.from_numpy(thrs[:1, :1]).long(),
        torch.from_numpy(leaves[:1, :1]), depth, torch.zeros(1), False)
    np.testing.assert_array_equal(first.numpy(), one)


@pytest.mark.parametrize("kind", ["multiclass", "regression"])
def test_jax_fitted_trees_through_k4_plain_route(kind):
    """A JAX-fitted model carried over by ``from_state``: its margins
    through K4's plain route equal the JAX package's ``_predict_boosted``
    on the same trees and bins."""
    rng = np.random.default_rng(len(kind))
    n = 900
    X = np.column_stack([rng.integers(0, 7, n).astype(np.float64),
                         rng.normal(size=n),
                         np.round(rng.uniform(0, 3, n), 1)])
    X[rng.random(n) < 0.1, 1] = np.nan
    signal = np.nan_to_num(X[:, 1]) + 0.5 * X[:, 0]
    if kind == "multiclass":
        y = np.array([f"c{int(v) % 4}" for v in np.clip(signal, 0, 30)],
                     dtype=object)
    else:
        y = 3.0 * signal - X[:, 2]
    jm = j_gbdt.GradientBoostedTreesModel(
        is_discrete=kind != "regression",
        num_class=len(np.unique(y)) if kind != "regression" else 0,
        max_depth=3, n_estimators=30).fit(X, y)
    tm = t_gbdt.GradientBoostedTreesModel.from_state({
        "edges": jm._binner.edges, "trees": jm._trees, "base": jm._base,
        "objective": jm._objective, "k": jm._k, "classes": jm._classes,
        "fit_class_weights": getattr(jm, "_fit_class_weights", None),
        "log_target": getattr(jm, "_log_target", False),
        "n_estimators": jm.n_estimators, "max_depth": jm.max_depth})
    X_test = X[:300]
    bins = jm._binner.transform(X_test)
    feats, thrs, leaves = (np.asarray(t) for t in jm._trees)
    want = np.asarray(j_gbdt._predict_boosted(
        jnp.asarray(bins), jnp.asarray(feats), jnp.asarray(thrs),
        jnp.asarray(leaves), jm.n_estimators, jm.max_depth, jm._objective,
        max(jm._k, 1), jnp.asarray(jm._base)))
    np.testing.assert_array_equal(tm._raw_scores(X_test), want)


def test_builder_and_predictor_go_through_the_wrappers(monkeypatch):
    """Each level of ``_build_trees`` is one call each of hist, split and
    route, the leaf sums one more hist; ``_predict_boosted`` is one
    predict call. On the CPU the wrappers launch nothing."""
    calls = {"hist": 0, "split": 0, "route": 0, "predict": 0}
    for name in calls:
        orig = getattr(k_gbdt, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(k_gbdt, name, spy)
    k_gbdt.reset_launches()
    rng = np.random.default_rng(1)
    n, d, depth = 300, 3, 4
    bins = torch.from_numpy(rng.integers(0, 16, (1, n, d)))
    y = torch.from_numpy(rng.integers(0, 2, (1, n)).astype(np.float32))
    F, trees = t_gbdt._boost(bins, y, torch.ones(1, n), torch.zeros(1, n), 3,
                             depth, 16, "binary", 1, 0.1, 1.0, 0.0, 1.0, 0.0,
                             use_counts=False)
    assert calls == {"hist": 3 * (depth + 1), "split": 3 * depth,
                     "route": 3 * depth, "predict": 0}
    t_gbdt._predict_boosted(bins[0], *trees, depth, "binary", torch.zeros(1))
    assert calls["predict"] == 1
    assert all(v == 0 for v in k_gbdt.launches.values())


def test_parameter_tables_match_the_cuda_layouts():
    """The ctypes tables mirror ``csrc/gbdt.cu``'s structs (their sizes
    and the offsets the kernels read)."""
    sizes = {k_gbdt.HistParams: 72, k_gbdt.SplitParams: 104,
             k_gbdt.RouteParams: 72, k_gbdt.PredictParams: 72}
    for cls, size in sizes.items():
        assert ctypes.sizeof(cls) == size
    assert k_gbdt.HistParams.n.offset == 32
    assert k_gbdt.SplitParams.lam_s.offset == 56
    assert k_gbdt.SplitParams.trees.offset == 72
    assert k_gbdt.RouteParams.n.offset == 40
    assert k_gbdt.PredictParams.n.offset == 48
    src = open(build.sources()[[s.endswith("gbdt.cu")
                                for s in build.sources()].index(True)]).read()
    for name in ("delphi_gbdt_hist", "delphi_gbdt_split",
                 "delphi_gbdt_route", "delphi_gbdt_predict"):
        assert f'extern "C" int {name}(const void* params, void* stream)' \
            in src


@pytest.mark.parametrize("shape", chip_smoke.GBDT_PREDICT_EDGES)
def test_predict_edges_plain_match_jax(shape):
    """The card's K4 edge inputs (``chip_smoke.GBDT_PREDICT_EDGES``, rows
    cut to 257) through the plain traversal equal the JAX package's
    ``_predict_boosted`` on the same arrays, NaN equal to NaN: the edges
    the card holds its kernel to are the reference's answers too."""
    objective, T, R, depth, d, n, n_bins, kind = shape
    shape = (objective, T, R, depth, d, min(n, 257), n_bins, kind)
    a = chip_smoke.gbdt_predict_edge_inputs(shape, sum(shape[1:7]))
    got = k_gbdt.predict_plain(**a).numpy()
    want = np.asarray(j_gbdt._predict_boosted(
        jnp.asarray(a["bins"].numpy().astype(np.int32)),
        jnp.asarray(a["feats"].numpy().astype(np.int32)),
        jnp.asarray(a["thrs"].numpy().astype(np.int32)),
        jnp.asarray(a["leaves"].numpy()), R, depth, objective, T,
        jnp.asarray(a["base"].numpy())))
    np.testing.assert_array_equal(got, want)


def test_card_wrappers_raise_past_the_kernels_limits():
    """What the card's K4 cannot take raises before any launch, naming its
    limit: rows wider than ``PREDICT_MAX_FEATURES`` (one warp's rows of
    staged bins) or trees deeper than ``MAX_DEPTH``; K3c raises on a split
    table narrower than the level. The tables are built as for the card,
    from CPU tensors (nothing launches). The widest K4 edge the card
    checks is the widest admitted."""
    def predict(d, depth):
        W = (1 << depth) - 1
        return k_gbdt.predict_params(
            torch.zeros((5, d), dtype=torch.int64),
            torch.zeros((2, 1, W), dtype=torch.int64),
            torch.zeros((2, 1, W), dtype=torch.int64),
            torch.zeros((2, 1, W + 1)), depth, torch.zeros(1), False)

    def route(d, level, width=None):
        width = (2 << level) - 1 if width is None else width
        return k_gbdt.route_params(
            None, torch.zeros((5, d), dtype=torch.int64),
            torch.zeros((1, width), dtype=torch.int64),
            torch.zeros((1, width), dtype=torch.int64), level)

    predict(k_gbdt.PREDICT_MAX_FEATURES, 3)
    predict(4, k_gbdt.MAX_DEPTH)
    with pytest.raises(ValueError, match="at most 1024 features"):
        predict(k_gbdt.PREDICT_MAX_FEATURES + 1, 3)
    with pytest.raises(ValueError, match="depth 10"):
        predict(4, k_gbdt.MAX_DEPTH + 1)
    route(55, 6)
    with pytest.raises(ValueError, match="14 splits a tree hold no level 3"):
        route(4, 3, 14)
    assert max(e[4] for e in chip_smoke.GBDT_PREDICT_EDGES) \
        == k_gbdt.PREDICT_MAX_FEATURES


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA card raises; nothing
    falls back to the plain version."""
    meta = torch.empty((1, 4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_gbdt.hist(meta, None, None, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        k_gbdt.predict(torch.empty((4, 2), dtype=torch.int64, device="meta"),
                       None, None, None, 1, None, False)
