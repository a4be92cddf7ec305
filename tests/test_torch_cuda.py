"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the card against the CPU for the GBDT tree builder and a
whole repair. They skip without an NVIDIA GPU.

This file imports neither JAX nor ``delphi_tpu``, so it also runs where
JAX is absent (skip the JAX-importing conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import delphi_tpu_torch as T
from delphi_tpu_torch.models import gbdt
from delphi_tpu_torch.ops.kernels import entropy as k_entropy
from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
from delphi_tpu_torch.ops.kernels import pair_counts as k_pair


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels do not run on "
                    "the CPU)")
    yield torch.device("cuda")
    T.set_device(None)


def _codes(rng, n, v, null_frac=0.1):
    c = rng.integers(0, v, n).astype(np.int32)
    c[rng.random(n) < null_frac] = -1
    return c


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card):
    rng = np.random.default_rng(9)
    vocab = [9, 4, 255, 255, 2047, 2047]
    n = 100_003
    cols = np.stack([_codes(rng, n, v) for v in vocab])
    pairs = [(0, 1), (2, 3), (4, 5), (1, 0)]
    cpu = torch.from_numpy(cols)
    want, off = k_pair.pair_counts_plain(cpu, pairs, vocab)
    before = k_pair.launches
    got, off2 = k_pair.pair_counts(cpu.to(card), pairs, vocab)
    torch.cuda.synchronize()
    assert k_pair.launches == before + 1
    np.testing.assert_array_equal(off, off2)
    assert torch.equal(got.cpu(), want)

    hw, tw, nw = k_entropy.entropy_terms_plain(want, off, n)
    before = k_entropy.launches
    hg, tg, ng = k_entropy.entropy_terms(got, off, n)
    torch.cuda.synchronize()
    assert k_entropy.launches == before + 1
    assert torch.equal(tg.cpu(), tw) and torch.equal(ng.cpu(), nw)
    assert torch.allclose(hg.cpu(), hw, rtol=1e-12, atol=0.0)


@pytest.mark.cuda
def test_pair_counts_splits_past_128_pairs(card):
    """All 153 pairs of 18 columns: more pairs and columns than one launch
    takes, so the call makes several launches, each counted, and still
    equals the plain version bit for bit."""
    rng = np.random.default_rng(11)
    vocab = [int(v) for v in rng.integers(1, 40, 18)]
    n = 20_001
    cols = np.stack([_codes(rng, n, v) for v in vocab])
    pairs = [(i, j) for i in range(18) for j in range(i + 1, 18)]
    plan = k_pair.plan_launches(tuple(pairs), tuple(vocab))
    assert len(pairs) > k_pair.MAX_PAIRS and len(plan) > 1
    want, off = k_pair.pair_counts_plain(torch.from_numpy(cols), pairs, vocab)
    before = k_pair.launches
    got, off2 = k_pair.pair_counts(torch.from_numpy(cols).to(card), pairs,
                                   vocab)
    torch.cuda.synchronize()
    assert k_pair.launches == before + len(plan)
    np.testing.assert_array_equal(off, off2)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099, 65_536])
def test_pair_counts_unaligned_and_aligned_rows(card, n):
    """The main path's pairs on unaligned (n % 4 != 0, four 4-byte copies a
    quad) and aligned (one 16-byte copy) row counts."""
    rng = np.random.default_rng(12)
    vocab = [10, 5, 5, 6, 4]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (0, 4), (1, 4),
             (2, 4)]
    cols = np.stack([_codes(rng, n, v) for v in vocab])
    want, _ = k_pair.pair_counts_plain(torch.from_numpy(cols), pairs, vocab)
    got, _ = k_pair.pair_counts(torch.from_numpy(cols).to(card), pairs, vocab)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_entropy_big_segment_with_empty_and_single(card):
    """A 2047x2047 segment (2,048 chunks, finished by the last warp) beside
    empty and one-count segments, inline and in the pinned-upload table;
    repeatable bit for bit."""
    rng = np.random.default_rng(13)
    big = 2048 * 2048
    flat = np.zeros(big + 3, dtype=np.int32)
    flat[:big] = np.where(rng.random(big) < 0.2,
                          rng.integers(1, 50, big), 0)
    flat[big + 1] = 7
    counts = torch.from_numpy(flat).to(card)
    for offsets in ([0, big, big, big + 1, big + 2, big + 2, big + 3],
                    [0, big] + [big + 1] * 300 + [big + 3]):
        hw, tw, nw = k_entropy.entropy_terms_plain(counts, offsets, 10**7)
        hg, tg, ng = k_entropy.entropy_terms(counts, offsets, 10**7)
        h2, t2, n2 = k_entropy.entropy_terms(counts, offsets, 10**7)
        torch.cuda.synchronize()
        assert torch.equal(tg, tw) and torch.equal(ng, nw)
        assert torch.allclose(hg, hw, rtol=1e-12, atol=0.0)
        assert torch.equal(hg, h2) and torch.equal(tg, t2) \
            and torch.equal(ng, n2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_segments", [5, 300])
def test_entropy_owned_segments_equal_the_full_launch(card, n_segments):
    """K2's owned-segment launch (its gather modes: the table inline up to
    128 segments, uploaded past that) gives each chosen segment the
    all-segment launch's (h, total, nnz) bit for bit, multi-chunk segments
    included, and counts one owned launch; it never synchronises."""
    rng = np.random.default_rng(15 + n_segments)
    lengths = rng.integers(0, 40_000, n_segments)
    lengths[0] = 2048 * 2048
    off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = np.where(rng.random(int(off[-1])) < 0.3,
                    rng.integers(1, 60, int(off[-1])), 0).astype(np.int32)
    counts = torch.from_numpy(flat).to(card)
    full = k_entropy.entropy_terms(counts, off, 10**7)
    for segs in (rng.permutation(n_segments)[:n_segments // 2 + 1],
                 np.arange(n_segments)[::-1].copy(), [0]):
        before = k_entropy.owned_launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = k_entropy.entropy_terms_owned(counts, off, 10**7, segs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert k_entropy.owned_launches == before + 1
        idx = torch.as_tensor(np.asarray(segs, np.int64), device=card)
        for g, f in zip(got, full):
            assert torch.equal(g, f[idx])
        plain = k_entropy.entropy_terms_owned_plain(counts, off, 10**7, segs)
        assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
        assert torch.allclose(got[0], plain[0], rtol=1e-12, atol=0.0)


@pytest.mark.cuda
def test_sharded_stats_bitwise_on_card(card, monkeypatch):
    """The row-shard plane's statistics on the card, two ranks faked: each
    rank's span counts (K1) summed give the single-process FreqStats and
    device buffers, and the owner split of the entropies (K2's owned
    launch on the rebuilt buffer) gives every H(x|y) bit for bit."""
    import pickle
    from delphi_tpu_torch.ops import entropy as t_entropy
    from delphi_tpu_torch.ops import freq as t_freq
    from delphi_tpu_torch.parallel import distributed as t_dist
    from delphi_tpu_torch.parallel import rowshard
    from delphi_tpu_torch.table import encode_table
    T.set_device("cuda")
    rng = np.random.default_rng(16)
    n = 200_001
    df = pd.DataFrame({"tid": np.arange(n)})
    for i, v in enumerate((7, 300, 40, 2000, 5)):
        col = rng.integers(0, v, n).astype(object)
        col[rng.random(n) < 0.1] = None
        df[f"c{i}"] = col
    table = encode_table(df, "tid")
    attrs = [f"c{i}" for i in range(5)]
    pairs = [(x, y) for i, x in enumerate(attrs) for y in attrs[i + 1:]]
    dom = {a: table.column(a).domain_size for a in attrs}

    def stats():
        freq = t_freq.compute_freq_stats(table, attrs, pairs)
        return freq, t_entropy.compute_pairwise_stats(n, freq, pairs, dom)

    want_freq, want = stats()
    parts = {}
    for site in ("shard.freq.merge", "shard.entropy.merge"):
        for r in (0, 1):
            monkeypatch.setenv("DELPHI_SHARD", "1")
            monkeypatch.setattr(t_dist, "process_count", lambda: 2)
            monkeypatch.setattr(t_dist, "process_index", lambda r=r: r)

            def capture(obj, site, phase=site):
                if site != phase:
                    return [pickle.loads(pickle.dumps(p))
                            for p in parts[site]]
                parts.setdefault(site, []).append(
                    pickle.loads(pickle.dumps(obj)))
                return [obj, obj]

            monkeypatch.setattr(rowshard, "merge_parts", capture)
            if site == "shard.freq.merge":
                t_freq.compute_freq_stats(table, attrs, pairs)
            else:
                freq = t_freq.compute_freq_stats(table, attrs, pairs)
                t_entropy.compute_pairwise_stats(n, freq, pairs, dom)
    monkeypatch.setattr(rowshard, "merge_parts",
                        lambda obj, site: list(parts[site]))
    got_freq, got = stats()
    torch.cuda.synchronize()
    assert torch.equal(got_freq.pair_buffer, want_freq.pair_buffer)
    assert torch.equal(got_freq.single_buffer, want_freq.single_buffer)
    assert got == want


@pytest.mark.cuda
def test_wrappers_never_synchronize(card):
    """At the main path's shapes neither wrapper copies to or waits for the
    card: both run under set_sync_debug_mode("error")."""
    rng = np.random.default_rng(14)
    vocab = [10, 5, 5, 6, 4]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (0, 4), (1, 4),
             (2, 4)]
    codes = torch.from_numpy(
        np.stack([_codes(rng, 100_000, v) for v in vocab])).to(card)
    singles = torch.zeros(5 * 11, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flat, off = k_pair.pair_counts(codes, pairs, vocab)
        k_entropy.entropy_terms(flat, off, 100_000)
        k_entropy.entropy_terms(singles, np.arange(6) * 11, 100_000)
        # past the inline table: the pinned, non-blocking upload
        k_entropy.entropy_terms(flat, np.linspace(0, int(off[-1]), 400)
                                .astype(np.int64), 100_000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tree_builder_card_matches_cpu(card):
    """Fixed-order histogram sums: the same splits on the card as on the
    CPU, and leaves within one f32 rounding."""
    rng = np.random.default_rng(3)
    n, d, n_bins, depth = 5000, 6, 64, 5
    bins = torch.from_numpy(rng.integers(0, n_bins, (n, d))).long()
    p = torch.from_numpy(rng.uniform(0.05, 0.95, (4, n)).astype(np.float32))
    y = torch.from_numpy((rng.random((4, n)) < 0.3).astype(np.float32))
    weight = torch.from_numpy(rng.choice([0.5, 1.0, 3.0], n)
                              .astype(np.float32))
    grad, hess = (p - y) * weight, torch.clamp_min(p * (1 - p), 1e-6) * weight
    args = (depth, n_bins, 1.0, 0.0, 1.0, 5.0)
    cf, ct, cl, _ = gbdt._build_trees(bins, grad, hess, weight, *args)
    gf, gt, gl, _ = gbdt._build_trees(bins.to(card), grad.to(card),
                                      hess.to(card), weight.to(card), *args)
    assert torch.equal(gf.cpu(), cf) and torch.equal(gt.cpu(), ct)
    assert torch.allclose(gl.cpu(), cl, rtol=1e-6, atol=1e-7)


def _cv_task(seed, n, kind):
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.integers(0, 7, n).astype(np.float64),
                         rng.normal(size=n), np.round(rng.uniform(0, 3, n), 1)])
    X[rng.random(n) < 0.1, 1] = np.nan
    # little label noise (chosen while the GBDT still used each device's
    # f32 exp, which differ in the last ulp)
    signal = np.nan_to_num(X[:, 1]) + 0.5 * X[:, 0] + rng.normal(0, 0.05, n)
    if kind == "multiclass":
        y = np.array([f"c{int(v) % 4}" for v in np.clip(signal, 0, 30)],
                     dtype=object)
    elif kind == "binary":
        y = np.where(signal > 1.5, "yes", "no").astype(object)
    else:
        y = 3.0 * signal - X[:, 2]
    return X, y


@pytest.mark.cuda
def test_cv_search_and_fit_batch_card_match_cpu(card):
    """The multi-target CV search picks the same configs, rounds and scores
    on the card as on the CPU, and the batched final fits grow the same
    trees (leaves within one f32 rounding of the CPU's)."""
    from delphi_tpu_torch.utils import counters
    grid = [dict(max_depth=3, reg_lambda=3.0, learning_rate=0.05,
                 n_estimators=50),
            dict(max_depth=5, reg_lambda=1.0, learning_rate=0.1,
                 n_estimators=50)]
    tasks = [(1, 900, "binary"), (2, 800, "multiclass"), (3, 850, "binary"),
             (4, 700, "regression"), (5, 760, "regression")]

    def model(kind, y, **cfg):
        discrete = kind != "regression"
        return gbdt.GradientBoostedTreesModel(
            discrete, len(np.unique(y)) if discrete else 0, **cfg)

    def search():
        preps = []
        for seed, n, kind in tasks:
            X, y = _cv_task(seed, n, kind)
            preps.append(gbdt._cv_prepare_target(
                X, y, kind != "regression", 3, "balanced",
                model(kind, y, **grid[0])))
        return gbdt.gbdt_cv_grid_search_multi(preps, grid)

    def fits():
        entries = []
        for seed, n, kind in tasks:
            X, y = _cv_task(seed, n, kind)
            entries.append((model(kind, y, max_depth=3, n_estimators=40),
                            X, y))
        gbdt.gbdt_fit_batch(entries)
        return [m for m, _, _ in entries]

    T.set_device("cpu")
    want_cv, want_fit = search(), fits()
    T.set_device("cuda")
    counters.clear()
    got_cv, got_fit = search(), fits()
    assert counters.get("gbdt.cv_multi_target_launches", 0) > 0
    assert counters.get("gbdt.fit_batch_launches", 0) > 0
    for g, w in zip(got_cv, want_cv):
        assert g[0] == w[0] and g[2] == w[2] and g[3] == w[3]
        assert g[1] == pytest.approx(w[1], rel=1e-6)
    for g, w in zip(got_fit, want_fit):
        np.testing.assert_array_equal(g._trees[0], w._trees[0])
        np.testing.assert_array_equal(g._trees[1], w._trees[1])
        np.testing.assert_allclose(g._trees[2], w._trees[2], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_gather_logistic_head_bit_identical_on_card(card):
    """The gather route's fixed-order backward: two fits on the card take
    the same number of Adam steps and end at bit-identical weights."""
    from delphi_tpu_torch.models.encoding import FeatureEncoder
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    rng = np.random.default_rng(6)
    n = 5000
    latent = rng.integers(0, 40, n)
    df = pd.DataFrame({"a": [f"a{v // 2}" for v in latent],
                       "b": [f"b{v % 2}" for v in latent],
                       "x": latent + rng.normal(0, 3, n)})
    y = pd.Series(np.where(rng.random(n) < 0.2, rng.integers(0, 40, n),
                           latent).astype(str))
    T.set_device("cuda")
    fits = []
    for _ in range(2):
        X = FeatureEncoder(["a", "b", "x"], ["x"]).fit_transform_compact(df)
        fits.append(LogisticRegressionModel().fit(X, y))
    a, b = fits
    assert a._compact is not None
    assert a.n_steps_run_ == b.n_steps_run_
    for pa, pb in zip(a._params, b._params):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
def test_repair_card_matches_cpu(card):
    rng = np.random.RandomState(0)
    n = 3000
    level = rng.randint(0, 10, n)
    seg = rng.randint(0, 4, n)
    df = pd.DataFrame({
        "tid": np.arange(n),
        "level": [f"lv{i}" for i in level],
        "tier": [f"t{i // 2}" for i in level],
        "band": [f"b{i % 5}" for i in level],
        "segment": [f"s{i}" for i in seg],
    })
    for col in ("tier", "band"):
        vals = df[col].to_numpy(dtype=object).copy()
        vals[rng.choice(n, n // 5, replace=False)] = None
        df[col] = vals

    def run():
        return T.delphi.repair.setInput(df).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]) \
            .option("model.hp.max_evals", "1").run()

    T.set_device("cpu")
    want = run()
    T.set_device("cuda")
    before = k_pair.launches, k_entropy.launches
    got = run()
    assert k_pair.launches > before[0] and k_entropy.launches > before[1]
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 2 * (n // 5)


def _constraint_table(n, seed=3):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "tid": np.arange(n),
        "zip": rng.randint(0, max(n // 12, 2), n).astype(str),
        "city": rng.randint(0, 30, n).astype(str),
        "state": rng.randint(0, 8, n).astype(str),
        "salary": rng.randint(10, 99, n).astype(str),
        "rate": rng.randint(1, 50, n).astype(str),
        "score": np.round(rng.normal(50, 10, n), 1),
    })
    for c in ("city", "state", "salary", "score"):
        df.loc[rng.choice(n, n // 20, replace=False), c] = None
    return df


# every constraint route of ops/detect.py: EQ keys only, single and
# composite keys with IQ / LT / GT residuals, all-IQ inclusion-exclusion,
# mixed residuals, no EQ key, one-tuple
CONSTRAINT_SUITE = [
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.state)",
    "t1&t2&EQ(t1.state,t2.state)&LT(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.state,t2.state)&GT(t1.rate,t2.rate)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)&IQ(t1.city,t2.city)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.city,t2.city)&LT(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)&IQ(t1.salary,t2.salary)",
    "t1&t2&EQ(t1.zip,t2.zip)&EQ(t1.state,t2.state)&IQ(t1.city,t2.city)"
    "&IQ(t1.rate,t2.rate)",
    "t1&t2&EQ(t1.city,t2.city)&LT(t1.score,t2.score)",
    "t1&t2&EQ(t1.zip,t2.zip)&IQ(t1.city,t2.city)&GT(t1.rate,t2.rate)",
    "t1&t2&IQ(t1.state,t2.state)&IQ(t1.zip,t2.zip)",
    't1&EQ(t1.state,"3")&IQ(t1.city,"7")',
]


@pytest.mark.cuda
def test_constraint_suite_card_matches_cpu(card):
    """Every constraint route gives the same violation cells on the card
    as on the CPU, and the card route counts its device steps."""
    from delphi_tpu_torch import constraints as dc
    from delphi_tpu_torch.ops import detect
    from delphi_tpu_torch.table import encode_table
    from delphi_tpu_torch.utils import counters

    df = _constraint_table(20_000)
    table = encode_table(df, "tid")
    attrs = df.columns.tolist()
    for stmt in CONSTRAINT_SUITE:
        parsed = dc.parse_and_verify_constraints([stmt], "t", attrs)
        out = {}
        for dev in ("cpu", "cuda"):
            T.set_device(dev)
            counters.clear()
            cells = detect.detect_constraint_violations(table, parsed, attrs)
            out[dev] = [(a, rows.tolist()) for rows, a in cells]
        assert out["cuda"] == out["cpu"], stmt
        assert out["cuda"], stmt
    for name in ("detect.sorted_count", "detect.rank",
                 "detect.group_extrema"):
        T.set_device("cuda")
        counters.clear()
        detect.detect_constraint_violations(
            table, dc.parse_and_verify_constraints(CONSTRAINT_SUITE, "t",
                                                   attrs), attrs)
        assert counters.get(name, 0) > 0, name


@pytest.mark.cuda
def test_percentiles_and_outliers_card_match_cpu(card):
    """The card's batched quartiles equal np.percentile bit for bit (with
    pools of 1 and 2 values, duplicates and 1M values), and the outlier
    cells equal the CPU run's."""
    from delphi_tpu_torch.ops import detect
    from delphi_tpu_torch.table import encode_table

    rng = np.random.RandomState(0)
    pools = [rng.normal(0, 1, 1_000_000), np.round(rng.normal(0, 3, 999)),
             np.array([2.5]), np.array([1.0, 4.0])]
    got = detect.percentile_batch(
        [torch.from_numpy(p).to(card) for p in pools], (25.0, 75.0)).cpu()
    want = np.stack([np.percentile(p, [25.0, 75.0]) for p in pools])
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))

    n = 200_000
    df = pd.DataFrame({"tid": np.arange(n),
                       "a": rng.normal(0, 1, n), "b": rng.exponential(1, n)})
    df.loc[rng.choice(n, 1000, replace=False), "a"] = np.nan
    table = encode_table(df, "tid")
    out = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        for approx in (False, True):
            out[dev, approx] = [
                (a, rows.tolist()) for rows, a in detect.detect_outliers(
                    table, ["a", "b"], ["a", "b"], approx=approx)]
    for approx in (False, True):
        assert out["cuda", approx] == out["cpu", approx]
        assert len(out["cuda", approx]) == 2


@pytest.mark.cuda
def test_detect_errors_only_card_matches_cpu(card):
    """Every detector kind of a run, on the card and on the CPU: the same
    detect_errors_only frame."""
    df = _constraint_table(20_000, seed=5)
    df.loc[::997, "score"] = 1e4

    def run():
        return T.delphi.repair.setInput(df).setRowId("tid") \
            .setErrorDetectors([
                T.NullErrorDetector(),
                T.RegExErrorDetector("salary", "^[1-8][0-9]$"),
                T.DomainValues("state", autofill=True, min_count_thres=2200),
                T.ConstraintErrorDetector(
                    constraints=";".join(CONSTRAINT_SUITE[:2])),
                T.GaussianOutlierErrorDetector()]) \
            .run(detect_errors_only=True)

    T.set_device("cpu")
    want = run()
    T.set_device("cuda")
    got = run()
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)


def _qgram_table(n, seed):
    rng = np.random.default_rng(seed)
    city = rng.integers(0, 24, n)
    return pd.DataFrame({
        "city": [f"city_{v:02d}" for v in city],
        "state": [f"state_{v % 12:02d}" for v in city],
        "channel": [f"ch_{v}" for v in rng.integers(0, 3, n)],
        "amount": np.round(50.0 + rng.normal(0, 5, n), 2),
    })


@pytest.mark.cuda
def test_kmeans_labels_card_match_cpu(card):
    """Lloyd's loop on the card from the CPU's seeds: the same labels (the
    centroid sums are exact; only a last-bit distance tie could differ)."""
    from delphi_tpu_torch.ops import cluster
    X = cluster.qgram_features(_qgram_table(20_000, 3), 2)
    labels = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        labels[dev] = (cluster.kmeans(X, 4, seed=0),
                       cluster.bisecting_kmeans(X, 4))
    for got, want in zip(labels["cuda"], labels["cpu"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_pmf_probabilities_card_match_cpu(card):
    """compute_repair_candidate_prob on the card against the CPU: the same
    cells, classes and probabilities within 1e-4 (the GBDT trees agree)."""
    rng = np.random.default_rng(5)
    n = 3000
    level = rng.integers(0, 10, n)
    df = pd.DataFrame({
        "tid": np.arange(n),
        "level": [f"lv{v}" for v in level],
        "tier": [f"t{v // 2}" for v in level],
        "band": [f"b{v % 5}" for v in level],
        "grade": [f"g{(v + s) % 6}" for v, s in
                  zip(level, rng.integers(0, 4, n))],
    })
    for col in ("tier", "band", "grade"):
        df.loc[rng.random(n) < 0.2, col] = None
    frames = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        frames[dev] = T.delphi.repair.setInput(df).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]) \
            .option("error.max_attrs_to_compute_pairwise_stats", "4") \
            .run(compute_repair_candidate_prob=True)
    cpu, gpu = frames["cpu"], frames["cuda"]
    assert len(gpu) > 0
    pd.testing.assert_frame_equal(gpu[["tid", "attribute"]],
                                  cpu[["tid", "attribute"]])
    for g, c in zip(gpu["pmf"], cpu["pmf"]):
        assert [e["class"] for e in g] == [e["class"] for e in c]
        np.testing.assert_allclose([e["prob"] for e in g],
                                   [e["prob"] for e in c], atol=1e-4)


@pytest.mark.cuda
def test_k8_joint_ascent_card_matches_cpu(card):
    """K8 on the card within 1e-5 of the CPU, argmax equal, with no copy to
    the host between iterations, and bit-deterministic on the card."""
    from delphi_tpu_torch.ops import joint
    rng = np.random.default_rng(8)
    n, n_pad, v, v_pad, k = 300, 512, 40, 64, 4
    unary = np.full((n_pad, v_pad), joint.NEG_INF, dtype=np.float32)
    unary[:, 0] = 0.0
    unary[:n, :v] = rng.normal(0, 2, (n, v))
    idx = np.full((n_pad, k), -1, dtype=np.int32)
    pot = np.zeros((n_pad, k, v_pad, v_pad), dtype=np.float32)
    for i in range(n):
        for j in range(rng.integers(0, k + 1)):
            idx[i, j] = rng.integers(0, n)
            pot[i, j, :v, :v] = np.log(rng.dirichlet(np.ones(v), v))
    want = joint.joint_ascent(*(torch.as_tensor(a) for a in (unary, idx, pot)),
                              8).numpy()
    args = [torch.as_tensor(a, device=card) for a in (unary, idx, pot)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = joint.joint_ascent(*args, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = joint.joint_ascent(*args, 8)
    assert torch.equal(got, again)
    got = got.cpu().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:n, :v].argmax(1), want[:n, :v].argmax(1))


@pytest.mark.cuda
def test_escalated_repair_card_matches_cpu(card):
    """The escalation pass on the card: the frame, the routed and escalated
    cells and the joint tier's launches equal the CPU's."""
    n = 3000
    i = np.arange(n)
    df = pd.DataFrame({
        "tid": i.astype(str), "c0": [f"g{v}" for v in i % 8],
        "c1": [f"v{v}" for v in (i % 8) % 4],
        "c2": [f"{100 + a}-{10 + b}" for a, b in zip(i % 3, i % 8)]})
    df.loc[5::13, "c2"] = df.loc[5::13, "c2"].str.replace("-", "x")
    df.loc[7::23, "c2"] = None
    df.loc[3::17, "c1"] = None
    runs = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        m = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
            T.NullErrorDetector(),
            T.RegExErrorDetector("c2", "^[0-9]{3}-[0-9]{2}$")]) \
            .option("repair.escalate", "true") \
            .option("repair.escalate.budget", "400")
        runs.append((m.run(), m._last_escalation))
    (f_cpu, s_cpu), (f_gpu, s_gpu) = runs
    pd.testing.assert_frame_equal(f_gpu, f_cpu)
    assert s_gpu["routed_cells"] == s_cpu["routed_cells"]
    assert s_gpu["escalated_cells"] == s_cpu["escalated_cells"]
    assert s_gpu["tiers"] == s_cpu["tiers"] and s_gpu["escalated"] > 0


def _incremental_frames(n):
    """``bench._incremental_frames`` (this file imports no JAX package
    code): 32 groups keyed by c0, c1 and c3 functions of the group, every
    11th base row's c1 NULL; an appended tenth in groups 0-3."""
    def rows(ids, gid, null):
        return pd.DataFrame({
            "tid": ids.astype(str), "c0": [f"g{g}" for g in gid],
            "c1": [None if z else f"v{g % 7}" for g, z in zip(gid, null)],
            "c2": ((ids * 7) % 5).astype(str),
            "c3": [f"w{g % 5}" for g in gid]})
    i = np.arange(n)
    j = np.arange(max(4, n // 10))
    base = rows(i, i % 32, i % 11 == 0)
    extra = rows(n + j, j % 4, j % 3 == 0)
    return base, pd.concat([base, extra], ignore_index=True)


def _delta_run(frame, snap):
    m = T.delphi.repair.setInput(frame.copy()).setRowId("tid") \
        .setErrorDetectors([
            T.NullErrorDetector(),
            T.ConstraintErrorDetector(
                constraints="t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)")]) \
        .option("repair.incremental", "true") \
        .option("repair.snapshot.dir", str(snap))
    return m.run(), m._last_incremental


@pytest.mark.cuda
def test_incremental_delta_card_matches_cpu(card, tmp_path):
    """Populate and clean-append delta at 2,000 rows on the card and on the
    CPU: the same summaries and frames, K1 and K2 launched by the card's
    delta run."""
    base, appended = _incremental_frames(2000)
    runs = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        _delta_run(base, tmp_path / dev)
        k_pair.reset_launches()
        k_entropy.reset_launches()
        runs.append(_delta_run(appended, tmp_path / dev))
    (f_cpu, s_cpu), (f_gpu, s_gpu) = runs
    assert s_gpu["mode"] == "delta" and s_gpu["models_reused"] >= 1
    drop = ("snapshot_dir",)
    assert {k: v for k, v in s_gpu.items() if k not in drop} == \
        {k: v for k, v in s_cpu.items() if k not in drop}
    pd.testing.assert_frame_equal(f_gpu, f_cpu)
    assert k_pair.launches >= 1 and k_entropy.launches >= 1


@pytest.mark.cuda
def test_snapshot_holds_no_cuda_tensor(card, tmp_path):
    """The snapshot a card run writes loads on the CPU and holds no tensor
    on the card."""
    import pickle
    from delphi_tpu_torch.parallel import store
    T.set_device("cuda")
    base, _ = _incremental_frames(2000)
    _delta_run(base, tmp_path)
    payload, status = store.read_bytes(
        str(tmp_path / "state.pkl"), schema="snapshot_state",
        site="store.snapshot_state")
    assert status == "ok"
    state = pickle.loads(payload)
    seen, stack, devices = set(), [state], []
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            devices.append(obj.device.type)
            continue
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif type(obj).__module__.startswith("delphi_tpu_torch"):
            stack.extend(vars(obj).values())
    assert "cuda" not in devices
    assert state["models"] and len(state["frame"]) > 0


@pytest.mark.cuda
def test_boosting_rounds_bitwise_card_matches_cpu(card):
    """Gradients, hessians, 30 multiclass and binary boosting rounds and
    the CV statistics are bit for bit the CPU's: the f32 ``exp`` of the two
    devices differ in the last ulp, so the GBDT's transcendentals round an
    f64 result (at 5,000 rows the card once chose another CV config)."""
    rng = np.random.default_rng(0)
    n, d, depth, n_bins = 5000, 4, 5, 33
    bins = torch.from_numpy(rng.integers(0, n_bins - 1, (1, n, d))).long()
    w = torch.ones(1, n)
    for objective, k in (("multiclass", 4), ("binary", 1)):
        y = torch.from_numpy(rng.integers(0, max(k, 2), (1, n))
                             .astype(np.float32))
        shape = (1, k, n) if k > 1 else (1, n)
        F = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        g_c, h_c = gbdt._grad_hess(F, y, w, objective, k)
        g_g, h_g = gbdt._grad_hess(F.to(card), y.to(card), w.to(card),
                                   objective, k)
        assert torch.equal(g_g.cpu(), g_c) and torch.equal(h_g.cpu(), h_c)
        args = (30, depth, n_bins, objective, k, 0.1, 1.0, 0.0, 1e-3, 20.0,
                True)
        F_c, t_c = gbdt._boost(bins, y, w, F, *args)
        k_gbdt.reset_launches()
        F_g, t_g = gbdt._boost(bins.to(card), y.to(card), w.to(card),
                               F.to(card), *args)
        torch.cuda.synchronize()
        assert all(k_gbdt.launches[name] > 0 for name in
                   ("gbdt_hist", "gbdt_split", "gbdt_route"))
        assert torch.equal(F_g.cpu(), F_c)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(t_g, t_c))
        kk = max(k, 2)
        val = torch.from_numpy((rng.random((1, n)) < 0.3)
                               .astype(np.float32))
        consts = (torch.zeros(1, n), torch.zeros(1), torch.ones(1),
                  torch.ones(1, kk), torch.ones(1, kk))
        s_c = gbdt._cv_stats(F_c, y, val, *consts, objective, kk)
        s_g = gbdt._cv_stats(F_g, y.to(card), val.to(card),
                             *[c.to(card) for c in consts], objective, kk)
        assert torch.equal(s_g.cpu(), s_c)


# (T, per_round, n, d, n_bins, C, level, kind): small shapes, odd bin
# counts, and 4e's (3 folds x 8 class trees, 10,000 rows, 4 features, 64
# bins); then the edge shapes chip_smoke.py holds K3a / K3b to
# (``GBDT_EDGES``: a skewed bin, 1 to 256 bins, an empty node, partial
# windows and rounds, 55 and 9 features, every C, -0.0 / inf / NaN values,
# NaN gains, every gain -inf with one bin)
GBDT_SHAPES = [(1, 1, 1, 1, 2, 2, 0, ""), (3, 1, 777, 5, 33, 3, 2, ""),
               (4, 4, 2500, 2, 256, 4, 5, ""), (6, 2, 1000, 3, 17, 2, 6, ""),
               (24, 8, 10_000, 4, 64, 3, 0, ""),
               (24, 8, 10_000, 4, 64, 3, 4, "")] + chip_smoke.GBDT_EDGES


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GBDT_SHAPES)
def test_gbdt_kernels_match_plain_on_card(card, shape):
    """K3a, K3b, K3c bit for bit their plain versions at small shapes, at
    4e's and at K3a's edges, per-model bins read through the tree-to-model
    map; each launch counted once. With one channel the split search runs
    on the histograms with a hessian-like channel appended."""
    T, per_round, n, d, n_bins, C, level, _ = shape
    vals, node, bins = chip_smoke.gbdt_edge_inputs(shape, sum(shape[:7]))
    L = 1 << level
    k_gbdt.reset_launches()
    want = k_gbdt.hist(vals, node, bins, L, n_bins, per_round)
    got = k_gbdt.hist(vals.to(card), node.to(card), bins.to(card), L,
                      n_bins, per_round)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(torch, got.cpu(), want)
    # hessian-like second channel, weight and counts for the masks
    h = want.clone() if C > 1 else torch.cat([want, want], -1)
    Cs = h.shape[-1]
    h[..., 1] = h[..., 1].abs() + 0.01
    if Cs > 2:
        h[..., 2] = h[..., 2].abs()
    width = 2 * L - 1
    for w_slot, c_slot, lam, mcw in ((1 if Cs == 2 else 2, Cs - 1 if Cs == 4
                                      else -1, 1.0, 0.5),
                                     (-1, -1, torch.rand(T) + 0.1, 0.0)):
        feats = [torch.zeros((T, width), dtype=torch.int64, device=dev)
                 for dev in ("cpu", card, "cpu", card)]
        feats[2].fill_(n_bins)
        feats[3].fill_(n_bins)
        k_gbdt.split(h, feats[0], feats[2], level, n_bins, lam, 0.0, mcw,
                     2.0, w_slot, c_slot)
        lam_g = lam.to(card) if isinstance(lam, torch.Tensor) else lam
        k_gbdt.split(h.to(card), feats[1], feats[3], level, n_bins, lam_g,
                     0.0, mcw, 2.0, w_slot, c_slot)
        torch.cuda.synchronize()
        assert torch.equal(feats[1].cpu(), feats[0])
        assert torch.equal(feats[3].cpu(), feats[2])
        if n_bins == 1:                            # the sentinel everywhere
            assert (feats[2] == 1).all() and (feats[0] == 0).all()
        for prev in (None, node):
            want_r = k_gbdt.route(prev, bins, feats[0], feats[2], level,
                                  per_round)
            got_r = k_gbdt.route(None if prev is None else prev.to(card),
                                 bins.to(card), feats[1], feats[3], level,
                                 per_round)
            torch.cuda.synchronize()
            assert torch.equal(got_r.cpu(), want_r)
    assert k_gbdt.launches == {"gbdt_hist": 1, "gbdt_split": 2,
                               "gbdt_route": 4, "gbdt_predict": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.GBDT_ROUTE_EDGES)
def test_gbdt_route_matches_plain_on_card(card, shape):
    """K3c bit for bit its plain version on the same card tensors at the
    edges chip_smoke.py holds it to (``GBDT_ROUTE_EDGES``: levels 0 to 6,
    shared and per-model bins, n below and past a tile, 16 and 55
    features, bins and thresholds from -3 to 70,000), at level 0 with
    node ids None and zeros; one launch a call."""
    a = {k: v.to(card) if hasattr(v, "shape") else v for k, v in
         chip_smoke.gbdt_route_edge_inputs(shape, sum(shape[:6])).items()}
    variants = [a]
    if a["node"] is None:
        variants.append(dict(a, node=torch.zeros(
            (a["feat"].shape[0], a["bins"].shape[-2]), dtype=torch.int32,
            device=card)))
    for v in variants:
        before = k_gbdt.launches["gbdt_route"]
        got = k_gbdt.route(**v)
        want = k_gbdt.route_plain(**v)
        torch.cuda.synchronize()
        assert k_gbdt.launches["gbdt_route"] == before + 1
        assert got.dtype == torch.int32 and torch.equal(got, want)


# (objective, T, R, depth, d, n, n_bins, kind): the test's three earlier
# cases, then the edges chip_smoke.py holds K4 to (GBDT_PREDICT_EDGES)
GBDT_PREDICT_SHAPES = [("multiclass", 8, 40, 5, 6, 100_000, 64, ""),
                       ("binary", 1, 200, 3, 6, 4099, 64, ""),
                       ("regression", 1, 3, 7, 6, 1, 64, "")] \
    + chip_smoke.GBDT_PREDICT_EDGES


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GBDT_PREDICT_SHAPES)
def test_gbdt_predict_matches_plain_on_card(card, shape):
    """K4 bit for bit its plain version (the round-by-round f32 sum) on
    the same card tensors, NaN equal to NaN; one launch a call."""
    a = {k: v.to(card) if hasattr(v, "shape") else v for k, v in
         chip_smoke.gbdt_predict_edge_inputs(shape,
                                             sum(shape[1:7])).items()}
    want = k_gbdt.predict_plain(**a)
    before = k_gbdt.launches["gbdt_predict"]
    got = k_gbdt.predict(**a)
    torch.cuda.synchronize()
    assert k_gbdt.launches["gbdt_predict"] == before + 1
    assert got.shape == want.shape and chip_smoke.same_bits(torch, got, want)


@pytest.mark.cuda
def test_gbdt_failed_launch_raises(card):
    """A launch the entry point refuses (five channels, past the
    kernel's four) comes back as KernelLaunchError, and the wrappers
    refuse what the kernels do not take before launching."""
    from delphi_tpu_torch.ops.kernels import build
    p = k_gbdt.HistParams()
    p.trees, p.levels, p.d, p.n_bins, p.channels = 1, 1, 1, 1, 5
    p.per_round, p.models = 1, 1
    import ctypes
    err = build.library().delphi_gbdt_hist(ctypes.addressof(p),
                                           build.current_stream())
    with pytest.raises(build.KernelLaunchError):
        build.check(err, "gbdt_hist")
    vals = torch.zeros((1, 8, 2), device=card)
    with pytest.raises(ValueError):
        k_gbdt.hist(vals, None, torch.zeros((8, 1), dtype=torch.int64,
                                            device=card), 1, 257)
    with pytest.raises(ValueError):
        k_gbdt.hist(vals, None, torch.zeros((8, 1), dtype=torch.int32,
                                            device=card), 1, 8)


# -- the resilience plane on the card -----------------------------------------

def _null_table(n, seed=0):
    rng = np.random.RandomState(seed)
    level = rng.randint(0, 10, n)
    df = pd.DataFrame({
        "tid": np.arange(n),
        "level": [f"lv{i}" for i in level],
        "tier": [f"t{i // 2}" for i in level],
        "band": [f"b{i % 5}" for i in level],
        "segment": [f"s{i}" for i in rng.randint(0, 4, n)],
    })
    for col in ("tier", "band"):
        vals = df[col].to_numpy(dtype=object).copy()
        vals[rng.choice(n, n // 5, replace=False)] = None
        df[col] = vals
    return df


def _null_run(df):
    return T.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()]) \
        .option("model.hp.max_evals", "1").run()


@pytest.fixture
def clean_plan(monkeypatch):
    from delphi_tpu_torch.parallel import resilience as rz
    monkeypatch.delenv("DELPHI_FAULT_PLAN", raising=False)
    monkeypatch.delenv("DELPHI_CHECKPOINT_DIR", raising=False)
    rz.reset_fault_state()
    yield rz
    rz.reset_fault_state()
    rz.clear_cpu_fallback()


@pytest.mark.cuda
def test_real_oom_classifies_as_oom(card, clean_plan):
    """The allocator's own failure classifies as oom; a failed launch's
    error never classifies as a fault."""
    from delphi_tpu_torch.ops.kernels import build
    with pytest.raises(torch.cuda.OutOfMemoryError) as e:
        torch.empty(2 ** 40, device="cuda")
    assert clean_plan.classify_fault(e.value) == "oom"
    with pytest.raises(build.KernelLaunchError) as e:
        build.check(700, "pair_counts")
    assert clean_plan.classify_fault(e.value) is None


@pytest.mark.cuda
@pytest.mark.parametrize("site,n_faults", [("freq.pair*", 3),
                                           ("gbdt.fit_chunk", 3),
                                           ("domain.weak_label", 6)])
def test_cpu_rung_reraises_on_the_card(card, clean_plan, monkeypatch, site,
                                       n_faults):
    """A classified fault that outlasts its retries (and the evict rung,
    where the site has one) on a run on the card re-raises instead of
    moving work to the CPU: the refusal is counted, nothing is latched,
    and the next run on the card returns the unfaulted frame (without a
    ledger and on the legacy domain route, ``DELPHI_DEVICE_TABLE=0``, so
    that the domain chunks enter domain.weak_label; the bucketed route's
    domain.bucket refusal is a CPU test with the device check stubbed)."""
    from delphi_tpu_torch.utils import counters
    if site == "domain.weak_label":
        monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    df = _null_table(3000)
    T.set_device("cuda")
    want = _null_run(df)
    monkeypatch.setenv("DELPHI_FAULT_PLAN", ",".join(
        f"{site}:{n}:oom" for n in range(1, n_faults + 1)))
    counters.clear()
    with pytest.raises(clean_plan.FaultInjected) as exc:
        _null_run(df)
    assert clean_plan.classify_fault(exc.value) == "oom"
    assert counters["resilience.degrade.cpu_refused"] == 1
    assert "resilience.degrade.cpu_fallback" not in counters
    assert counters["resilience.faults.oom"] == n_faults
    assert not clean_plan.cpu_fallback_active()
    monkeypatch.delenv("DELPHI_FAULT_PLAN")
    clean_plan.reset_fault_state()
    pd.testing.assert_frame_equal(_null_run(df), want)


@pytest.mark.cuda
def test_resumed_run_on_card_equals_cpu(card, clean_plan, monkeypatch,
                                        tmp_path):
    """At 2,000 rows a run killed at its first GBDT launch resumes from
    its detect checkpoint to the unfaulted frame, on the card as on the
    CPU, and the two frames are equal."""
    df = _null_table(2000, seed=1)
    frames = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        base = _null_run(df)
        monkeypatch.setenv("DELPHI_CHECKPOINT_DIR", str(tmp_path / dev))
        monkeypatch.setenv("DELPHI_FAULT_PLAN", "gbdt.*:1:fatal")
        with pytest.raises(clean_plan.FaultInjected):
            _null_run(df)
        monkeypatch.delenv("DELPHI_FAULT_PLAN")
        clean_plan.reset_fault_state()
        resumed = _null_run(df)
        monkeypatch.delenv("DELPHI_CHECKPOINT_DIR")
        pd.testing.assert_frame_equal(resumed, base)
        frames.append(resumed)
    pd.testing.assert_frame_equal(frames[1], frames[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default detectors", "error cells",
                                  "detectors"])
def test_constraints_table_card_matches_cpu(card, mode):
    """The constraints path's runs on a 2,000-row fd_categorical-shaped
    table (chip_smoke's 4f(d)): with its NULL, regex, constraint and
    outlier detectors, the default detectors, and setErrorCells. The
    card's frame equals the CPU's outside logistic-head near-ties."""
    import chip_smoke as cs
    _, dirty, truth = cs.fd_table(2000, seed=5)

    def build():
        m = cs.dc_model(T, dirty, detectors=mode == "detectors")
        return m.setErrorCells(cs.truth_cells(truth)) \
            if mode == "error cells" else m

    ties, restore = cs.near_ties(T)
    try:
        T.set_device("cpu")
        on_cpu = build().run()
    finally:
        restore()
    T.set_device("cuda")
    on_gpu = build().run()
    assert len(on_gpu) > 0
    cs.frames_match(mode, on_cpu, on_gpu, ties)


@pytest.mark.cuda
def test_device_codes_cache_hits_on_the_card(card):
    """A column's codes upload once: the run's device carries the card's
    index, as the cached tensor's device does."""
    from delphi_tpu_torch.ops import xfer
    from delphi_tpu_torch.parallel import resilience as rz
    from delphi_tpu_torch.table import encode_table
    T.set_device("cuda")
    table = encode_table(pd.DataFrame({"tid": range(10),
                                       "a": list("xyxyxyxyxz")}), "tid")
    rz.entries.clear()
    first = xfer.device_codes(table.column("a"))
    assert xfer.device_codes(table.column("a")) is first
    assert rz.entries == {"xfer.upload": 1}


def _k5_ops(rng, dev, b, k, vc, n_rows, cells, va_of, n_cols=6):
    """Seeded operands of one K5 launch on ``dev``: ``b`` pieces of ``k``
    correlates, ``cells`` cells each, piece i ``va_of[i]`` values wide,
    pair tables of ``vc`` real rows."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    codes = rng.integers(-1, vc - 1, (n_cols, n_rows)).astype(np.int32)
    pieces = []
    for i in range(b):
        v_a = va_of[i % len(va_of)]
        tables = rng.integers(0, 9, (k, vc, v_a + 1)).astype(np.int32)
        tables[rng.random(tables.shape) < 0.3] = 1
        pieces.append(k_domain.Piece(
            rows=rng.integers(0, n_rows, cells),
            col_idx=rng.choice(n_cols, k, replace=False),
            taus=rng.integers(0, 4, k), vcs=[vc] * k,
            hs=rng.random(v_a) < 0.9, rank=rng.permutation(v_a),
            tables=tables))
    blob, layout = k_domain.pack(pieces, vc)
    return k_domain.Operands(torch.as_tensor(codes, device=dev),
                             torch.as_tensor(blob, device=dev), layout)


def _k5_card_and_plain(ops, beta, n_rows):
    """Both modes on the card (one launch each, under the sync debug
    mode) against their plain versions on the card and on the CPU,
    bitwise."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    k_domain.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (k_domain.weak_label(ops, beta, n_rows),
               k_domain.domain_scores(ops))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = (k_domain.weak_label_plain(ops, beta, n_rows),
            k_domain.domain_scores_plain(ops))
    on_cpu = k_domain.Operands(ops.codes.cpu(), ops.blob.cpu(), ops.layout)
    cpu = (k_domain.weak_label(on_cpu, beta, n_rows),
           k_domain.domain_scores(on_cpu))
    torch.cuda.synchronize()
    assert k_domain.launches == 2
    assert k_domain.mode_launches == {"weak": 1, "int": 1}
    for g, w, c in zip(got, want, cpu):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    return k_domain.split_weak(got[0], ops.layout.cells)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # the main path's shapes: three pieces of a 1M-row table's error cells
    # (5 or 6 values), a constraints launch (wider values and tables), a
    # tiny piece
    (3, 2, 16, 1_000_000, 220_000, (5, 5, 6)),
    (4, 3, 64, 200_000, 65_536, (51, 4, 12, 24)),
    (1, 1, 8, 10, 7, (3,)),
])
def test_domain_scores_matches_plain_on_card(card, shape):
    """K5 on the card, both modes, bitwise equal to the plain versions on
    the card and on the CPU, one launch per call, never synchronising."""
    b, k, vc, n_rows, cells, va_of = shape
    rng = np.random.default_rng(sum(shape[:5]))
    ops = _k5_ops(rng, card, b, k, vc, n_rows, cells, va_of)
    has, _ = _k5_card_and_plain(ops, 0.3, float(n_rows))
    assert bool(has.any())


@pytest.mark.cuda
@pytest.mark.parametrize("va", [1, 7, 8, 9, 128, 129, 300])
def test_weak_label_row_sum_widths_on_card(card, va):
    """Every branch of the row sum's numpy order (n < 8, eight
    accumulators, the recursion past 128) on the card, with a narrower
    piece beside the wide one."""
    rng = np.random.default_rng(va)
    ops = _k5_ops(rng, card, 2, 2, 16, 50_000, 3_000, (va, max(1, va // 3)))
    _k5_card_and_plain(ops, 0.5 / va, 50_000.0)


@pytest.mark.cuda
def test_domain_scores_tables_past_the_shared_budget(card):
    """Pair tables beyond SMEM_TABLE_BUDGET are read through __ldg: the
    global branch launches and is bitwise equal, as the shared one is."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    rng = np.random.default_rng(9)
    for vc, va, branch in ((64, 60, "shared"), (512, 300, "global")):
        ops = _k5_ops(rng, card, 2, 3, vc, 100_000, 20_000, (va,))
        shape = k_domain.launch_shape(ops.layout, True, 132)
        assert shape["shared"] == (branch == "shared")
        _k5_card_and_plain(ops, 1.5 / va, 100_000.0)
        assert k_domain.branch_launches[branch] == 2


@pytest.mark.cuda
def test_weak_label_ties_beta_and_empty_pieces_on_card(card):
    """Hand-built cells: ties broken by rank, every probability exactly at
    beta, nothing active, and a piece with no cells, on the card."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    cases = [([3, 3, 0, 1], [2, 0, 1, 3]), ([0, 0, 0, 0], [0, 1, 2, 3]),
             ([2, 2, 3, 0], [0, 1, 2, 3]), ([2, 2, 2, 2], [3, 2, 1, 0]),
             ([1, 1, 1, 0], [2, 1, 0, 3])]
    pieces = []
    for counts, rank in cases:
        tables = np.zeros((1, 2, 5), np.int32)
        tables[0, 1, 1:] = counts
        pieces.append(k_domain.Piece(
            rows=np.zeros(1, np.int64), col_idx=[0], taus=[0], vcs=[2],
            hs=np.ones(4, bool), rank=np.asarray(rank), tables=tables))
    pieces.insert(2, k_domain.Piece(
        rows=np.zeros(0, np.int64), col_idx=[0], taus=[0], vcs=[2],
        hs=np.ones(4, bool), rank=np.arange(4),
        tables=np.zeros((1, 2, 5), np.int32)))
    blob, layout = k_domain.pack(pieces, 2)
    ops = k_domain.Operands(torch.zeros((1, 1), dtype=torch.int32,
                                        device=card),
                            torch.as_tensor(blob, device=card), layout)
    has, top = _k5_card_and_plain(ops, 0.25, 8.0)
    assert has.cpu().tolist() == [True, False, True, False, True]
    assert top.cpu()[has.cpu()].tolist() == [1, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [35.0, 8.0])
def test_weak_label_near_tie_numerators_on_card(card, n_rows):
    """Numerators an ulp apart (tiny sums of 12 correlates): the kernel's
    exact second walk gives the plain version's top, whether their
    probabilities tie (n_rows 35: the rank decides) or not (8)."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    tables = np.zeros((12, 2, 4), np.int32)
    tables[0, 1, 1] = 2
    tables[1:3, 1, 1] = 1
    tables[:, 1, 2] = 1
    piece = k_domain.Piece(
        rows=np.zeros(1, np.int64), col_idx=np.arange(12), taus=[0] * 12,
        vcs=[2] * 12, hs=np.ones(3, bool), rank=np.array([0, 1, 2]),
        tables=tables)
    blob, layout = k_domain.pack([piece], 2)
    ops = k_domain.Operands(torch.zeros((12, 1), dtype=torch.int32,
                                        device=card),
                            torch.as_tensor(blob, device=card), layout)
    has, top = _k5_card_and_plain(ops, 0.3, n_rows)
    assert bool(has[0]) and int(top[0]) == (0 if n_rows == 35.0 else 1)


@pytest.mark.cuda
def test_fd_table_demotions_card_match_cpu(card):
    """A 20,000-row fd_table through the constraints path's detectors,
    detect-only: the error cells left after weak-label demotion (and the
    demoted count) equal on the CPU and on the card, where K5's weak-label
    mode ran."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.utils import counters
    import chip_smoke as cs
    _, dirty, _ = cs.fd_table(20_000, seed=11)
    out = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        counters.clear()
        k_domain.reset_launches()
        frame = cs.dc_model(T, dirty).run(detect_errors_only=True)
        out[dev] = (frame, counters.get("domain.cells_fixed", 0),
                    dict(k_domain.mode_launches))
    pd.testing.assert_frame_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1] > 0
    assert out["cuda"][2]["weak"] >= 1 and out["cpu"][2]["weak"] == 0


@pytest.mark.cuda
def test_cold_compile_cache_build_then_hit(card, tmp_path, monkeypatch):
    """A cold build cache: the first load builds the library with nvcc into
    DELPHI_COMPILE_CACHE_DIR (a miss), the next load hits; a run then
    launches the kernels from it."""
    from delphi_tpu_torch.ops.kernels import build
    from delphi_tpu_torch.utils import counters
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    counters.clear()
    build.reset_library()
    try:
        build.library()
        assert counters == {"compile_cache.requests": 1,
                            "compile_cache.misses": 1}
        assert [p.name for p in (tmp_path / "cc").iterdir()] == \
            [os.path.basename(build._library_path())]
        build.reset_library()
        build.library()
        assert counters["compile_cache.hits"] == 1
        T.set_device("cuda")
        rng = np.random.default_rng(1)
        codes = torch.as_tensor(np.stack([_codes(rng, 10_000, 7),
                                          _codes(rng, 10_000, 5)]),
                                device=card)
        k_pair.reset_launches()
        k_pair.pair_counts(codes, [(0, 1)], [7, 5])
        assert k_pair.launches == 1
    finally:
        build.reset_library()


@pytest.mark.cuda
def test_rules_and_pmf_modes_card_match_cpu(card):
    """chip_smoke's 4g(c) at 2,000 rows: rule repairs identical, PMF and
    score probabilities within 1e-4, maximal-likelihood selections equal
    off the percentile cut, card against CPU."""
    import chip_smoke as cs
    out = cs.rules_pmf_cross_check(T, cs.CHECK_2K_ROWS)
    assert out["rules_repairs"] > 0 and out["pmf_cells"] > 0


@pytest.mark.cuda
def test_escalation_and_ledger_card_match_cpu(card):
    """chip_smoke's 4i(c) at 2,000 rows: frames, routed and escalated cells
    and in-memory ledger entries (within 1e-5) equal, card against CPU."""
    import chip_smoke as cs
    out = cs.escalation_cross_check(T, cs.CHECK_2K_ROWS,
                                    cs.ESC_CHECK_BUDGET)
    assert out["escalated"] > 0 and out["entries"] > 0


@pytest.mark.cuda
def test_pipeline_and_bucketed_route_card_match_cpu(card, monkeypatch):
    """On the card the pipeline is on by default and domain scoring takes
    the bucketed route through K5: the frame equals the CPU's with the
    pipeline off and the legacy route."""
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.utils import counters
    import chip_smoke as cs
    _, dirty = cs.missing_heavy(3000, seed=4)
    T.set_device("cpu")
    monkeypatch.setenv("DELPHI_PIPELINE", "0")
    monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    want = cs.repair(T, dirty)
    monkeypatch.delenv("DELPHI_PIPELINE")
    monkeypatch.delenv("DELPHI_DEVICE_TABLE")
    T.set_device("cuda")
    counters.clear()
    k_domain.reset_launches()
    got = cs.repair(T, dirty)
    pd.testing.assert_frame_equal(got, want)
    assert counters["pipeline.items"] >= 2
    assert k_domain.launches >= 1


@pytest.mark.cuda
def test_profiled_run_report_has_device_time_on_card(card, tmp_path,
                                                     monkeypatch):
    """A reported, profiled run on the card: the frame of an unprofiled
    run, a non-null ``device_time`` that credits the attr stats and domain
    phases."""
    from delphi_tpu_torch import observability as obs
    import chip_smoke as cs
    _, dirty = cs.missing_heavy(20_000, seed=4)
    T.set_device("cuda")
    want = cs.repair(T, dirty)
    monkeypatch.setenv("DELPHI_METRICS_PATH", str(tmp_path / "r.json"))
    monkeypatch.setenv("DELPHI_PROFILE_DIR", str(tmp_path / "prof"))
    got = cs.repair(T, dirty)
    pd.testing.assert_frame_equal(got, want)
    report = obs.load_run_report(str(tmp_path / "r.json"))
    dt = report["device_time"]
    assert dt is not None and dt["device_busy_s"] > 0
    assert dt["per_phase"]["attr stats"] > 0
    assert dt["per_phase"]["cell domain analysis"] > 0
    assert 0 < dt["device_busy_s"] <= report["spans"]["wall_s"]
    assert report["env"]["backend"] == "cuda" and report["env"]["device_kind"]
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))


@pytest.mark.cuda
def test_device_utilization_busy_fraction_on_card(card):
    from delphi_tpu_torch.utils.profiling import DeviceUtilization
    import time
    x = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize()
    util = DeviceUtilization()
    util.start()
    t0 = time.perf_counter()
    for _ in range(20):
        x = x @ x / 64
    torch.cuda.synchronize()
    out = util.stop(time.perf_counter() - t0)
    assert out.get("profile_error") is None, out
    assert 0 < out["device_busy_frac"] <= 1
    assert out["device_busy_s"] > 0 and out["top_kernels"]


class _Ranks:
    """A faked world of ``world`` ranks in one process, one thread each
    (``tests/test_torch_mesh.py`` explains the harness)."""

    def __init__(self, world, monkeypatch):
        import threading
        from delphi_tpu_torch.parallel import distributed as t_dist
        self.world = world
        self.barrier = threading.Barrier(world)
        self.slots = [None] * world
        self.local = threading.local()
        monkeypatch.setenv("DELPHI_COLLECTIVE_TIMEOUT_S", "0")
        monkeypatch.setattr(t_dist, "process_count", lambda: world)
        monkeypatch.setattr(t_dist, "process_index",
                            lambda: getattr(self.local, "rank", 0))
        monkeypatch.setattr(t_dist, "_all_gather", self._all_gather)

    def _all_gather(self, arr):
        self.slots[self.local.rank] = np.array(arr, copy=True)
        self.barrier.wait(timeout=120)
        out = np.stack(self.slots)
        self.barrier.wait(timeout=120)
        return out

    def run(self, fn):
        import threading
        out, errors = [None] * self.world, []

        def work(rank):
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except BaseException as e:  # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        return out


@pytest.mark.cuda
def test_mesh_block_launches_match_plain_on_card(card, monkeypatch):
    """The mesh's block launches on the card, two ranks faked in threads:
    K1 over each rank's block of rows and K5's integer mode over each
    rank's block of cells, summed / gathered over the mesh, equal the
    plain versions over the whole input; each rank launched each kernel;
    the mesh FreqStats buffers equal the one-device buffers."""
    from delphi_tpu_torch.ops import freq as t_freq
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    from delphi_tpu_torch.parallel import mesh as t_mesh
    from delphi_tpu_torch.parallel import sharded as t_sharded
    from delphi_tpu_torch.table import encode_table
    rng = np.random.default_rng(21)
    n, v = 200_003, 40
    codes = np.stack([_codes(rng, n, v) for _ in range(4)], axis=1)
    pairs = [(0, 1), (2, 3), (1, 3)]
    cells = 50_001
    tables = [rng.integers(0, 9, size=(v + 1, 13)).astype(np.int32)
              for _ in range(3)]
    cc = [_codes(rng, cells, v) for _ in range(3)]
    hs = rng.random(12) > 0.2
    T.set_device("cpu")
    want_pairs = t_sharded.sharded_pair_counts(codes, pairs, v,
                                               t_mesh.Mesh((0,)))
    want_scores = t_sharded.sharded_domain_scores(cc, tables, [3, 0, 1], hs,
                                                  t_mesh.Mesh((0,)))
    df = pd.DataFrame({"tid": np.arange(n)})
    for i in range(4):
        col = codes[:, i].astype(object)
        col[codes[:, i] < 0] = None
        df[f"c{i}"] = col
    table = encode_table(df, "tid")
    attrs = [f"c{i}" for i in range(4)]
    T.set_device("cuda")
    want_freq = t_freq.compute_freq_stats(table, attrs, [("c0", "c1")])
    k_pair.reset_launches()
    k_domain.reset_launches()
    ranks = _Ranks(2, monkeypatch)

    def rank(r):
        mesh = t_mesh.make_mesh()
        return (t_sharded.sharded_pair_counts(codes, pairs, v, mesh),
                t_sharded.sharded_domain_scores(cc, tables, [3, 0, 1], hs,
                                                mesh),
                t_freq._mesh_freq_stats(table, attrs, [("c0", "c1")], attrs,
                                        {a: table.column(a).domain_size
                                         for a in table.column_names},
                                        0.0, mesh))

    for got_pairs, got_scores, got_freq in ranks.run(rank):
        np.testing.assert_array_equal(got_pairs, want_pairs)
        for a, b in zip(got_scores, want_scores):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(got_freq.pair_buffer, want_freq.pair_buffer)
        assert torch.equal(got_freq.single_buffer, want_freq.single_buffer)
    assert k_pair.launches >= 4  # a K1 launch a rank for each of two calls
    assert k_domain.mode_launches["int"] == 2


@pytest.mark.cuda
def test_mesh_trees_card_match_cpu(card, monkeypatch):
    """``_build_trees`` over the mesh of two faked ranks: the card's trees
    equal the CPU's bit for bit (features, thresholds and leaves), as the
    one-device trees do."""
    from delphi_tpu_torch.parallel import mesh as t_mesh
    rng = np.random.default_rng(23)
    n = 20_001
    bins = rng.integers(0, 64, size=(n, 8)).astype(np.int64)
    y = (bins[:, 0] % 4).astype(np.float32)
    w = np.ones(n, np.float32)
    F0 = np.zeros((4, n), np.float32)

    def trees_on(device):
        T.set_device(device)
        ranks = _Ranks(2, monkeypatch)

        def rank(r):
            mesh = t_mesh.make_mesh()
            lo, hi = gbdt._train_block(n, mesh)
            dev = torch.device(device)
            _, trees = gbdt._boost(
                torch.as_tensor(bins[None, lo:hi], device=dev),
                torch.as_tensor(y[None, lo:hi], device=dev),
                torch.as_tensor(w[None, lo:hi], device=dev),
                torch.as_tensor(F0[None, :, lo:hi], device=dev), 3, 5, 64,
                "multiclass", 4, 0.1, 1.0, 0.0, 1.0, 0.0, use_counts=False,
                reduce=lambda t: t_mesh.psum(t, mesh))
            return [t.cpu() for t in trees]

        return ranks.run(rank)

    cpu, gpu = trees_on("cpu"), trees_on("cuda")
    for c, g in zip(cpu + [cpu[0]], gpu + [gpu[1]]):
        for a, b in zip(c, g):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_process_local_block_counts_match_plain_on_card(card, monkeypatch):
    """A process-local table's frequency counts on the card, two ranks
    faked: each rank's K1 launch over the rows it holds (one rank holds
    none) and the mesh sum equal the plain versions over every row, bit
    for bit, and K2 on the summed counts matches its plain version (1e-12
    relative); the FreqStats equal a one-process table's."""
    import dataclasses
    from delphi_tpu_torch.ops import freq as t_freq
    from delphi_tpu_torch.table import encode_table
    T.set_device("cuda")
    rng = np.random.default_rng(31)
    n = 120_001
    df = pd.DataFrame({"tid": np.arange(n)})
    for i, v in enumerate((7, 300, 40, 2000)):
        col = rng.integers(0, v, n).astype(object)
        col[rng.random(n) < 0.1] = None
        df[f"c{i}"] = col
    table = encode_table(df, "tid")
    attrs = [f"c{i}" for i in range(4)]
    pairs = [(x, y) for i, x in enumerate(attrs) for y in attrs[i + 1:]]
    want = t_freq.compute_freq_stats(table, attrs, pairs)

    def rows(lo, hi):
        cols = [dataclasses.replace(c, codes=c.codes[lo:hi].copy())
                for c in table.columns]
        return dataclasses.replace(table, columns=cols,
                                   row_id_values=table.row_id_values[lo:hi],
                                   process_local=True)

    for split in (n // 3, 0):
        shards = [rows(0, split), rows(split, n)]
        k_pair.reset_launches()
        ranks = _Ranks(2, monkeypatch)
        got = ranks.run(lambda r: t_freq.compute_freq_stats(shards[r], attrs,
                                                            pairs))
        torch.cuda.synchronize()
        assert k_pair.launches == (2 if split else 1)
        for freq in got:
            assert freq.n_rows == n
            assert torch.equal(freq.pair_buffer, want.pair_buffer)
            assert torch.equal(freq.single_buffer, want.single_buffer)
            plain, off = k_pair.pair_counts_plain(
                torch.stack([torch.from_numpy(table.column(a).codes)
                             for a in attrs]),
                [(attrs.index(x), attrs.index(y)) for x, y in pairs],
                [table.column(a).domain_size for a in attrs])
            np.testing.assert_array_equal(off, freq.pair_offsets)
            assert torch.equal(freq.pair_buffer.cpu(), plain)
            hw, tw, nw = k_entropy.entropy_terms_plain(plain, off, n)
            hg, tg, ng = k_entropy.entropy_terms(freq.pair_buffer, off, n)
            torch.cuda.synchronize()
            assert torch.equal(tg.cpu(), tw) and torch.equal(ng.cpu(), nw)
            assert torch.allclose(hg.cpu(), hw, rtol=1e-12, atol=0.0)


@pytest.mark.cuda
def test_live_device_gauges_on_card(card, monkeypatch):
    """The resource sampler reports the caching allocator's bytes on this
    rank's card under the JAX package's gauge names, reading counters
    only: it runs under ``set_sync_debug_mode("error")``."""
    import time
    from delphi_tpu_torch import observability as obs
    T.set_device("cuda")
    held = torch.ones(1 << 20, device="cuda")
    monkeypatch.setenv("DELPHI_METRICS_PORT", "0")
    monkeypatch.setenv("DELPHI_RESOURCE_SAMPLE_S", "0.05")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = obs.start_recording("gauges")
        deadline = time.time() + 10
        while time.time() < deadline:
            gauges = rec.registry.snapshot()["gauges"]
            if "device.bytes_in_use" in gauges:
                break
            time.sleep(0.05)
        obs.stop_recording(rec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    index = torch.cuda.current_device()
    assert gauges[f"device.{index}.bytes_in_use"] >= held.numel() * 4
    assert gauges["device.bytes_in_use"] \
        == gauges[f"device.{index}.bytes_in_use"]
    assert gauges["device.peak_bytes_in_use"] >= gauges["device.bytes_in_use"]
    assert rec.live is None


@pytest.mark.cuda
def test_launch_counts_exact_when_threads_launch_side_by_side(card):
    """Served requests launch K1 and K2 from several threads at once: the
    wrappers' launch counts lose no update (16 threads, 40 calls each, a
    switch interval of a microsecond) and every result equals the plain
    version's."""
    import sys
    import threading

    rng = np.random.default_rng(3)
    vocab = [7, 5, 31]
    n = 4_099
    cpu = torch.from_numpy(np.stack([_codes(rng, n, v) for v in vocab]))
    pairs = [(0, 1), (1, 2), (2, 0)]
    want, off = k_pair.pair_counts_plain(cpu, pairs, vocab)
    _, want_t, _ = k_entropy.entropy_terms_plain(want, off, n)
    codes = cpu.to(card)
    threads, calls, bad = 16, 40, []
    before = (k_pair.launches, k_entropy.launches)

    def work():
        for _ in range(calls):
            got, _ = k_pair.pair_counts(codes, pairs, vocab)
            _, t, _ = k_entropy.entropy_terms(got, off, n)
            if not (torch.equal(got.cpu(), want)
                    and torch.equal(t.cpu(), want_t)):
                bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not bad
    assert (k_pair.launches - before[0],
            k_entropy.launches - before[1]) == (threads * calls,
                                                threads * calls)


@pytest.mark.cuda
def test_served_frame_is_the_card_run_on_card(card, tmp_path):
    """A request served on the card answers the card's ``run()`` frame,
    sorted by all columns, byte for byte, and launches K1 and K2 inside
    the request."""
    import json
    import urllib.request

    from delphi_tpu_torch.observability.serve import RepairServer

    rng = np.random.RandomState(5)
    n = 2_000
    level = rng.randint(0, 10, n)
    df = pd.DataFrame({"tid": np.arange(n),
                       "level": [f"lv{v}" for v in level],
                       "tier": [f"t{v // 2}" for v in level],
                       "band": [f"b{v % 5}" for v in level],
                       "seg": [f"s{v}" for v in rng.randint(0, 4, n)]})
    for col in ("tier", "band"):
        df.loc[rng.rand(n) < 0.2, col] = None
    options = {"error.max_attrs_to_compute_pairwise_stats": "4",
               "model.hp.max_evals": "1"}
    T.set_device("cuda")
    model = T.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()])
    for key, value in options.items():
        model = model.option(key, value)
    out = model.run()
    out = out.sort_values(list(out.columns)).reset_index(drop=True)
    want = json.dumps(json.loads(out.to_json(orient="records")))
    split = json.loads(df.to_json(orient="split"))
    table = {c: [row[i] for row in split["data"]]
             for i, c in enumerate(split["columns"])}
    compile_dir = os.environ.get("DELPHI_COMPILE_CACHE_DIR")
    srv = RepairServer(port=0, workers=2,
                       cache_dir=str(tmp_path / "cache")).start()
    try:
        before = (k_pair.launches, k_entropy.launches)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/repair", method="POST",
            data=json.dumps({"table": table, "row_id": "tid",
                             "options": options}).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
        assert k_pair.launches > before[0]
        assert k_entropy.launches > before[1]
    finally:
        srv.stop()
        if compile_dir is None:
            os.environ.pop("DELPHI_COMPILE_CACHE_DIR", None)
        else:
            os.environ["DELPHI_COMPILE_CACHE_DIR"] = compile_dir
    assert body["status"] == "ok"
    assert json.dumps(body["frame"]) == want


@pytest.mark.cuda
def test_gauntlet_card_matches_cpu(card):
    """``run_gauntlet`` over ``fd_categorical`` and ``correlated_multi`` at
    160 rows on the card and on the CPU: the same injected, repaired and
    correct cell counts, ``train.*`` counters and downstream triples (null
    where scikit-learn does not import, the runner's only stand-in), and
    the card's run launched K1, K2 and K5's integer mode."""
    import chip_smoke as cs
    from delphi_tpu_torch.gauntlet.runner import run_gauntlet
    from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
    names = ["fd_categorical", "correlated_multi"]
    reports = {}
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        before = (k_pair.launches, k_entropy.launches,
                  k_domain.mode_launches["int"])
        with cs.downstream_or_null():
            reports[dev] = run_gauntlet(names=names, rows=160, seed=0)
        if dev == "cuda":
            assert all(a > b for a, b in zip(
                (k_pair.launches, k_entropy.launches,
                 k_domain.mode_launches["int"]), before))
    for n in names:
        cpu = reports["cpu"]["scenarios"][n]
        gpu = reports["cuda"]["scenarios"][n]
        assert not cpu.get("error") and not gpu.get("error")
        assert gpu["repair"] == cpu["repair"] and gpu["repair"]["repairs"]
        assert gpu["counters"] == cpu["counters"]
        assert gpu["downstream"] == cpu["downstream"]


# -- K10: the logistic head's gather step and the Adam step -------------------


def _k10_inputs(shape, dev):
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    t = {k: v.to(dev) if hasattr(v, "shape") else v
         for k, v in chip_smoke.logreg_edge_inputs(shape, sum(shape[:5]))
         .items()}
    plan = k_lin.gather_plan(t["gid"], t["cont"], t["y"], t["sample_w"],
                             t["denom"], t["l2"], t["V"], t["k"])
    return t, plan


def _k10_step(k_lin, t, plan, suffix=""):
    """One gather step through the wrappers (``suffix`` "_plain": the
    plain versions): loss, dlogits, gradients, the updated flat weights
    and moments after two Adam steps."""
    dev = t["Wcat"].device
    n, k = plan.gid.shape[0], plan.k
    loss, dl = torch.empty(1, device=dev), torch.empty((n, k), device=dev)
    getattr(k_lin, "logreg_forward" + suffix)(plan, t["Wcat"], t["Wcont"],
                                              t["b"], loss, dl)
    grads = [torch.empty_like(t["Wcat"]), torch.empty_like(t["Wcont"]),
             torch.empty(k, device=dev)]
    getattr(k_lin, "logreg_backward" + suffix)(plan, dl, t["Wcat"],
                                               t["Wcont"], *grads)
    flat = torch.cat([t["Wcat"].reshape(-1), t["Wcont"].reshape(-1), t["b"]])
    g = torch.cat([x.reshape(-1) for x in grads])
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    for step in (1, 2):
        getattr(k_lin, "adam_step" + suffix)(flat, g, mu, nu, 0.2, step)
    return [loss, dl, *grads, flat, mu, nu]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [chip_smoke.LOGREG_EDGES[0],
                                   chip_smoke.LOGREG_EDGES[2]])
def test_logreg_kernels_match_plain_on_card(card, shape):
    """K10a, K10b and K10c at 4d's shape (10,000 rows, 40 classes) and at
    1,024 classes without continuous columns: one launch each a call, every
    output bit for bit the plain version's on the same card tensors."""
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    t, plan = _k10_inputs(shape, card)
    before = dict(k_lin.launches)
    got = _k10_step(k_lin, t, plan)
    torch.cuda.synchronize()
    assert {n: k_lin.launches[n] - before[n] for n in before} == {
        "logreg_forward": 1, "logreg_backward": 1, "adam_step": 2}
    want = _k10_step(k_lin, t, plan, "_plain")
    for g, w in zip(got, want):
        assert chip_smoke.same_bits(torch, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.LOGREG_EDGES)
def test_logreg_edges_match_plain_on_card(card, shape):
    """``chip_smoke.LOGREG_EDGES`` (k 2 to 33,000, one id, an unseen id,
    C = 0, n = 1, zero weights, ±0.0 and large logits): the kernels'
    outputs bit for bit the plain versions' on the card."""
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    t, plan = _k10_inputs(shape, card)
    got = _k10_step(k_lin, t, plan)
    want = _k10_step(k_lin, t, plan, "_plain")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert chip_smoke.same_bits(torch, g, w)


def _zones(n, k, seed):
    rng = np.random.default_rng(seed)
    latent = rng.integers(0, k, n)
    df = pd.DataFrame({"a": [f"a{v // 2}" for v in latent],
                       "b": [f"b{v % 2}" for v in latent],
                       "x": latent + rng.normal(0, 3, n)})
    y = pd.Series(np.where(rng.random(n) < 0.2, rng.integers(0, k, n),
                           latent).astype(str))
    return df, y


@pytest.mark.cuda
def test_gather_fit_card_matches_cpu(card):
    """A gather fit on the card takes the CPU fit's steps and ends at its
    weights bit for bit: K10a, K10b and K10c give the plain versions'
    bits, and the f64 exponentials and logarithms rounded to f32 agree
    between the two devices. Every step launches each kernel once."""
    from delphi_tpu_torch.models.encoding import FeatureEncoder
    from delphi_tpu_torch.models.linear import LogisticRegressionModel
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    df, y = _zones(5000, 40, 16)
    fits = []
    for dev in ("cpu", "cuda"):
        T.set_device(dev)
        X = FeatureEncoder(["a", "b", "x"], ["x"]).fit_transform_compact(df)
        k_lin.reset_launches()
        fits.append(LogisticRegressionModel().fit(X, y))
    cpu, gpu = fits
    assert gpu._compact is not None
    assert k_lin.launches == {"logreg_forward": gpu.n_steps_run_,
                              "logreg_backward": gpu.n_steps_run_,
                              "adam_step": gpu.n_steps_run_}
    assert cpu.n_steps_run_ == gpu.n_steps_run_
    assert cpu.loss_ == gpu.loss_
    for pc, pg in zip(cpu._params, gpu._params):
        np.testing.assert_array_equal(pc, pg)


@pytest.mark.cuda
def test_dense_mesh_and_mlp_routes_step_with_adam_kernel_on_card(card):
    """The dense logistic route, the mesh route on a one-slot mesh and the
    MLP step with K10c on the card (one launch an applied step, no other
    K10 kernel); their gradients come from autograd over matmuls whose f32
    sums the card orders otherwise than the CPU, so each ends within 1e-3
    relative of the CPU fit's loss rather than bitwise."""
    from delphi_tpu_torch.models import linear as t_lin
    from delphi_tpu_torch.ops.kernels import linear as k_lin
    from delphi_tpu_torch.parallel import mesh as t_mesh
    rng = np.random.default_rng(5)
    n, d, k = 2_000, 16, 24
    latent = rng.integers(0, k, n)
    X = np.zeros((n, d), np.float32)
    X[np.arange(n), latent % d] = 1.0
    X[:, -1] = latent * 0.1 + rng.normal(0, 1, n)
    y = torch.from_numpy(latent.astype(np.int64))
    cw = torch.ones(k)
    yr = (X @ rng.normal(size=d)).astype(np.float32)

    def fits(dev):
        Xd, yd, cwd = (torch.from_numpy(X).to(dev), y.to(dev), cw.to(dev))
        return {
            "dense": t_lin._fit_logreg(Xd, yd, cwd, 1e-4, 0.2, 60),
            "mesh": t_lin._mesh_fit_logreg(t_mesh.Mesh((0,)), X, yd, cwd,
                                           1e-4, 0.2, 60),
            "mlp": t_lin._fit_mlp_regressor(
                Xd, torch.from_numpy(yr).to(dev), 1e-5, 0.01, 80, 64, 42)}

    T.set_device("cpu")
    want = fits("cpu")
    T.set_device("cuda")
    k_lin.reset_launches()
    got = fits("cuda")
    torch.cuda.synchronize()
    steps = sum(r[2] for r in got.values())
    assert k_lin.launches == {"logreg_forward": 0, "logreg_backward": 0,
                              "adam_step": steps}
    for route in got:
        assert got[route][2] == want[route][2]
        assert got[route][1] == pytest.approx(want[route][1], rel=1e-3)
