"""K5's weak-label mode (``delphi_tpu_torch/ops/kernels/domain_scores.py``)
and the bucketed route that launches it, against numpy and the JAX package
on the CPU. Every comparison is exact (tolerance 0: booleans, ints, and
f64 bits):

* the plain epilogue's row sums equal ``np.sum(axis=1)`` bit for bit for
  every row length from 1 to 300 (numpy's ``pairwise_sum`` order, which
  the card repeats); a left-to-right sum does not, so the test can fail;
* ``(has_domain, top)`` of the weak-label plain version equals the JAX
  package's host numpy route on the same operands (its integer mode,
  ``_combine_scores``, then the pick of ``_weak_label_groups``), on seeded
  launches and on hand-built cells: rank-broken ties, nothing active,
  a probability exactly at beta, pieces of different widths;
* the port's demote mask (no ledger, weak-label mode) equals the JAX
  package's on ``missing_heavy`` and ``fd_categorical`` at 2,000 rows, at
  bucket boundaries;
* a run with a provenance ledger takes the integer mode, and its domain
  sizes equal the JAX package's; a run without one never combines on the
  host.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.observability import provenance as j_prov
from delphi_tpu.ops import domain as j_domain
from delphi_tpu.ops import entropy as j_entropy
from delphi_tpu.ops import freq as j_freq
from delphi_tpu.table import discretize_table as j_discretize
from delphi_tpu.table import encode_table as j_encode
from delphi_tpu_torch.observability import provenance as t_prov
from delphi_tpu_torch.ops import domain as t_domain
from delphi_tpu_torch.ops import entropy as t_entropy
from delphi_tpu_torch.ops import freq as t_freq
from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
from delphi_tpu_torch.table import discretize_table as t_discretize
from delphi_tpu_torch.table import encode_table as t_encode

BETA = 0.3


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("DELPHI_DEVICE_TABLE", "DELPHI_PLAN_CHUNK_CELLS",
              "DELPHI_PLAN", "DELPHI_PLAN_MERGE", "DELPHI_FAULT_PLAN",
              "DELPHI_PROVENANCE_PATH"):
        monkeypatch.delenv(k, raising=False)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


# -- the row sum -------------------------------------------------------------

def _sums(va, seed, k=3):
    """Seeded integer sums of 64 cells and va values, at the magnitudes K5
    produces (big up to 2^31 / k, tiny up to k), with scales mixed per
    cell so that the order of addition matters."""
    rng = np.random.default_rng(seed)
    scale = 2 ** rng.integers(0, 31, (64, 1))
    big = (rng.random((64, va)) * scale).astype(np.int64) \
        % (2 ** 31 // k)
    big[rng.random((64, va)) < 0.3] = 0
    tiny = rng.integers(0, k + 1, (64, va))
    return big.astype(np.int32), tiny.astype(np.int32)


def _numpy_scores(big, tiny, n_rows):
    return (big.astype(np.float64) + 0.1 * tiny.astype(np.float64)) / n_rows


@settings(max_examples=60, deadline=None, derandomize=True)
@given(va=st.integers(1, 300), seed=st.integers(0, 2 ** 16))
@example(va=7, seed=1)
@example(va=8, seed=2)
@example(va=9, seed=3)
@example(va=128, seed=4)
@example(va=129, seed=5)
@example(va=136, seed=6)
@example(va=300, seed=7)
def test_plain_row_sums_equal_numpy_bitwise(va, seed):
    big, tiny = _sums(va, seed)
    n_rows = 1_000_003
    want_score = _numpy_scores(big, tiny, n_rows)
    score = (torch.from_numpy(big).double()
             + 0.1 * torch.from_numpy(tiny).double()) / float(n_rows)
    assert np.array_equal(score.numpy().view(np.int64),
                          want_score.view(np.int64))
    got = k_domain.pairwise_rowsum(score).numpy()
    want = want_score.sum(axis=1, keepdims=True)[:, 0]
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_left_to_right_sum_differs_from_numpy():
    """The order matters at these magnitudes: a sequential row sum misses
    numpy's on some row, so the test above would catch a reordering."""
    missed = 0
    for va in (9, 16, 64, 129, 300):
        big, tiny = _sums(va, va)
        score = _numpy_scores(big, tiny, 997)
        seq = np.zeros(len(score))
        for j in range(va):
            seq = seq + score[:, j]
        missed += int((seq != score.sum(axis=1)).sum())
    assert missed > 0


# -- the weak-label mode against the JAX package's host route ---------------

def _jax_pick(prob, contributed, vocab_rank, beta):
    """The pick of ``delphi_tpu/ops/domain.py::_weak_label_groups``
    (:416-428) on one chunk: (has_domain, top)."""
    keep = contributed & (prob > beta)
    masked = np.where(keep, prob, -np.inf)
    best_p = masked.max(axis=1)
    has_domain = best_p > -np.inf
    ties = masked == best_p[:, None]
    rank_masked = np.where(ties, vocab_rank[None, :], np.iinfo(np.int64).max)
    return has_domain, rank_masked.argmin(axis=1)


def _random_launch(seed, b, k, vc, n_rows, va_of=None):
    """Seeded pieces of one launch over a [6, n_rows] code matrix; piece i
    has ``va_of[i]`` values (random when None) and real table rows ``vc``
    (the launch's vc_pad)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, vc - 1, (6, n_rows)).astype(np.int32)
    pieces = []
    for i in range(b):
        v_a = int(va_of[i]) if va_of is not None else int(rng.integers(1, 40))
        tables = rng.integers(0, 7, (k, vc, v_a + 1)).astype(np.int32)
        tables[rng.random(tables.shape) < 0.4] = 1
        pieces.append(k_domain.Piece(
            rows=rng.integers(0, n_rows, int(rng.integers(0, 300))),
            col_idx=rng.integers(0, 6, k), taus=rng.integers(0, 3, k),
            vcs=[vc] * k, hs=rng.random(v_a) < 0.85,
            rank=rng.permutation(v_a), tables=tables))
    return codes, pieces


def _port(codes, pieces, vc_pad, beta, n_rows, weak=True):
    blob, layout = k_domain.pack(pieces, vc_pad)
    ops = k_domain.Operands(torch.from_numpy(codes), torch.from_numpy(blob),
                            layout)
    if weak:
        return layout, k_domain.split_weak(
            k_domain.weak_label(ops, beta, n_rows), layout.cells)
    return layout, k_domain.split_scores(k_domain.domain_scores(ops),
                                         layout.cells, layout.va)


def _jax_host_route(codes, pieces, vc_pad, beta, n_rows):
    """Per piece: the JAX package's integer mode (``_jit_bucket_kernel``
    over the padded launch), ``_combine_scores`` and the pick."""
    b, k = len(pieces), len(pieces[0].col_idx)
    va = max(len(p.hs) for p in pieces)
    rows_pad = max(1, max(len(p.rows) for p in pieces))
    sentinel = codes.shape[1]
    all_codes = np.concatenate(
        [codes, np.full((codes.shape[0], 1), -1, np.int32)], axis=1)
    col_idx = np.stack([p.col_idx for p in pieces]).astype(np.int32)
    taus = np.stack([p.taus for p in pieces]).astype(np.int32)
    hs = np.zeros((b, va), np.int32)
    row_idx = np.full((b, rows_pad), sentinel, np.int32)
    tables = np.zeros((b, k, vc_pad, va + 1), np.int32)
    for i, p in enumerate(pieces):
        hs[i, :len(p.hs)] = p.hs
        row_idx[i, :len(p.rows)] = p.rows
        tables[i, :, :, :len(p.hs) + 1] = p.tables
    blob = np.concatenate([col_idx.ravel(), taus.ravel(), hs.ravel(),
                           row_idx.ravel(), tables.ravel()])
    big, tiny, con = (np.asarray(a) for a in j_domain._jit_bucket_kernel(
        False)(blob, all_codes, b, k, va, vc_pad, rows_pad, 0.0, 1.0))
    has, top = [], []
    for i, p in enumerate(pieces):
        m, v_a = len(p.rows), len(p.hs)
        prob, contrib = j_domain._combine_scores(
            big[i, :m, :v_a].astype(np.int64),
            tiny[i, :m, :v_a].astype(np.int64), con[i, :m, :v_a], n_rows)
        h, t = _jax_pick(prob, contrib, np.asarray(p.rank, np.int64), beta)
        has.append(h)
        top.append(t)
    return np.concatenate(has), np.concatenate(top)


@pytest.mark.parametrize("seed,b,k,vc", [
    (0, 1, 1, 8), (1, 3, 2, 16), (2, 5, 3, 8), (3, 2, 4, 32), (4, 4, 2, 64),
])
def test_weak_plain_equals_jax_host_route(seed, b, k, vc):
    n_rows = 5_000
    codes, pieces = _random_launch(seed, b, k, vc, n_rows)
    _, (has, top) = _port(codes, pieces, vc, BETA, n_rows)
    want_has, want_top = _jax_host_route(codes, pieces, vc, BETA, n_rows)
    np.testing.assert_array_equal(has.numpy(), want_has)
    # top of a cell with no domain is never read; it is still the same
    np.testing.assert_array_equal(top.numpy(), want_top)
    assert want_has.any() and not want_has.all()


@pytest.mark.parametrize("va", [1, 7, 8, 9, 128, 129, 136, 300])
def test_weak_plain_equals_jax_at_row_sum_boundaries(va):
    """Pieces of va values (and a narrower one beside it, so that the
    wide piece's width pads the other's values)."""
    n_rows = 40_000
    codes, pieces = _random_launch(va, 2, 2, 8, n_rows,
                                   va_of=[va, max(1, va // 3)])
    beta = 0.5 / va
    _, (has, top) = _port(codes, pieces, 8, beta, n_rows)
    want_has, want_top = _jax_host_route(codes, pieces, 8, beta, n_rows)
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_array_equal(top.numpy(), want_top)


def _hand_piece(counts, rank, hs=None):
    """One cell, one correlate: the cell's code 0 gathers table row 1, so
    ``counts`` are its values' pair counts."""
    v_a = len(counts)
    tables = np.zeros((1, 2, v_a + 1), np.int32)
    tables[0, 1, 1:] = counts
    return k_domain.Piece(
        rows=np.zeros(1, np.int64), col_idx=[0], taus=[0], vcs=[2],
        hs=np.ones(v_a, bool) if hs is None else np.asarray(hs, bool),
        rank=np.asarray(rank), tables=tables)


def test_weak_hand_built_cells_equal_jax():
    """Hand-built counts (each cell its own piece): ties broken by rank (the tie's lower slot has the higher rank),
    nothing active, a probability exactly at beta, a value without a
    singleton (hs 0), and counts of one (tiny)."""
    beta = 0.25
    n_rows = 8
    cells = [
        ([3, 3, 0, 1], [2, 0, 1, 3], None),     # tie 0.4 / 0.4: rank picks 1
        ([0, 0, 0, 0], [0, 1, 2, 3], None),     # nothing active: no domain
        ([2, 2, 3, 0], [0, 1, 2, 3], None),     # 0.25 is not > beta: slot 2
        ([2, 2, 2, 2], [3, 2, 1, 0], None),     # every prob at beta: none
        ([9, 9, 1, 0], [1, 0, 2, 3], [0, 1, 1, 1]),  # hs masks slot 0
        ([1, 1, 1, 0], [2, 1, 0, 3], None),     # tinies tie: lowest rank
        ([5], [0], None),                       # one value
    ]
    codes = np.zeros((1, 1), np.int32)
    pieces = [_hand_piece(*cell) for cell in cells]
    _, (has, top) = _port(codes, pieces, 2, beta, n_rows)
    want_has, want_top = _jax_host_route(codes, pieces, 2, beta, n_rows)
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_array_equal(top.numpy(), want_top)
    np.testing.assert_array_equal(
        want_has, [True, False, True, False, True, True, True])
    assert list(want_top[[0, 2, 4, 5, 6]]) == [1, 2, 1, 2, 0]


def near_tie_piece():
    """One cell, 12 correlates: value 0 sums big 1 and tiny 2 (x = 1.2),
    value 1 tiny 12 (x = 1.2000000000000002, an ulp above), value 2
    nothing; vocab ranks put value 0 first. Whether the two probabilities
    tie depends on n_rows: at 35 they do, at 8 they do not."""
    tables = np.zeros((12, 2, 4), np.int32)
    tables[0, 1, 1] = 2
    tables[1:3, 1, 1] = 1
    tables[:, 1, 2] = 1
    return np.zeros((12, 1), np.int32), k_domain.Piece(
        rows=np.zeros(1, np.int64), col_idx=np.arange(12), taus=[0] * 12,
        vcs=[2] * 12, hs=np.ones(3, bool), rank=np.array([0, 1, 2]),
        tables=tables)


@pytest.mark.parametrize("n_rows,top", [(35, 0), (8, 1)])
def test_weak_plain_near_tie_numerators_equal_jax(n_rows, top):
    """Numerators an ulp apart: their probabilities tie (rank decides) or
    not (the larger wins), as in the JAX package's host route."""
    codes, piece = near_tie_piece()
    _, (has, got_top) = _port(codes, [piece], 2, BETA, n_rows)
    want_has, want_top = _jax_host_route(codes, [piece], 2, BETA, n_rows)
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_array_equal(got_top.numpy(), want_top)
    assert bool(has[0]) and int(got_top[0]) == top


def test_int_mode_plain_equals_jit_bucket_kernel_on_compact_pieces():
    """The integer mode on the packed (compact) layout gives each piece's
    real [cells, values] block of the JAX package's integer mode."""
    codes, pieces = _random_launch(11, 4, 3, 16, 3_000)
    layout, (big, tiny, con) = _port(codes, pieces, 16, BETA, 3_000,
                                     weak=False)
    b, k = len(pieces), 3
    va = layout.va
    rows_pad = max(len(p.rows) for p in pieces)
    all_codes = np.concatenate([codes, np.full((6, 1), -1, np.int32)], 1)
    row_idx = np.full((b, rows_pad), 3_000, np.int32)
    hs = np.zeros((b, va), np.int32)
    tables = np.zeros((b, k, 16, va + 1), np.int32)
    for i, p in enumerate(pieces):
        row_idx[i, :len(p.rows)] = p.rows
        hs[i, :len(p.hs)] = p.hs
        tables[i, :, :, :len(p.hs) + 1] = p.tables
    blob = np.concatenate([np.stack([p.col_idx for p in pieces]).ravel(),
                           np.stack([p.taus for p in pieces]).ravel(),
                           hs.ravel(), row_idx.ravel(), tables.ravel()]) \
        .astype(np.int32)
    j_big, j_tiny, j_con = (np.asarray(a) for a in j_domain._jit_bucket_kernel(
        False)(blob, all_codes, b, k, va, 16, rows_pad, 0.0, 1.0))
    at = 0
    for i, p in enumerate(pieces):
        m = len(p.rows)
        for got, want in ((big, j_big), (tiny, j_tiny), (con, j_con)):
            np.testing.assert_array_equal(got.numpy()[at:at + m],
                                          want[i, :m])
        at += m


# -- the route ---------------------------------------------------------------

def _cells(df, attrs, sizes, seed):
    rng = np.random.default_rng(seed)
    rows, names, curs = [], [], []
    for attr, size in zip(attrs, sizes):
        r = rng.choice(len(df), size=size, replace=False)
        rows.append(r)
        names += [attr] * size
        curs += [None if pd.isna(v) else str(v)
                 for v in df[attr].to_numpy()[r]]
    return (np.concatenate(rows).astype(np.int64),
            np.array(names, dtype=object), np.array(curs, dtype=object))


def _mask(lib, df, attrs, cells, beta=BETA, alpha=0.0):
    encode, disc_of, fq, ent, dom = (
        (j_encode, j_discretize, j_freq, j_entropy, j_domain) if lib is J
        else (t_encode, t_discretize, t_freq, t_entropy, t_domain))
    disc = disc_of(encode(df, "tid"), 80)
    names = disc.table.column_names
    pairs = [(x, y) for x in names for y in names if x != y]
    freq = fq.compute_freq_stats(disc.table, names, pairs)
    stats = disc.domain_stats
    pairwise = ent.compute_pairwise_stats(freq.n_rows, freq, pairs, stats)
    return dom.compute_weak_label_mask(disc, cells, [], attrs, freq,
                                       pairwise, stats, 3, alpha, beta)


SCENARIOS = {
    "missing_heavy": (["tier", "band", "grade", "level", "segment"],
                      [255, 256, 257, 513, 1]),
    "fd_categorical": (["city", "state", "region", "channel"],
                       [511, 512, 129, 300]),
}


@pytest.mark.parametrize("name,chunk", [
    ("missing_heavy", None), ("missing_heavy", "256"),
    ("fd_categorical", None), ("fd_categorical", "300"),
])
def test_weak_label_mask_equals_jax(name, chunk, monkeypatch):
    """No ledger, so every bucketed piece takes the weak-label mode: the
    demote mask equals the JAX package's (both routes there) and the
    port's legacy route's, at 2,000 rows."""
    if chunk:
        monkeypatch.setenv("DELPHI_PLAN_CHUNK_CELLS", chunk)
    df = generate_scenario(name, 2000, seed=0).dirty
    attrs, sizes = SCENARIOS[name]
    cells = _cells(df, attrs, sizes, seed=1)
    calls = []
    orig = k_domain.weak_label
    monkeypatch.setattr(k_domain, "weak_label",
                        lambda *a: calls.append(a) or orig(*a))
    got = _mask(T, df, attrs, cells)
    assert calls
    want = _mask(J, df, attrs, cells)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    np.testing.assert_array_equal(_mask(T, df, attrs, cells), got)
    np.testing.assert_array_equal(_mask(J, df, attrs, cells), got)
    assert got.any() and not got.all()


def test_ledger_run_takes_the_integer_mode(monkeypatch):
    """With a provenance ledger, K5 runs its integer mode (the host
    records each cell's domain size): the sizes and the mask equal the
    JAX package's."""
    df = generate_scenario("fd_categorical", 2000, seed=0).dirty
    attrs, sizes = SCENARIOS["fd_categorical"]
    cells = _cells(df, attrs, sizes, seed=2)
    modes = []
    for name in ("weak_label", "domain_scores"):
        orig = getattr(k_domain, name)
        monkeypatch.setattr(k_domain, name, lambda *a, _o=orig, _n=name: (
            modes.append(_n), _o(*a))[1])
    out = {}
    for lib, prov in ((T, t_prov), (J, j_prov)):
        led = prov.ProvenanceLedger(":memory:")
        led.record_detection("null", cells[0], cells[1], cells[0])
        with prov.scoped_ledger(led):
            mask = _mask(lib, df, attrs, cells)
        out[lib] = (mask, {k: e.get("domain_size")
                           for k, e in led._cells.items()})
    assert modes and set(modes) == {"domain_scores"}
    np.testing.assert_array_equal(out[T][0], out[J][0])
    assert out[T][1] == out[J][1]
    assert any(v for v in out[T][1].values())


def test_no_ledger_bucketed_run_never_combines_on_host(monkeypatch):
    df = generate_scenario("missing_heavy", 2000, seed=0).dirty
    attrs, sizes = SCENARIOS["missing_heavy"]
    cells = _cells(df, attrs, sizes, seed=3)
    calls = []
    orig = t_domain._combine_scores
    monkeypatch.setattr(t_domain, "_combine_scores",
                        lambda *a: calls.append(1) or orig(*a))
    mask = _mask(T, df, attrs, cells)
    assert not calls and mask.any()
    # the legacy route does combine on the host (so the spy sees calls)
    monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    np.testing.assert_array_equal(_mask(T, df, attrs, cells), mask)
    assert calls


def test_launch_layout_and_shape():
    """The parameter table's layout (mirrored in csrc/domain_scores.cu)
    and the launch shape: tables staged in shared memory up to the budget
    (each row at an odd pitch), read through L2 past it; a grid that
    covers the longest piece and no more blocks than fill the SMs."""
    import ctypes
    assert ctypes.sizeof(k_domain.DomainTable) == 136
    assert k_domain.DomainTable.k.offset == 112
    main = k_domain.Layout(2, 6, 16, ((220_000, 5), (220_000, 5),
                                      (220_000, 6)))
    shape = k_domain.launch_shape(main, True, 132)
    assert shape["shared"] and shape["grid"] == (352, 3)
    assert shape["smem"] == 4 * (256 * 2 + 3 * 2 + 2 * 6 + 2 * 16 * 7)
    # 3 * 64 * 61 int32 fit the budget, 3 * 512 * 301 do not
    fits = k_domain.Layout(3, 60, 64, ((50_000, 60),))
    past = k_domain.Layout(3, 300, 512, ((50_000, 300),))
    assert k_domain.launch_shape(fits, True, 132)["shared"]
    assert not k_domain.launch_shape(past, False, 132)["shared"]
    tiny = k_domain.Layout(1, 3, 8, ((7, 3),))
    assert k_domain.launch_shape(tiny, True, 132)["grid"] == (1, 1)
