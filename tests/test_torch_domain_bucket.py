"""The port's bucketed domain route (``delphi_tpu_torch/ops/domain.py``)
and kernel K5's plain version against the JAX package, on the CPU:

* the weak-label demotion mask of the bucketed route, the port's legacy
  route and the JAX package's legacy and bucketed routes, equal (booleans,
  exact) at group sizes around the planner's pow2 buckets and chunk sizes;
* one ``domain.bucket_launches`` count per plan launch, equal to the JAX
  package's, with the same ``launch.phase.domain.weak.*`` counters;
* ``domain.bucket:1:oom`` past its retries halves the batch and leaves the
  frame unchanged;
* K5's plain integer mode equal (int32, exact) to
  ``_jit_bucket_kernel(False)``;
* every ``launch.phase.<phase>.*`` counter equal to the JAX package's for
  the phases where both packages take the same route on the CPU (the
  detection phases differ: the JAX package's CPU backend takes its host
  route, see ``PERF.md``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import observability as j_obs
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.ops import domain as j_domain
from delphi_tpu.ops import entropy as j_entropy
from delphi_tpu.ops import freq as j_freq
from delphi_tpu.parallel import resilience as j_rz
from delphi_tpu.table import discretize_table as j_discretize
from delphi_tpu.table import encode_table as j_encode
from delphi_tpu_torch.ops import domain as t_domain
from delphi_tpu_torch.ops import entropy as t_entropy
from delphi_tpu_torch.ops import freq as t_freq
from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
from delphi_tpu_torch.parallel import resilience as t_rz
from delphi_tpu_torch.table import discretize_table as t_discretize
from delphi_tpu_torch.table import encode_table as t_encode
from delphi_tpu_torch.utils import counters

ALPHA, BETA = 0.0, 0.7


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("DELPHI_DEVICE_TABLE", "DELPHI_PLAN_CHUNK_CELLS",
              "DELPHI_PLAN", "DELPHI_PLAN_MERGE", "DELPHI_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def _frame(n, seed):
    """Three correlated categorical columns, a key-like one, NULLs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 7, n)
    b = (a * 3 + rng.integers(0, 2, n)) % 11
    c = np.where(rng.random(n) < 0.8, a % 5, rng.integers(0, 5, n))
    d = rng.integers(0, 40, n)
    df = pd.DataFrame({"tid": np.arange(n),
                       "a": [f"a{v}" for v in a], "b": [f"b{v}" for v in b],
                       "c": [f"c{v}" for v in c], "d": [f"d{v}" for v in d]})
    for col in ("a", "b", "c"):
        df.loc[rng.random(n) < 0.05, col] = None
    return df


def _mask(lib, df, sizes, seed=0):
    """The package's weak-label mask over ``sizes[i]`` cells of each of
    a, b, c, d (rows drawn with a seed, current values their strings)."""
    encode, disc_of, fq, ent, dom = (
        (j_encode, j_discretize, j_freq, j_entropy, j_domain) if lib is J
        else (t_encode, t_discretize, t_freq, t_entropy, t_domain))
    disc = disc_of(encode(df, "tid"), 80)
    attrs = disc.table.column_names
    pairs = [(x, y) for x in attrs for y in attrs if x != y]
    freq = fq.compute_freq_stats(disc.table, attrs, pairs)
    stats = disc.domain_stats
    pairwise = ent.compute_pairwise_stats(freq.n_rows, freq, pairs, stats)
    rng = np.random.default_rng(seed)
    rows, names, curs = [], [], []
    for attr, size in zip(("a", "b", "c", "d"), sizes):
        r = rng.choice(len(df), size=size, replace=False)
        rows.append(r)
        names += [attr] * size
        curs += [None if pd.isna(v) else str(v) for v in df[attr].to_numpy()[r]]
    cells = (np.concatenate(rows).astype(np.int64),
             np.array(names, dtype=object), np.array(curs, dtype=object))
    return dom.compute_weak_label_mask(
        disc, cells, [], ["a", "b", "c", "d"], freq, pairwise, stats, 3,
        ALPHA, BETA)


@pytest.mark.parametrize("sizes,chunk", [
    ((255, 256, 257, 10), None),
    ((511, 512, 513, 1), "512"),
    ((300, 300, 300, 300), "256"),
    ((1000, 64, 700, 129), "300"),
    ((1, 2, 3, 4), "1"),
])
def test_routes_give_equal_masks_at_bucket_boundaries(sizes, chunk,
                                                      monkeypatch):
    """The demotion mask is the same boolean array on every route."""
    if chunk:
        monkeypatch.setenv("DELPHI_PLAN_CHUNK_CELLS", chunk)
    df = _frame(1200, seed=1)
    bucketed = _mask(T, df, sizes)
    j_bucketed = _mask(J, df, sizes)
    monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    legacy = _mask(T, df, sizes)
    j_legacy = _mask(J, df, sizes)
    assert bucketed.any() and not bucketed.all()
    np.testing.assert_array_equal(bucketed, legacy)
    np.testing.assert_array_equal(bucketed, j_legacy)
    np.testing.assert_array_equal(bucketed, j_bucketed)


def _counted(lib, fn):
    """(result, counters) of ``fn()``: the port's module counters, or the
    JAX package's recorder registry."""
    counters.clear()
    if lib is T:
        return fn(), dict(counters)
    rec = j_obs.start_recording("t")
    try:
        out = fn()
    finally:
        j_obs.stop_recording(rec)
    return out, rec.registry.snapshot()["counters"]


@pytest.mark.parametrize("sizes,chunk", [
    ((255, 256, 257, 10), None),
    ((300, 300, 300, 300), "256"),
    ((1000, 64, 700, 129), "300"),
])
def test_launches_counted_per_bucket(sizes, chunk, monkeypatch):
    if chunk:
        monkeypatch.setenv("DELPHI_PLAN_CHUNK_CELLS", chunk)
    df = _frame(1200, seed=1)
    k_domain.reset_launches()
    _, got = _counted(T, lambda: _mask(T, df, sizes))
    _, want = _counted(J, lambda: _mask(J, df, sizes))
    keys = [k for k in want if k.startswith(("launch.phase.domain.weak.",
                                             "domain.bucket"))]
    assert keys and {k: got.get(k) for k in keys} == \
        {k: want[k] for k in keys}
    assert got["domain.bucket_launches"] == \
        got["launch.phase.domain.weak.launches"]
    # the plain version (a CPU tensor) is no kernel launch
    assert k_domain.launches == 0


def test_k5_launches_the_real_pieces_and_rows(monkeypatch):
    """The plan pads a launch's batch and rows to powers of two and its
    values to a multiple of 32; K5 gets the real pieces, their cells back
    to back and values to the widest piece's, while the recorded plan
    keeps the padded extents."""
    from delphi_tpu_torch.parallel import planner
    layouts, plans = [], []
    orig_wl, orig_plan = k_domain.weak_label, planner.plan_launches

    def rec_wl(ops, *args):
        layouts.append((ops.layout, tuple(ops.tables.shape)))
        return orig_wl(ops, *args)

    def rec_plan(*a, **kw):
        plans.append(orig_plan(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(k_domain, "weak_label", rec_wl)
    monkeypatch.setattr(planner, "plan_launches", rec_plan)
    # a, b and c share one shape bucket (k 3, va_pad 32, vc_pad 8)
    _mask(T, _frame(1200, seed=1), (300, 257, 290, 0))
    launch, = [p for p in plans if p.phase == "domain.weak"][0].launches
    assert (launch.batch_pad, launch.padded_size) == (4, 512)
    assert [span.size for span in launch.spans] == [300, 257, 290]
    (layout, tables), = layouts
    assert launch.shape[2] == 32
    assert [m for m, _ in layout.extents] == [300, 257, 290]
    assert layout.cells == 847
    # b has the most values: 11 (and the table's NULL column)
    assert layout.va == 11 and tables[0] == 3 and tables[3] == 12


def _detect_frame(lib, df):
    return lib.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .option("error.max_attrs_to_compute_pairwise_stats", "4") \
        .run(detect_errors_only=True)


def test_bucket_oom_halves_the_batch_and_keeps_the_frame(monkeypatch):
    """``domain.bucket:1:oom`` with no retries left: the shrink rung splits
    the first launch's batch in two; the frame is the unfaulted one (and
    the JAX package's)."""
    df = _frame(1500, seed=2)
    want = _detect_frame(J, df)
    _, clean = _counted(T, lambda: _detect_frame(T, df))
    assert clean["domain.bucket_pieces"] > clean["domain.bucket_launches"]
    monkeypatch.setenv("DELPHI_RETRY_MAX", "0")
    monkeypatch.setenv("DELPHI_FAULT_PLAN", "domain.bucket:1:oom")
    t_rz.reset_fault_state()
    got, faulted = _counted(T, lambda: _detect_frame(T, df))
    pd.testing.assert_frame_equal(got, want)
    assert faulted["resilience.faults.oom"] == 1
    assert faulted["resilience.degrade.shrink"] == 1
    # the failed launch counts (as in the JAX package), then its halves
    assert faulted["domain.bucket_launches"] == \
        clean["domain.bucket_launches"] + 2
    assert faulted["domain.bucket_pieces"] > clean["domain.bucket_pieces"]
    assert faulted["domain.cells_fixed"] == clean["domain.cells_fixed"]


def _k5_operands(seed, b, k, va_pad, vc_pad, rows_pad, n_cols, n_rows):
    rng = np.random.default_rng(seed)
    codes = np.full((n_cols, n_rows + 1), -1, np.int32)
    codes[:, :n_rows] = rng.integers(-1, vc_pad - 1, (n_cols, n_rows))
    col_idx = rng.integers(0, n_cols, (b, k)).astype(np.int32)
    taus = rng.integers(0, 3, (b, k)).astype(np.int32)
    hs = rng.integers(0, 2, (b, va_pad)).astype(np.int32)
    row_idx = rng.integers(0, n_rows + 1, (b, rows_pad)).astype(np.int32)
    tables = rng.integers(0, 6, (b, k, vc_pad, va_pad + 1)).astype(np.int32)
    return codes, col_idx, taus, hs, row_idx, tables


def _k5_pieces(ops):
    """The padded operands as K5's pieces: piece i's cells are its row
    indices (the sentinel column among them), every piece va_pad wide."""
    codes, col_idx, taus, hs, row_idx, tables = ops
    k, vc_pad = col_idx.shape[1], tables.shape[2]
    pieces = [k_domain.Piece(rows=row_idx[i], col_idx=col_idx[i],
                             taus=taus[i], vcs=[vc_pad] * k, hs=hs[i],
                             rank=np.arange(hs.shape[1]), tables=tables[i])
              for i in range(len(col_idx))]
    blob, layout = k_domain.pack(pieces, vc_pad)
    return k_domain.Operands(torch.from_numpy(codes), torch.from_numpy(blob),
                             layout)


@pytest.mark.parametrize("shape", [
    (1, 1, 32, 8, 256, 2, 300),
    (4, 3, 32, 16, 512, 5, 2000),
    (2, 2, 64, 8, 256, 3, 100),
    (8, 4, 96, 32, 256, 6, 5000),
])
def test_k5_plain_equals_jit_bucket_kernel(shape):
    """K5's plain version (integer mode) against the integer mode of the
    JAX package's ``_jit_bucket_kernel`` on the same seeded operands: int32
    sums and the contributed flags equal, exactly."""
    b, k, va_pad, vc_pad, rows_pad, n_cols, n_rows = shape
    ops = _k5_operands(sum(shape), *shape)
    codes, col_idx, taus, hs, row_idx, tables = ops
    big, tiny, contributed = k_domain.split_scores(
        k_domain.domain_scores(_k5_pieces(ops)), b * rows_pad, va_pad)
    blob = np.concatenate([col_idx.ravel(), taus.ravel(), hs.ravel(),
                           row_idx.ravel(), tables.ravel()])
    kernel = j_domain._jit_bucket_kernel(False)
    j_big, j_tiny, j_con = kernel(blob, codes, b, k, va_pad, vc_pad,
                                  rows_pad, 0.0, 1.0)
    assert big.dtype == torch.int32 and contributed.dtype == torch.bool
    want = (b * rows_pad, va_pad)
    np.testing.assert_array_equal(big.numpy(),
                                  np.asarray(j_big).reshape(want))
    np.testing.assert_array_equal(tiny.numpy(),
                                  np.asarray(j_tiny).reshape(want))
    np.testing.assert_array_equal(contributed.numpy(),
                                  np.asarray(j_con).reshape(want))
    assert big.numpy().any() and contributed.numpy().any()


def test_k5_rejects_bad_operands():
    ops = _k5_pieces(_k5_operands(0, 2, 2, 32, 8, 256, 3, 100))
    with pytest.raises(ValueError, match="blob"):
        k_domain.Operands(ops.codes, ops.blob[1:], ops.layout)
    with pytest.raises(ValueError, match="int32"):
        k_domain.Operands(ops.codes.long(), ops.blob, ops.layout)


# scenario -> options of one full run
RUNS = {
    "missing_heavy": {"error.max_attrs_to_compute_pairwise_stats": "4",
                      "model.hp.max_evals": "1"},
    "missing_heavy grid": {"error.max_attrs_to_compute_pairwise_stats": "4"},
    "fd_categorical": {"model.hp.max_evals": "1"},
}
# phases whose plans differ by route on the CPU: the JAX package detects on
# its host route there (no device extents), and labels entropy pieces by
# its Pallas-or-host route
_ROUTE_PHASES = ("launch.phase.detect", "launch.phase.entropy")


@pytest.mark.parametrize("case", sorted(RUNS))
def test_launch_phase_counters_equal_the_jax_packages(case):
    name = case.split(" ")[0]
    df = generate_scenario(name, 2000, seed=0).dirty

    def run(lib):
        m = lib.delphi.repair.setInput(df).setRowId("tid") \
            .setErrorDetectors([lib.NullErrorDetector()])
        for k, v in RUNS[case].items():
            m = m.option(k, v)
        return m.run()

    got_frame, got = _counted(T, lambda: run(T))
    want_frame, want = _counted(J, lambda: run(J))
    pd.testing.assert_frame_equal(got_frame, want_frame)
    phases = lambda c: {k: v for k, v in c.items()  # noqa: E731
                        if k.startswith("launch.phase.")
                        and not k.startswith(_ROUTE_PHASES)}
    assert phases(got) == phases(want)
    assert any(k.startswith("launch.phase.domain.weak.") for k in got)
    assert any(k.startswith("launch.phase.freq.pairs.") for k in got)
    if "grid" in case:
        assert any(k.startswith("launch.phase.gbdt.cv[") for k in got)
    # the entropy plan's counts equal too: one uniform route in each
    for k in ("plans", "launches", "buckets", "pieces", "padded_units",
              "useful_units"):
        key = f"launch.phase.entropy.{k}"
        assert got.get(key) == want.get(key)
