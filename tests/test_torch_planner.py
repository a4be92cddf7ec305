"""The port's launch planner (``delphi_tpu_torch/parallel/planner.py``)
against the JAX package's: every case of ``tests/test_planner.py`` run on
the port's planner, then the two packages' plans compared for the same
pieces and policy (signatures and payloads equal, exactly: plans are pure
data), over hand-picked and hypothesis-drawn pieces and policies, and
plan stores written by either package loaded by the other.
"""

import json
import warnings

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from delphi_tpu.parallel import planner as j_planner
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.parallel.planner import Piece
from delphi_tpu_torch.utils import counters, gauges


@pytest.fixture(autouse=True)
def _pristine_planner(monkeypatch):
    # no armed store, no thread fingerprint, planner knobs at defaults
    for mod in (planner, j_planner):
        monkeypatch.setattr(mod, "_store", None)
        monkeypatch.setattr(mod, "_env_store", None)
    monkeypatch.delenv("DELPHI_PLAN", raising=False)
    monkeypatch.delenv("DELPHI_PLAN_DIR", raising=False)
    monkeypatch.delenv("DELPHI_PLAN_MERGE", raising=False)
    monkeypatch.delenv("DELPHI_PLAN_CHUNK_CELLS", raising=False)
    monkeypatch.delenv("DELPHI_PLAN_CV_INSTANCE_CAP", raising=False)
    monkeypatch.delenv("DELPHI_DOMAIN_CHUNK_CELLS", raising=False)
    monkeypatch.delenv("DELPHI_CV_INSTANCE_CAP", raising=False)
    monkeypatch.delenv("DELPHI_PLAN_COST", raising=False)
    yield


def _coverage(plan):
    """{piece_key: sorted [lo, hi) spans} across every launch of the plan."""
    cov = {}
    for launch in plan.launches:
        for s in launch.spans:
            cov.setdefault(s.key, []).append((s.lo, s.lo + s.size))
    return {k: sorted(v) for k, v in cov.items()}


PIECES = [Piece(key=0, size=100, shape=("a",)),
          Piece(key=1, size=7, shape=("a",)),
          Piece(key=2, size=513, shape=("b", 4)),
          Piece(key=3, size=1, shape=("a",)),
          Piece(key=4, size=64, shape=("b", 4))]


@pytest.mark.parametrize("kw", [
    {},
    {"chunk": 32},
    {"chunk": 32, "batch_cap": 3, "pad_batch": True},
    {"batch_cap": 2},
    {"pad_to_max": True},
    {"merge": True, "chunk": 16},
    {"size_floor": 16, "chunk": 50},
])
def test_every_piece_covered_exactly_once(kw):
    plan = planner.plan_launches("t.cover", PIECES, **kw)
    cov = _coverage(plan)
    assert set(cov) == {p.key for p in PIECES}
    for p in PIECES:
        spans = cov[p.key]
        # contiguous, non-overlapping, and spanning exactly [0, size)
        assert spans[0][0] == 0 and spans[-1][1] == p.size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_zero_size_pieces_are_dropped():
    plan = planner.plan_launches(
        "t.zero", [Piece(key=0, size=0), Piece(key=1, size=5)])
    assert _coverage(plan) == {1: [(0, 5)]}


def test_padded_sizes_are_pow2_and_floored():
    plan = planner.plan_launches("t.pow2", PIECES, size_floor=16, chunk=100)
    for launch in plan.launches:
        p = launch.padded_size
        assert p >= 16 and (p & (p - 1)) == 0
        assert all(s.size <= p for s in launch.spans)


def test_pad_batch_pow2s_the_batch_axis():
    plan = planner.plan_launches(
        "t.batch", [Piece(key=i, size=8) for i in range(5)],
        batch_cap=3, pad_batch=True)
    for launch in plan.launches:
        b = launch.batch_pad
        assert b >= len(launch.spans) and (b & (b - 1)) == 0
    # without pad_batch the batch axis is exact
    plan = planner.plan_launches(
        "t.batch2", [Piece(key=i, size=8) for i in range(5)], batch_cap=3)
    assert sorted(l.batch_pad for l in plan.launches) == [2, 3]


def test_batch_width_fixes_cap_and_pad():
    plan = planner.plan_launches(
        "t.width", [Piece(key=i, size=1, shape=(64,)) for i in range(10)],
        batch_width=4)
    assert [len(l.spans) for l in plan.launches] == [4, 4, 2]
    assert all(l.batch_pad == 4 for l in plan.launches)


def test_pad_to_max_pads_each_shape_bucket_to_its_longest_span():
    plan = planner.plan_launches(
        "t.longest",
        [Piece(key=0, size=9, shape=("p",)), Piece(key=1, size=33,
                                                   shape=("p",)),
         Piece(key=2, size=5, shape=("q",))],
        pad_to_max=True)
    by_shape = {l.shape: l.padded_size for l in plan.launches}
    assert by_shape == {("p",): 33, ("q",): 5}


def test_plans_are_deterministic():
    a = planner.plan_launches("t.det", PIECES, chunk=32, batch_cap=3,
                              pad_batch=True, merge=True)
    b = planner.plan_launches("t.det", PIECES, chunk=32, batch_cap=3,
                              pad_batch=True, merge=True)
    assert a.signature == b.signature
    assert a.launches == b.launches


def test_merge_never_increases_launch_count():
    pieces = [Piece(key=i, size=s)
              for i, s in enumerate([3, 5, 9, 17, 33, 65, 100, 120, 128])]
    for cap in (1, 2, 4, None):
        merged = planner.plan_launches("t.merge", pieces, batch_cap=cap,
                                       merge=True)
        plain = planner.plan_launches("t.plain", pieces, batch_cap=cap)
        assert merged.n_launches <= plain.n_launches
        assert _coverage(merged) == _coverage(plain)
        if cap is None:
            # everything within the default x8 ratio folds into one launch
            assert merged.merged_buckets > 0


def test_plan_disabled_pins_legacy_grouping(monkeypatch):
    merged = planner.plan_launches("t.ab", PIECES, merge=True)
    monkeypatch.setenv("DELPHI_PLAN", "0")
    legacy = planner.plan_launches("t.ab", PIECES, merge=True)
    plain = planner.plan_launches("t.ab2", PIECES)
    assert legacy.merged_buckets == 0
    assert [(l.shape, l.padded_size, tuple(l.spans))
            for l in legacy.launches] \
        == [(l.shape, l.padded_size, tuple(l.spans))
            for l in plain.launches]
    # toggling the knob changes the signature, so a persisted merged plan
    # can never be replayed by a DELPHI_PLAN=0 run
    assert legacy.signature != merged.signature


def test_pad_waste_accounting():
    plan = planner.plan_launches(
        "t.waste", [Piece(key=0, size=5), Piece(key=1, size=3)],
        pad_batch=True, batch_cap=1)
    assert plan.useful_units == 8
    assert plan.padded_units == 8 + 4  # pow2 pads: 8 and 4
    assert plan.pad_waste_ratio == pytest.approx(1 - 8 / 12)


def test_persisted_plan_reloads_and_invalidates(tmp_path):
    planner.set_plan_store(str(tmp_path))
    try:
        fp = "f" * 40
        cold = planner.plan_launches("t.store", PIECES, fingerprint=fp)
        assert not cold.cached
        warm = planner.plan_launches("t.store", PIECES, fingerprint=fp)
        assert warm.cached
        assert warm.launches == cold.launches
        # stored as pure data on disk, framed by the durable-store
        # envelope (header line + JSON payload)
        from delphi_tpu_torch.parallel import store as dstore
        doc, status = dstore.read_json(
            str(tmp_path / f"{fp}.json"), schema="launch_plan",
            site="store.plan", root=str(tmp_path))
        assert status == "ok"
        assert doc["phases"]["t.store"]["signature"] == cold.signature

        # piece-set change invalidates: replan, store updated
        changed = planner.plan_launches(
            "t.store", PIECES + [Piece(key=9, size=11)], fingerprint=fp)
        assert not changed.cached
        again = planner.plan_launches(
            "t.store", PIECES + [Piece(key=9, size=11)], fingerprint=fp)
        assert again.cached and again.signature == changed.signature

        # policy-knob change (tag) also invalidates
        tagged = planner.plan_launches(
            "t.store", PIECES + [Piece(key=9, size=11)], fingerprint=fp,
            policy_tag="elems=2")
        assert not tagged.cached
    finally:
        planner.set_plan_store(None)


def test_persistence_requires_fingerprint_and_enabled(tmp_path, monkeypatch):
    planner.set_plan_store(str(tmp_path))
    try:
        planner.plan_launches("t.nofp", PIECES)  # no fingerprint: no file
        assert planner.get_plan_store().n_plans() == 0
        monkeypatch.setenv("DELPHI_PLAN", "0")
        planner.plan_launches("t.nofp", PIECES, fingerprint="a" * 40)
        assert planner.get_plan_store().n_plans() == 0  # disabled: no file
    finally:
        planner.set_plan_store(None)


def test_plan_fingerprint_scope_and_table_fingerprint(tmp_path):
    planner.set_plan_store(str(tmp_path))
    try:
        fp = planner.table_plan_fingerprint("t", 64, ["a", "b"])
        assert fp == planner.table_plan_fingerprint("t", 64, ["a", "b"])
        assert fp != planner.table_plan_fingerprint("t", 65, ["a", "b"])
        assert planner.current_fingerprint() is None
        with planner.plan_fingerprint(fp):
            assert planner.current_fingerprint() == fp
            planner.plan_launches("t.scoped", PIECES)
        assert planner.current_fingerprint() is None
        assert planner.get_plan_store().load(fp, "t.scoped") is not None
    finally:
        planner.set_plan_store(None)


def test_stored_launch_shapes_aggregates_subphases(tmp_path):
    planner.set_plan_store(str(tmp_path))
    try:
        fp = "c" * 40
        planner.plan_launches("gbdt.cv[0]",
                              [Piece(key=0, size=1, shape=(6, 50))],
                              fingerprint=fp)
        planner.plan_launches("gbdt.cv[1]",
                              [Piece(key=0, size=1, shape=(6, 80))],
                              fingerprint=fp)
        planner.plan_launches("domain.scores",
                              [Piece(key=0, size=64)], fingerprint=fp)
        shapes = planner.stored_launch_shapes(fp, "gbdt.cv")
        assert {s[0] for s in shapes} == {(6, 50), (6, 80)}
        assert planner.stored_launch_shapes(fp, "gbdt") == []
        assert planner.stored_launch_shapes(None, "gbdt.cv") == []
    finally:
        planner.set_plan_store(None)


def test_round_chunks_matches_legacy_formula():
    for n, chunk in [(1, 50), (49, 50), (50, 50), (51, 50), (150, 50),
                     (0, 50), (199, 64)]:
        q, r = divmod(max(n, 1), chunk)
        assert planner.round_chunks(n, chunk) == [chunk] * q + (
            [r] if r else [])
        assert sum(planner.round_chunks(n, chunk)) == max(n, 1)


def test_cv_slab_widths_match_legacy_enumeration():
    for total in (1, 3, 16, 17, 40):
        for cap in (4, 16):
            for single in (True, False):
                widths = planner.plan_cv_slab_widths(total, cap, single)
                legacy = set()
                for lo in range(0, total, cap):
                    n = min(cap, total - lo)
                    legacy.add(n if single else planner.pow2_pad(n))
                assert widths == sorted(legacy)
    assert planner.plan_cv_slab_widths(0, 4, True) == []


def test_deprecated_env_knobs_warn_once_and_lose(monkeypatch):
    monkeypatch.setattr(planner, "_DEPRECATED_WARNED", set())
    monkeypatch.setenv("DELPHI_DOMAIN_CHUNK_CELLS", "123")
    with pytest.warns(DeprecationWarning, match="DELPHI_PLAN_CHUNK_CELLS"):
        assert planner.chunk_cells() == 123
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one-time: second read is silent
        assert planner.chunk_cells() == 123
    # the unified spelling wins over the deprecated one
    monkeypatch.setenv("DELPHI_PLAN_CHUNK_CELLS", "456")
    assert planner.chunk_cells() == 456

    monkeypatch.setattr(planner, "_DEPRECATED_WARNED", set())
    monkeypatch.setenv("DELPHI_CV_INSTANCE_CAP", "7")
    with pytest.warns(DeprecationWarning,
                      match="DELPHI_PLAN_CV_INSTANCE_CAP"):
        assert planner.cv_instance_cap() == 7
    monkeypatch.setenv("DELPHI_PLAN_CV_INSTANCE_CAP", "9")
    assert planner.cv_instance_cap() == 9


def test_pow2_helpers():
    assert [planner.pow2_pad(n) for n in (0, 1, 2, 3, 7, 8, 9)] \
        == [1, 1, 2, 4, 8, 8, 16]
    assert planner.pow2_pad(3, floor=16) == 16
    assert [planner.pow2_floor(n) for n in (1, 2, 3, 8, 9, 1023)] \
        == [1, 2, 2, 8, 8, 512]


def test_padded_extent_matches_pow2_pad():
    for n in (1, 5, 8, 100):
        assert planner.padded_extent("t.extent", n, floor=8) \
            == planner.pow2_pad(n, floor=8)


# -- the port against the JAX package -----------------------------------------

POLICIES = [
    {},
    {"chunk": 32},
    {"chunk": 32, "batch_cap": 3, "pad_batch": True},
    {"batch_cap": 2},
    {"pad_to_max": True},
    {"merge": True, "chunk": 16},
    {"size_floor": 16, "chunk": 50},
    {"batch_width": 4},
    {"merge": True, "batch_cap": 2, "pad_batch": True, "size_floor": 256,
     "chunk": 1000, "policy_tag": "elems=268435456"},
]


def _both(phase, pieces, **kw):
    j_pieces = [j_planner.Piece(key=p.key, size=p.size, shape=p.shape)
                for p in pieces]
    return (planner.plan_launches(phase, pieces, **kw),
            j_planner.plan_launches(phase, j_pieces, **kw))


@pytest.mark.parametrize("kw", POLICIES)
def test_payloads_and_signatures_equal_the_jax_packages(kw):
    """Exact equality: a plan is JSON data."""
    got, want = _both("t.parity", PIECES, **kw)
    assert got.signature == want.signature
    assert got.to_payload() == want.to_payload()
    assert (got.n_launches, got.n_buckets, got.padded_units,
            got.useful_units, got.merged_buckets) == \
        (want.n_launches, want.n_buckets, want.padded_units,
         want.useful_units, want.merged_buckets)


@pytest.mark.parametrize("plan_on", ["1", "0"])
def test_merge_knobs_change_both_packages_alike(plan_on, monkeypatch):
    monkeypatch.setenv("DELPHI_PLAN", plan_on)
    for factor in ("0", "2", "8"):
        monkeypatch.setenv("DELPHI_PLAN_MERGE", factor)
        got, want = _both("t.knobs", PIECES, merge=True, chunk=40)
        assert got.to_payload() == want.to_payload()


def test_memory_derived_cap_equal_across_packages():
    """A callable cap (the domain route's) is left out of the signature in
    both packages and groups alike."""
    def cap(shape, padded):
        return max(1, 256 // padded)
    got, want = _both("t.cap", PIECES, batch_cap=cap, pad_batch=True,
                      merge=True, size_floor=8)
    assert got.to_payload() == want.to_payload()


_shapes = st.sampled_from([(), ("a",), ("b", 4), (True, 2, 32, 8),
                           (False, 2, 32, 8)])
_pieces = st.lists(
    st.tuples(st.integers(0, 3000), _shapes), min_size=0, max_size=12)
_policy = st.fixed_dictionaries({}, optional={
    "size_floor": st.sampled_from([1, 8, 256]),
    "chunk": st.sampled_from([None, 7, 64, 1000]),
    "batch_cap": st.sampled_from([None, 1, 2, 5]),
    "pad_batch": st.booleans(),
    "pad_to_max": st.booleans(),
    "merge": st.booleans(),
    "policy_tag": st.sampled_from(["", "elems=8"]),
})


@settings(max_examples=150, deadline=None)
@given(raw=_pieces, kw=_policy)
def test_hypothesis_plans_equal_the_jax_packages(raw, kw):
    pieces = [Piece(key=i, size=s, shape=shape)
              for i, (s, shape) in enumerate(raw)]
    got, want = _both("t.hyp", pieces, **kw)
    assert got.signature == want.signature
    assert got.to_payload() == want.to_payload()


def test_record_counts_the_jax_packages_launch_family():
    """``record()`` counts what the JAX package's registry counts."""
    from delphi_tpu import observability as j_obs
    got, _ = _both("t.rec", PIECES, chunk=32, batch_cap=3, pad_batch=True,
                   merge=True)
    counters.clear()
    gauges.clear()
    got.record()
    got.record()  # idempotent per plan object
    rec = j_obs.start_recording("t")
    try:
        _, want = _both("t.rec", PIECES, chunk=32, batch_cap=3,
                        pad_batch=True, merge=True)
        want.record()
    finally:
        j_obs.stop_recording(rec)
    snap = rec.registry.snapshot()
    want_counters = {k: v for k, v in snap["counters"].items()
                     if k.startswith("launch.")}
    assert {k: v for k, v in counters.items()
            if k.startswith("launch.")} == want_counters
    want_gauges = {k: v for k, v in snap["gauges"].items()
                   if k.startswith("launch.")}
    assert {k: v for k, v in gauges.items()
            if k.startswith("launch.")} == want_gauges


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_plan_stores_load_across_packages(writer, tmp_path):
    """A plan store written by either package is a cache hit for the
    other: same file name, envelope, schema and payload."""
    fp = planner.table_plan_fingerprint("t", 64, ["a", "b"])
    assert fp == j_planner.table_plan_fingerprint("t", 64, ["a", "b"])
    w, r = (planner, j_planner) if writer == "port" else (j_planner, planner)
    kw = dict(chunk=32, batch_cap=3, pad_batch=True, merge=True)
    w.set_plan_store(str(tmp_path))
    try:
        cold = w.plan_launches(
            "gbdt.cv[0]", [w.Piece(key=p.key, size=p.size, shape=p.shape)
                           for p in PIECES], fingerprint=fp, **kw)
    finally:
        w.set_plan_store(None)
    assert not cold.cached
    r.set_plan_store(str(tmp_path))
    try:
        warm = r.plan_launches(
            "gbdt.cv[0]", [r.Piece(key=p.key, size=p.size, shape=p.shape)
                           for p in PIECES], fingerprint=fp, **kw)
        shapes = r.stored_launch_shapes(fp, "gbdt.cv")
    finally:
        r.set_plan_store(None)
    assert warm.cached
    assert warm.to_payload() == cold.to_payload()
    assert shapes == [(tuple(l.shape), l.padded_size, l.batch_pad)
                      for l in cold.launches]


def test_cost_veto_raises_naming_item_10(monkeypatch):
    """DELPHI_PLAN_COST needs the launch-cost ledger (item 10): a merging
    plan raises instead of silently ignoring it; other plans are
    unaffected."""
    monkeypatch.setenv("DELPHI_PLAN_COST", "1")
    planner.plan_launches("t.cost", PIECES)
    with pytest.raises(NotImplementedError, match="item 10"):
        planner.plan_launches("t.cost", PIECES, merge=True)


def test_launch_scope_is_a_null_context():
    plan = planner.plan_launches("t.scope", PIECES)
    with plan.launch_scope(plan.launches[0]) as x:
        assert x is None
