"""The port's sustained-load harness
(``delphi_tpu_torch/observability/load.py``) on the CPU:

* the cases of ``tests/test_load.py`` that ``tests/test_torch_fleet.py``
  does not hold (the autoscaler's are there), in-process with fake clocks
  and scripted post functions: the deterministic schedule and its
  segment program, zipf popularity and kind mix, payloads per kind, the
  bounded retry ladder and its backoff, the open-loop property, lane
  ordering, the slo ledger and ``drift.evaluate_slo``;
* parity with the JAX package's ``delphi_tpu/observability/load.py``:
  ``make_tables``, ``build_schedule``, ``build_payload``, ``backoff_s``,
  ``parse_mix``, ``zipf_weights``, ``default_segments``, ``load_knobs``
  and ``slo_section`` equal on the same seeds and records;
* one short open-loop run against a two-worker fleet of port workers on
  the CPU (``chip_smoke.load_run``, the load run of phase 4u), one original
  worker killed at the ``post_kill`` boundary: every arrival is accounted
  for, ``sent == answered + shed + gave_up``.
"""

import json
import os
import threading
import time

import pytest
import torch

import chip_smoke
import delphi_tpu_torch as T
from delphi_tpu.observability import load as j_load
from delphi_tpu_torch import observability as obs
from delphi_tpu_torch.observability import drift
from delphi_tpu_torch.observability import load as loadgen


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    obs.stop_recording(obs.current_recorder())
    torch.set_num_threads(threads)
    T.set_device(None)


# -- workload synthesis -------------------------------------------------------

def test_parse_mix_normalizes_and_rejects_unknown_kinds():
    mix = loadgen.parse_mix("batch=3,incremental=1")
    assert mix == {"batch": 0.75, "incremental": 0.25, "stream": 0.0}
    assert loadgen.parse_mix("batch=0,stream=0") \
        == {"batch": 1.0, "incremental": 0.0, "stream": 0.0}
    with pytest.raises(ValueError, match="unknown load mix kind"):
        loadgen.parse_mix("batch=1,bogus=1")


def test_zipf_weights_are_monotone_hot_head():
    w = loadgen.zipf_weights(50, 1.1)
    assert w[0] == 1.0
    assert all(a > b for a, b in zip(w, w[1:]))
    # alpha=0 degrades to uniform: no popularity skew
    assert set(loadgen.zipf_weights(5, 0.0)) == {1.0}


def test_make_tables_deterministic_and_distinct():
    a = loadgen.make_tables(6, rows=8, seed=3)
    b = loadgen.make_tables(6, rows=8, seed=3)
    assert a == b  # byte-identical replay per (n, rows, seed)
    fingerprints = {str(t["table"]) for t in a}
    assert len(fingerprints) == 6


def test_build_schedule_is_deterministic_per_seed():
    segments = loadgen.default_segments(200, rate_rps=10.0, spike_x=3.0)
    mix = loadgen.parse_mix("batch=0.6,incremental=0.2,stream=0.2")
    s1 = loadgen.build_schedule(segments, 40, 1.1, mix, seed=7)
    s2 = loadgen.build_schedule(segments, 40, 1.1, mix, seed=7)
    s3 = loadgen.build_schedule(segments, 40, 1.1, mix, seed=8)
    assert s1 == s2
    assert s1 != s3
    # segment program: every arrival lands inside its segment window,
    # arrival times are monotone, all kinds and many fingerprints appear
    assert [a.at_s for a in s1] == sorted(a.at_s for a in s1)
    assert {a.segment for a in s1} \
        == {"warmup", "steady", "spike", "post_kill"}
    assert {a.kind for a in s1} == {"batch", "incremental", "stream"}
    assert len({a.fp_index for a in s1}) >= 10
    # zipf: rank-0 must be the modal fingerprint
    counts = {}
    for a in s1:
        counts[a.fp_index] = counts.get(a.fp_index, 0) + 1
    assert max(counts, key=counts.get) == 0
    # chained kinds carry per-lane 1-based seq with no gaps
    lanes = {}
    for a in s1:
        if a.lane is not None:
            lanes.setdefault(a.lane, []).append(a.seq)
    assert lanes and all(v == list(range(1, len(v) + 1))
                         for v in lanes.values())


def test_build_payload_shapes_per_kind():
    tables = loadgen.make_tables(2, rows=8, seed=0)
    batch = loadgen.Arrival(0, 0.1, "steady", "batch", 0)
    inc = loadgen.Arrival(1, 0.2, "steady", "incremental", 1, "i1", 2)
    stream = loadgen.Arrival(2, 0.3, "steady", "stream", 0, "s0", 1)
    b = loadgen.build_payload(batch, tables)
    assert b["table"] == tables[0]["table"] and "stream" not in b
    i = loadgen.build_payload(inc, tables)
    assert i["base_snapshot"] == "load-i1"
    s = loadgen.build_payload(stream, tables)
    assert s["stream"] == {"id": "load-s0", "seq": 1}
    row_id = tables[0]["row_id"]
    assert len(s["table"][row_id]) < len(tables[0]["table"][row_id])


# -- retry discipline ---------------------------------------------------------

def test_backoff_is_deterministic_jittered_and_capped():
    d1 = loadgen.backoff_s("load-5", 1, retry_after_s=2.0)
    assert d1 == loadgen.backoff_s("load-5", 1, retry_after_s=2.0)
    assert 1.0 <= d1 <= 2.0  # jitter into [0.5x, 1.0x] of the base
    # attempt 2 doubles the base but the cap bounds it
    assert loadgen.backoff_s("load-5", 2, retry_after_s=4.0, cap_s=5.0) \
        <= 5.0
    # different request ids de-synchronize their retries
    assert loadgen.backoff_s("load-6", 1, retry_after_s=2.0) != d1


class _Clock:
    """A fake monotonic clock advanced only by sleeps."""

    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()

    def now(self):
        with self._lock:
            return self.t

    def sleep(self, d):
        with self._lock:
            self.t += max(0.0, d)


def _segments_one(n=10, rate=100.0):
    return [loadgen.Segment("steady", n / rate, rate)]


def _tables_one():
    return [{"index": 0, "scenario": "s", "row_id": "tid",
             "table": {"tid": ["1", "2", "3", "4"],
                       "c0": ["a", "b", "c", "d"]}}]


def test_retry_honors_retry_after_then_succeeds():
    clock = _Clock()
    sleeps = []

    def sleep_spy(d):
        sleeps.append(round(d, 6))
        clock.sleep(d)

    attempts = []

    def post(payload):
        attempts.append(payload["request_id"])
        if len(attempts) < 3:
            return 429, {"status": "rejected"}, {"Retry-After": "2"}
        return 200, {"status": "ok", "worker_id": "0"}, {}

    schedule = [loadgen.Arrival(0, 0.0, "steady", "batch", 0)]
    rec = obs.start_recording("test.load.retry")
    try:
        runner = loadgen.OpenLoopRunner(
            schedule, _tables_one(), post, retry_max=2,
            now_fn=clock.now, sleep_fn=sleep_spy)
        records = runner.run(join_timeout_s=30)
        counters = rec.registry.snapshot()["counters"]
    finally:
        obs.stop_recording(rec)
    assert [r.outcome for r in records] == ["ok"]
    assert records[0].retries == 2
    assert records[0].worker == "0"
    assert counters.get("load.retries") == 2
    assert counters.get("load.answered") == 1
    # the two backoff sleeps are exactly the deterministic schedule:
    # Retry-After=2 doubled per attempt, crc32-jittered per (rid, attempt)
    expected = [loadgen.backoff_s("load-0", 1, 2.0),
                loadgen.backoff_s("load-0", 2, 2.0)]
    assert [s for s in sleeps if s in expected] == expected


def test_exhausted_retries_and_dead_connections_are_explicit():
    """Nothing is silently dropped: a forever-shedding server ends in
    ``shed``, a dead connection in ``gave_up``, and the totals satisfy
    sent == answered + shed + gave_up."""
    clock = _Clock()

    def post(payload):
        idx = int(payload["request_id"].rsplit("-", 1)[1])
        if idx == 0:
            return 429, {"status": "rejected"}, {"Retry-After": "0"}
        if idx == 1:
            return None, {}, {}  # connection-level failure
        return 200, {"status": "ok"}, {}

    schedule = [loadgen.Arrival(i, i * 0.01, "steady", "batch", 0)
                for i in range(3)]
    rec = obs.start_recording("test.load.outcomes")
    try:
        runner = loadgen.OpenLoopRunner(
            schedule, _tables_one(), post, retry_max=1,
            now_fn=clock.now, sleep_fn=clock.sleep)
        records = runner.run(join_timeout_s=30)
        counters = rec.registry.snapshot()["counters"]
    finally:
        obs.stop_recording(rec)
    outcomes = {r.index: r.outcome for r in records}
    assert outcomes == {0: "shed", 1: "gave_up", 2: "ok"}
    assert counters.get("load.shed") == 1
    assert counters.get("load.gave_up") == 1
    assert counters.get("load.requests") == 3
    slo = loadgen.slo_section(records, _segments_one(3), 1.0)
    r = slo["requests"]
    assert slo["consistent"] is True
    assert r["sent"] == r["answered"] + r["shed"] + r["gave_up"] == 3


# -- the open-loop property ---------------------------------------------------

def test_arrivals_fire_on_schedule_while_completions_are_blocked():
    """The defining open-loop property: every batch arrival dispatches at
    its scheduled time even though NO request has completed (they all
    block on a gate a closed-loop client would be stuck behind)."""
    clock = _Clock()
    release = threading.Event()

    def post(payload):
        release.wait(timeout=30)
        return 200, {"status": "ok"}, {}

    schedule = [loadgen.Arrival(i, round(0.5 * i, 6), "steady", "batch", 0)
                for i in range(6)]
    runner = loadgen.OpenLoopRunner(
        schedule, _tables_one(), post, retry_max=0,
        now_fn=clock.now, sleep_fn=clock.sleep)
    done = []
    t = threading.Thread(
        target=lambda: done.append(runner.run(join_timeout_s=30)),
        daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while len(runner.dispatched_at) < 6 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(runner.dispatched_at) == 6, "arrivals were held back"
    assert not runner.records, "nothing completed, yet all dispatched"
    release.set()
    t.join(timeout=30)
    assert done and len(done[0]) == 6
    # on the fake clock, dispatch time IS the scheduled time
    for a in schedule:
        assert runner.dispatched_at[a.index] == pytest.approx(a.at_s)


def test_chained_lane_serializes_seq_order():
    clock = _Clock()
    seen = []
    lock = threading.Lock()

    def post(payload):
        with lock:
            seen.append(payload["stream"]["seq"])
        return 200, {"status": "ok"}, {}

    schedule = [loadgen.Arrival(i, 0.0, "steady", "stream", 0, "s0", i + 1)
                for i in range(5)]
    runner = loadgen.OpenLoopRunner(
        schedule, _tables_one(), post, retry_max=0,
        now_fn=clock.now, sleep_fn=clock.sleep)
    runner.run(join_timeout_s=30)
    assert seen == [1, 2, 3, 4, 5]


def test_segment_probe_failures_never_stop_arrivals():
    clock = _Clock()
    fired = []

    def on_segment(name):
        fired.append(name)
        raise RuntimeError("probe exploded")

    schedule = [loadgen.Arrival(0, 0.0, "warmup", "batch", 0),
                loadgen.Arrival(1, 0.1, "steady", "batch", 0)]
    runner = loadgen.OpenLoopRunner(
        schedule, _tables_one(),
        lambda p: (200, {"status": "ok"}, {}), retry_max=0,
        now_fn=clock.now, sleep_fn=clock.sleep, on_segment=on_segment)
    records = runner.run(join_timeout_s=30)
    assert fired == ["warmup", "steady"]
    assert [r.outcome for r in records] == ["ok", "ok"]


# -- the slo ledger -----------------------------------------------------------

def _record(index, segment, outcome="ok", latency=0.05, worker="0",
            kind="batch", fp=0, retries=0):
    return loadgen.RequestRecord(
        request_id=f"load-{index}", index=index, segment=segment,
        kind=kind, fp_index=fp, scheduled_at_s=0.0, latency_s=latency,
        status=200 if outcome in ("ok",) else 429, outcome=outcome,
        worker=worker, retries=retries)


def test_slo_section_segments_recovery_and_accounting():
    segments = [loadgen.Segment("warmup", 1.0, 5.0),
                loadgen.Segment("steady", 4.0, 5.0),
                loadgen.Segment("spike", 1.0, 15.0),
                loadgen.Segment("post_kill", 2.0, 5.0)]
    records = (
        [_record(i, "warmup") for i in range(3)]
        + [_record(10 + i, "steady", latency=0.10, worker=str(i % 2))
           for i in range(10)]
        + [_record(30 + i, "spike", outcome="shed", worker=None)
           for i in range(4)]
        + [_record(50 + i, "post_kill", latency=0.50, kind="stream",
                   fp=i) for i in range(5)])
    seg_counters = {"steady": {"fleet.affinity.hits": 6,
                               "fleet.affinity.chain_hits": 2,
                               "fleet.affinity.misses": 2}}
    slo = loadgen.slo_section(
        records, segments, duration_s=8.0, segment_counters=seg_counters,
        autoscale_events=[{"action": "up", "worker": "2"}],
        kill={"worker": "1"}, recovery_fail_over=0.5)
    assert slo["consistent"] is True
    assert slo["requests"]["sent"] == 22
    assert slo["requests"]["shed"] == 4
    per = slo["per_segment"]
    assert set(per) == {"warmup", "steady", "spike", "post_kill"}
    assert sum(p["sent"] for p in per.values()) == slo["requests"]["sent"]
    assert per["spike"]["shed"] == 4 and per["spike"]["answered"] == 0
    assert per["steady"]["warm_hit_ratio"] == pytest.approx(0.8)
    assert per["steady"]["per_worker"]["0"]["requests"] == 5
    # the recovery gate reads post_kill, never the spike itself
    rec = slo["recovery"]
    assert "spike_ok" not in rec
    assert rec["post_kill_ok"] is False  # 0.50 vs steady 0.10 = 4x
    assert rec["violations"] == 1
    assert slo["mix"] == {"batch": 17, "stream": 5}
    assert slo["distinct_fingerprints"] == 5
    assert slo["autoscale"]["events"] == [{"action": "up", "worker": "2"}]
    assert slo["kill"] == {"worker": "1"}
    # within the fail-over, post_kill recovers
    ok = loadgen.slo_section(
        [_record(0, "steady", latency=0.10),
         _record(1, "post_kill", latency=0.12)],
        segments, 8.0, recovery_fail_over=0.5)
    assert ok["recovery"]["post_kill_ok"] is True
    assert ok["recovery"]["violations"] == 0


# -- the drift gate -----------------------------------------------------------

def _slo_fixture(p99=0.1, qps=50.0, shed=0.0):
    return {"requests": {"sent": 100}, "qps": qps, "shed_rate": shed,
            "latency": {"p99": p99},
            "per_segment": {"steady": {"qps": qps, "shed_rate": shed,
                                       "latency": {"p99": p99}}}}


def test_evaluate_slo_missing_baseline_never_fails():
    verdict = drift.evaluate_slo(_slo_fixture(), {"schema_version": 8},
                                 fail_over=0.0)
    assert verdict["baseline_missing"] is True
    assert verdict["failed"] is False


def test_evaluate_slo_degraded_current_trips_the_gate():
    base = {"slo": _slo_fixture(p99=0.1, qps=50.0)}
    bad = drift.evaluate_slo(_slo_fixture(p99=0.4, qps=20.0), base,
                             fail_over=0.2)
    assert bad["baseline_missing"] is False
    assert bad["failed"] is True
    assert bad["max_qps_drop"] == pytest.approx(0.6)
    # improvements never contribute to severity
    good = drift.evaluate_slo(_slo_fixture(p99=0.05, qps=80.0), base,
                              fail_over=0.2)
    assert good["failed"] is False
    assert good["max_severity"] == 0.0


# -- parity with the JAX package ----------------------------------------------

def _records(module, seed):
    """A deterministic spread of records over the four segments, every
    outcome, workers, kinds and fingerprints, as ``module`` builds them."""
    import random
    rng = random.Random(seed)
    out = []
    for i in range(120):
        segment = ("warmup", "steady", "spike", "post_kill")[i % 4]
        outcome = rng.choice(["ok", "ok", "ok", "failed", "shed", "gave_up"])
        out.append(module.RequestRecord(
            request_id=f"load-{i}", index=i, segment=segment,
            kind=rng.choice(["batch", "incremental", "stream"]),
            fp_index=rng.randrange(9), scheduled_at_s=i * 0.1,
            latency_s=round(rng.uniform(0.01, 2.0), 6),
            status={"ok": 200, "failed": 500, "shed": 429,
                    "gave_up": None}[outcome],
            outcome=outcome,
            worker=None if outcome in ("shed", "gave_up")
            else str(rng.randrange(3)),
            retries=rng.randrange(3)))
    return out


@pytest.mark.parametrize("seed", [0, 17])
def test_workload_and_schedule_equal_jax(seed):
    assert loadgen.make_tables(5, rows=16, seed=seed) == \
        j_load.make_tables(5, rows=16, seed=seed)
    assert loadgen.make_tables(3, rows=24, seed=seed,
                               scenarios=["fd_categorical"]) == \
        j_load.make_tables(3, rows=24, seed=seed,
                           scenarios=["fd_categorical"])
    for raw in ("batch=0.7,incremental=0.15,stream=0.15", "stream=2",
                "batch=0,incremental=0"):
        assert loadgen.parse_mix(raw) == j_load.parse_mix(raw)
    assert loadgen.zipf_weights(40, 1.1) == j_load.zipf_weights(40, 1.1)
    segs = loadgen.default_segments(300, 6.0, 5.0)
    j_segs = j_load.default_segments(300, 6.0, 5.0)
    assert [tuple(vars(s).values()) for s in segs] == \
        [tuple(vars(s).values()) for s in j_segs]
    mix = loadgen.parse_mix("batch=0.6,incremental=0.2,stream=0.2")
    got = loadgen.build_schedule(segs, 40, 1.1, mix, seed)
    want = j_load.build_schedule(j_segs, 40, 1.1, mix, seed)
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]
    tables = loadgen.make_tables(40, rows=12, seed=seed)
    j_tables = j_load.make_tables(40, rows=12, seed=seed)
    for a, ja in zip(got, want):
        assert loadgen.build_payload(a, tables) == \
            j_load.build_payload(ja, j_tables)


def test_backoff_and_retry_after_equal_jax():
    for rid in ("load-0", "load-5", "load-123"):
        for attempt in (1, 2, 3, 6):
            for after in (0.0, 0.5, 1.0, 4.0):
                for cap in (5.0, 1.5):
                    assert loadgen.backoff_s(rid, attempt, after, cap) == \
                        j_load.backoff_s(rid, attempt, after, cap)
    for headers in ({"Retry-After": "2"}, {"retry-after": "x"}, {}, None):
        assert loadgen._retry_after(headers) == j_load._retry_after(headers)


@pytest.mark.parametrize("seed", [0, 5])
def test_slo_section_equals_jax(seed):
    segments = loadgen.default_segments(120, 6.0, 3.0)
    j_segments = j_load.default_segments(120, 6.0, 3.0)
    seg_counters = {"steady": {"fleet.affinity.hits": 6,
                               "fleet.affinity.chain_hits": 2,
                               "fleet.affinity.misses": 2},
                    "spike": {"fleet.affinity.misses": 4}}
    for fail_over in (0.5, 50.0):
        got = loadgen.slo_section(
            _records(loadgen, seed), segments, 30.0,
            segment_counters=seg_counters,
            autoscale_events=[{"action": "up", "worker": "2"}],
            kill={"worker": "1", "at_segment": "post_kill"},
            recovery_fail_over=fail_over)
        want = j_load.slo_section(
            _records(j_load, seed), j_segments, 30.0,
            segment_counters=seg_counters,
            autoscale_events=[{"action": "up", "worker": "2"}],
            kill={"worker": "1", "at_segment": "post_kill"},
            recovery_fail_over=fail_over)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)


def test_load_knobs_read_env_and_conf_like_jax(monkeypatch):
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu_torch.session import get_session as t_session
    assert loadgen.load_knobs() == j_load.load_knobs()
    assert loadgen.LOAD_COUNTERS == j_load.LOAD_COUNTERS
    monkeypatch.setenv("DELPHI_LOAD_REQUESTS", "77")
    monkeypatch.setenv("DELPHI_LOAD_MIX", "batch=1,stream=1")
    monkeypatch.setenv("DELPHI_LOAD_BASELINE", "b.json")
    for session in (j_session(), t_session()):
        monkeypatch.setitem(session.conf, "repair.load.rate", "2.5")
        monkeypatch.setitem(session.conf, "repair.load.seed", "9")
    got = loadgen.load_knobs()
    assert got == j_load.load_knobs()
    assert (got["requests"], got["rate_rps"], got["seed"],
            got["baseline"]) == (77, 2.5, 9, "b.json")
    assert got["mix"] == {"batch": 0.5, "incremental": 0.0, "stream": 0.5}


# -- a real fleet of port workers ---------------------------------------------

def test_open_loop_run_against_a_cpu_fleet_accounts_for_every_arrival():
    """Phase 4u's load run on the CPU, at a tenth of its size: 16 arrivals
    over three ``fd_categorical`` fingerprints against two port workers,
    the original worker 1 killed when the ``post_kill`` segment starts.
    Every arrival ends in one outcome, and the segment program, the kill
    and the latencies land in the slo section."""
    shape = dict(chip_smoke.LOAD_SHAPE, requests=16, fingerprints=3,
                 autoscale=None)
    segments = loadgen.default_segments(shape["requests"], shape["rate_rps"],
                                        shape["spike_x"])
    schedule = loadgen.build_schedule(segments, shape["fingerprints"],
                                      shape["zipf_alpha"], shape["mix"],
                                      shape["seed"])
    assert {a.segment for a in schedule} >= {"steady", "post_kill"}
    slo, info, snapshot = chip_smoke.load_run(
        **shape, label="load_test",
        worker_env={**chip_smoke.LOAD_WORKER_ENV,
                    "DELPHI_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1"})
    acct = slo["requests"]
    assert acct["sent"] == info["arrivals"] == len(schedule)
    assert acct["sent"] == acct["answered"] + acct["shed"] + acct["gave_up"]
    assert slo["consistent"] is True
    assert acct["ok"] >= 1 and slo["latency"]["count"] >= 1
    assert slo["kill"] == {"worker": "1", "at_segment": "post_kill"}
    assert "1" not in info["workers_final"]
    counters = snapshot["counters"]
    assert counters["load.requests"] == acct["sent"]
    assert counters["load.answered"] == acct["answered"]
    checks = chip_smoke.load_checks(slo, info, snapshot)
    for name in ("slo_present", "accounting_consistent",
                 "all_segments_bucketed", "latency_measured",
                 "worker_attribution", "worker_killed",
                 "self_baseline_passes", "degraded_baseline_trips"):
        assert checks[name], (name, checks, slo)
