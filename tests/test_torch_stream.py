"""The port's streaming plane (``delphi_tpu_torch/incremental/stream.py``):
the cases of ``tests/test_stream.py`` on the port's ``StreamSession`` and
``StreamManager``: the durable generational cursor, restart recovery past
a corrupt generation, idempotent re-apply, backpressure, torn cursor
writes through the store's live fault sites, and the drift-gated
background retrain, whose steps wait on events (never on sleeps) and
whose post-swap frame equals a cold batch run of the port and of the JAX
package. Every case runs under its own time limit (``_time_limit``).
"""

import os
import signal
import threading

import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu_torch.incremental.stream import (
    StreamBusy, StreamCommitError, StreamManager, StreamSession,
    load_durable_cursor, validate_stream_id,
)
from delphi_tpu_torch.parallel import resilience as t_rz
from delphi_tpu_torch.session import get_session as t_session
from delphi_tpu_torch.utils import counters, gauges

_ENV_VARS = (
    "DELPHI_FAULT_PLAN", "DELPHI_STREAM_MAX_INFLIGHT", "DELPHI_STREAM_KEEP",
    "DELPHI_STREAM_DRIFT_MAX", "DELPHI_INCREMENTAL", "DELPHI_SNAPSHOT_DIR",
    "DELPHI_PROVENANCE_PATH", "DELPHI_SNAPSHOT_CHAIN_KEEP",
)

# seconds each case may take; the retrain case trains four times
_LIMIT_S = {"test_drift_gated_retrain_swaps_once_and_never_blocks": 240}


class _TimeLimit(Exception):
    pass


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Fails the case (instead of hanging the run) past its limit."""
    def expire(signum, frame):
        raise _TimeLimit(f"{request.node.name} ran past its time limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(_LIMIT_S.get(request.node.originalname, 60))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _clean_stream_state(monkeypatch):
    for v in _ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t_rz.reset_fault_state()
    yield
    t_rz.reset_fault_state()
    torch.set_num_threads(threads)
    T.set_device(None)


def _chunk(start: int, count: int, groups, null_every: int = 0
           ) -> pd.DataFrame:
    """One delta partition. ``c1`` is a pure function of the group
    (``v{gid % 7}``) so any model trained on a prefix that covers every
    group with a clean example learns the same mapping as a full-table
    model."""
    groups = list(groups)
    rows = []
    for k in range(count):
        i, gid = start + k, groups[k % len(groups)]
        null_c1 = bool(null_every) and k % null_every == 0
        rows.append({"tid": str(i), "c0": f"g{gid}",
                     "c1": None if null_c1 else f"v{gid % 7}",
                     "c2": str((i * 7) % 5), "c3": f"w{gid % 5}"})
    return pd.DataFrame(rows)


def _echo_run(accumulated, snap_dir, seq):
    """Protocol-level stand-in for the repair: the frame is the
    accumulated table itself, the snapshot id deterministic per seq."""
    return accumulated.copy(), {"snapshot_id": f"snap-{seq:04d}"}


# -- the durable cursor chain -------------------------------------------------

def test_chain_commits_cursor_and_prunes_generations(tmp_path):
    sess = StreamSession("s1", str(tmp_path / "s1"))
    assert sess.recovering is False
    parent = None
    for seq in (1, 2, 3):
        st, body = sess.apply(
            seq, parent, _chunk((seq - 1) * 8, 8, range(8)), _echo_run)
        assert st == 200 and body["status"] == "ok"
        assert body["cursor"]["seq"] == seq
        assert body["cursor"]["rows_total"] == 8 * seq
        # the drift baselines are server-internal, never on the wire
        assert "baselines" not in body["cursor"]
        assert body["stream"]["id"] == "s1"
        parent = body["cursor"]["snapshot_id"]
    # default DELPHI_STREAM_KEEP=2: generation 1 pruned, 2 and 3 durable
    assert sess._generations() == [3, 2]
    cur = load_durable_cursor(str(tmp_path / "s1"))
    assert cur["seq"] == 3 and cur["snapshot_id"] == "snap-0003"
    assert len(sess.table) == 24


def test_restart_resumes_at_durable_cursor_and_acks_duplicates(tmp_path):
    d = str(tmp_path / "s")
    c1, c2 = _chunk(0, 8, range(8)), _chunk(8, 8, range(8))
    first = StreamSession("s", d)
    assert first.apply(1, None, c1, _echo_run)[0] == 200
    assert first.apply(2, "snap-0001", c2, _echo_run)[0] == 200

    # a new process over the same directory (worker restart, or a fleet
    # survivor inheriting the chain through the shared cache root)
    counters.clear()
    again = StreamSession("s", d)
    assert counters.get("stream.recoveries") == 1
    assert again.recovering is True
    assert again.cursor["seq"] == 2
    pd.testing.assert_frame_equal(
        again.table, pd.concat([c1, c2], ignore_index=True))

    # at-least-once re-send of the head delta acks as a duplicate with
    # the cursor echoed, and the first post-recovery ack ends recovery
    st, body = again.apply(2, "snap-0001", c2, _echo_run)
    assert (st, body["status"]) == (200, "duplicate")
    assert body["cursor"]["seq"] == 2
    assert again.recovering is False
    # so does any older committed seq
    st, body = again.apply(1, None, c1, _echo_run)
    assert (st, body["status"]) == (200, "duplicate")
    # and the chain continues from the rebuilt state
    st, body = again.apply(3, "snap-0002", _chunk(16, 8, range(8)),
                           _echo_run)
    assert st == 200 and body["cursor"]["rows_total"] == 24


def test_conflict_gap_and_parent_mismatch_echo_the_cursor(tmp_path):
    sess = StreamSession("s", str(tmp_path / "s"))
    # a parent claim against a stream with no durable cursor: the client
    # is talking to the wrong (or wiped) stream — restart from scratch
    st, body = sess.apply(1, "snap-9999", _chunk(0, 8, range(8)),
                          _echo_run)
    assert (st, body["status"]) == (409, "parent_mismatch")
    assert body["cursor"] is None

    assert sess.apply(1, None, _chunk(0, 8, range(8)), _echo_run)[0] == 200

    # same seq, different content: at-least-once replay must never
    # silently overwrite a committed delta
    st, body = sess.apply(1, None, _chunk(0, 8, range(8), null_every=3),
                          _echo_run)
    assert (st, body["status"]) == (409, "conflict")
    assert body["cursor"]["seq"] == 1

    st, body = sess.apply(3, "snap-0001", _chunk(8, 8, range(8)),
                          _echo_run)
    assert (st, body["status"]) == (409, "gap")
    assert "expected seq 2" in body["error"]
    assert body["cursor"]["seq"] == 1

    st, body = sess.apply(2, "snap-bogus", _chunk(8, 8, range(8)),
                          _echo_run)
    assert (st, body["status"]) == (409, "parent_mismatch")
    assert body["cursor"]["seq"] == 1

    for bad in (0, -3, "x", None):
        st, body = sess.apply(bad, None, _chunk(8, 8, range(8)), _echo_run)
        assert (st, body["status"]) == (400, "bad_request")


def test_recovery_steps_past_a_corrupt_generation(tmp_path, monkeypatch):
    monkeypatch.setenv("DELPHI_STREAM_KEEP", "4")
    d = str(tmp_path / "s")
    sess = StreamSession("s", d)
    chunks = [_chunk(i * 8, 8, range(8)) for i in range(3)]
    for seq, c in enumerate(chunks, start=1):
        assert sess.apply(seq, None, c, _echo_run)[0] == 200
    # tear the NEWEST cursor generation in place (what a crash mid-write
    # leaves): recovery must step back to the newest VALID generation
    cpath = sess._cursor_path(3)
    with open(cpath, "r+b") as f:
        f.truncate(max(1, os.path.getsize(cpath) // 2))

    again = StreamSession("s", d)
    assert again.recovering is True
    assert again.cursor["seq"] == 2
    assert len(again.table) == 16
    # the client resends from the echoed cursor: the re-applied delta 3
    # commits a fresh valid generation 3 and ends recovery
    st, body = again.apply(3, "snap-0002", chunks[2], _echo_run)
    assert st == 200 and body["status"] == "ok"
    assert again.recovering is False
    assert load_durable_cursor(d)["seq"] == 3


# -- torn commit writes -------------------------------------------------------

def test_torn_cursor_write_detected_before_ack_and_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("DELPHI_FAULT_PLAN",
                       "store.stream_cursor:1:torn_write")
    t_rz.reset_fault_state()
    sess = StreamSession("s", str(tmp_path / "s"))
    counters.clear()
    st, body = sess.apply(1, None, _chunk(0, 8, range(8)), _echo_run)
    # the read-back converted the believed-success torn write into a
    # detected failure and the retry committed — the ack is real
    assert st == 200 and body["status"] == "ok"
    assert counters.get("stream.commit_retries", 0) >= 1
    assert load_durable_cursor(str(tmp_path / "s"))["seq"] == 1


def test_unverifiable_commit_refuses_the_ack(tmp_path, monkeypatch):
    monkeypatch.setenv("DELPHI_FAULT_PLAN",
                       "store.stream_cursor:1:torn_write,"
                       "store.stream_cursor:2:torn_write")
    t_rz.reset_fault_state()
    sess = StreamSession("s", str(tmp_path / "s"))
    with pytest.raises(StreamCommitError):
        sess.apply(1, None, _chunk(0, 8, range(8)), _echo_run)
    # NOT acknowledged: no durable cursor exists for a client to trust
    assert load_durable_cursor(str(tmp_path / "s")) is None
    # after the store heals, the client's resend of the SAME seq commits
    monkeypatch.delenv("DELPHI_FAULT_PLAN")
    t_rz.reset_fault_state()
    st, body = sess.apply(1, None, _chunk(0, 8, range(8)), _echo_run)
    assert st == 200 and body["status"] == "ok"
    assert load_durable_cursor(str(tmp_path / "s"))["seq"] == 1


# -- admission backpressure ---------------------------------------------------

def test_manager_backpressure_bounds_inflight_and_reports_lag(tmp_path, monkeypatch):
    monkeypatch.setenv("DELPHI_STREAM_MAX_INFLIGHT", "1")
    mgr = StreamManager(str(tmp_path))
    counters.clear()
    sess = mgr.admit("s", rows=10)
    assert mgr.lag_rows() == 10
    with pytest.raises(StreamBusy) as ei:
        mgr.admit("s", rows=5)
    assert ei.value.stream_id == "s"
    assert ei.value.cursor is None  # nothing durable yet to point at
    assert ei.value.retry_after_s > 0
    assert counters.get("stream.backpressure_429") == 1
    # the refusal admitted nothing: lag is still only the in-flight rows
    assert mgr.lag_rows() == 10
    assert gauges.get("stream.lag_rows") == 10

    mgr.release("s", 10)
    assert mgr.lag_rows() == 0 and sess.pending == 0
    # the freed slot re-admits the SAME session object
    assert mgr.admit("s", rows=3) is sess

    # once a cursor is durable, the 429 carries the exact resume point
    assert sess.apply(1, None, _chunk(0, 8, range(8)), _echo_run)[0] == 200
    with pytest.raises(StreamBusy) as ei:
        mgr.admit("s", rows=7)
    assert ei.value.cursor["seq"] == 1


def test_stream_id_validation_rejects_path_escapes():
    for bad in ("", ".", "..", "../x", "a/b", ".hidden", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            validate_stream_id(bad)
    assert validate_stream_id("chain-1.a_B") == "chain-1.a_B"


# -- drift-gated background retrain -------------------------------------------

def _canonical(out):
    return out.sort_values(list(out.columns)).reset_index(drop=True)


def _repair_run_fn(tag):
    """A per-delta run_fn: incremental repair against the per-stream
    snapshot, canonical ordering."""
    def run_fn(accumulated, snap_dir, seq):
        name = t_session().register(f"stream_test_{tag}_{seq}",
                                    accumulated.copy())
        try:
            os.makedirs(snap_dir, exist_ok=True)
            model = T.delphi.repair.setTableName(name).setRowId("tid") \
                .setErrorDetectors([T.NullErrorDetector()]) \
                .option("repair.incremental", "true") \
                .option("repair.snapshot.dir", snap_dir)
            return _canonical(model.run()), model._last_incremental
        finally:
            t_session().drop(name)

    return run_fn


def _batch_repair(lib, frame):
    model = lib.delphi.repair.setInput(frame.copy()).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()])
    return model, _canonical(model.run())


def test_drift_gated_retrain_swaps_once_and_never_blocks(tmp_path,
                                                         monkeypatch):
    """Deltas 1-2 hold the training-time distribution (no trigger); delta
    3 brings eight new categories, so the retrain starts off-thread; delta
    4 commits while the retrain is parked on an event, without a second
    trigger; the swap lands once (the test waits on the swap's event); the
    post-swap delta repairs equal to a cold batch run of the port and of
    the JAX package over the whole concatenation."""
    monkeypatch.setenv("DELPHI_STREAM_DRIFT_MAX", "0.6")
    run_fn = _repair_run_fn("drift")
    sess = StreamSession("drift", str(tmp_path / "drift"))

    gate, started, swapped = (threading.Event(), threading.Event(),
                              threading.Event())
    retrain_rows = []
    swap = sess._swap_models

    def swap_and_signal(models, hists):
        swap(models, hists)
        swapped.set()

    monkeypatch.setattr(sess, "_swap_models", swap_and_signal)

    def retrain_fn(accumulated):
        retrain_rows.append(len(accumulated))
        started.set()
        assert gate.wait(timeout=120), "test gate never opened"
        model, _ = _batch_repair(T, accumulated)
        return dict(model._last_models or [])

    chunks = [
        _chunk(0, 16, range(8), null_every=5),
        _chunk(16, 16, range(8), null_every=7),
        _chunk(32, 16, range(8, 16)),   # the drift: 8 new categories
        _chunk(48, 16, range(8, 16)),
        _chunk(64, 16, range(8, 16), null_every=5),
    ]
    counters.clear()
    parent = None
    try:
        for seq in (1, 2):
            st, body = sess.apply(seq, parent, chunks[seq - 1], run_fn,
                                  retrain_fn=retrain_fn)
            assert st == 200
            parent = body["cursor"]["snapshot_id"]
        assert retrain_rows == [] and not started.is_set()

        st, body = sess.apply(3, parent, chunks[2], run_fn,
                              retrain_fn=retrain_fn)
        assert st == 200
        parent = body["cursor"]["snapshot_id"]
        assert started.wait(timeout=60)
        assert sess._retrain_pending is True

        st, body = sess.apply(4, parent, chunks[3], run_fn,
                              retrain_fn=retrain_fn)
        assert st == 200
        parent = body["cursor"]["snapshot_id"]
        assert sess._retrain_pending is True and not swapped.is_set()

        gate.set()
        assert swapped.wait(timeout=120), "the retrain never swapped"
        sess.retrain_join(timeout_s=120)
    finally:
        gate.set()
    assert retrain_rows == [48]  # the seq-3 accumulation, exactly once
    assert counters.get("stream.retrain.triggers") == 1
    assert counters.get("stream.retrain.swaps") == 1
    assert counters.get("stream.retrain.failed", 0) == 0
    assert sess._retrain_pending is False

    st, body = sess.apply(5, parent, chunks[4], run_fn)
    assert st == 200 and body["status"] == "ok"
    _, cold = _batch_repair(T, sess.table)
    _, jax_cold = _batch_repair(J, sess.table)
    pd.testing.assert_frame_equal(body["frame_df"], cold)
    pd.testing.assert_frame_equal(cold, jax_cold)
