"""The port's serving plane (``delphi_tpu_torch/observability/serve.py``)
against the JAX package's on the CPU.

Every case of ``tests/test_serve.py`` runs against the port: admission
control (queue shedding, drain rejection, bad deadlines, the RSS limit,
the knobs), the HTTP surface (``/healthz``, ``/metrics`` with the
pre-seeded counter families), deadline expiry mapped to 504 with the
worker reclaimed, warm-cache reuse, graceful drain, the fleet membership
seam, the stream cursors on ``/drain`` and warm restarts that replan
nothing. Then the port's own cases:

* a served ``frame`` is byte-identical to the JAX package's ``run()`` on
  the same table, sorted by all columns and put through
  ``to_json(orient="records")`` (a 2,000-row ``missing_heavy`` table and
  ``bench._smoke_frame()``);
* two requests served side by side, one carrying a scoped fault plan: the
  clean frame is the solo frame bit for bit, the faulted request answers
  a structured error, and only its own warm state is evicted;
* a stream chained over HTTP ends on the frame of one batch run of the
  concatenation, in both packages.

Each test pins the port to the CPU and torch to one thread, and restores
the settings the server arms (``DELPHI_COMPILE_CACHE_DIR``).
"""

import json
import os
import shutil
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pandas as pd
import pytest
import torch

import bench
import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu_torch import observability as obs
from delphi_tpu_torch.observability import serve as serve_mod
from delphi_tpu_torch.observability.serve import (
    Rejection, RepairServer, table_fingerprint,
)
from delphi_tpu_torch.parallel import resilience as rz

_ENV_VARS = (
    "DELPHI_FAULT_PLAN", "DELPHI_SERVE_WORKERS", "DELPHI_SERVE_QUEUE_DEPTH",
    "DELPHI_SERVE_DEADLINE_S", "DELPHI_SERVE_MAX_RSS_GB",
    "DELPHI_SERVE_STALL_SHED_S", "DELPHI_SERVE_CACHE_DIR",
    "DELPHI_SERVE_PROVENANCE_DIR", "DELPHI_COMPILE_CACHE_DIR",
    "DELPHI_FLEET_DIR", "DELPHI_FLEET_WORKER_ID", "DELPHI_FLEET_HEARTBEAT_S",
    "DELPHI_STREAM_MAX_INFLIGHT", "DELPHI_SERVE_RETRY_AFTER_S",
    "DELPHI_SERVE_DRAIN_GRACE_S", "DELPHI_RETRY_BASE_S", "DELPHI_PLAN_DIR",
)


@pytest.fixture(autouse=True)
def _clean_serve_state():
    saved = {v: os.environ.get(v) for v in _ENV_VARS}
    for v in _ENV_VARS:
        os.environ.pop(v, None)
    # injected transient faults back off for a millisecond, not a second
    os.environ["DELPHI_RETRY_BASE_S"] = "0.001"
    rz.reset_fault_state()
    rz.clear_abort()
    rz.clear_cpu_fallback()
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    obs.stop_recording(obs.current_recorder())
    for v, old in saved.items():
        if old is None:
            os.environ.pop(v, None)
        else:
            os.environ[v] = old
    rz.reset_fault_state()
    rz.clear_abort()
    rz.clear_cpu_fallback()
    torch.set_num_threads(threads)
    T.set_device(None)


def _payload(**overrides):
    """A tiny repairable table (nulls in c1 for the NullErrorDetector)."""
    n = 24
    table = {
        "tid": [str(i) for i in range(n)],
        "c0": ["a" if i % 2 else "b" for i in range(n)],
        "c1": [None if i % 11 == 0 else str(i % 4) for i in range(n)],
        "c2": [str((i * 7) % 5) for i in range(n)],
    }
    payload = {"table": table, "row_id": "tid"}
    payload.update(overrides)
    return payload


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, resp.read().decode()


def _post(port, path, body, timeout=240):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), e.headers


def _metric(metrics: str, name: str) -> float:
    for line in metrics.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not on /metrics")


# -- admission control (no started server needed) -----------------------------

def test_full_queue_sheds_with_retry_after():
    srv = RepairServer(workers=1, queue_depth=1)
    srv.submit(_payload())  # fills the only slot (no worker is draining it)
    with pytest.raises(Rejection) as ei:
        srv.submit(_payload())
    assert ei.value.status == 429
    assert ei.value.retry_after_s is not None
    assert "queue full" in ei.value.reason


def test_draining_server_rejects_503():
    srv = RepairServer(workers=1, queue_depth=4)
    srv.begin_drain()
    with pytest.raises(Rejection) as ei:
        srv.submit(_payload())
    assert ei.value.status == 503
    assert "draining" in ei.value.reason


def test_bad_deadline_rejects_400():
    srv = RepairServer(workers=1, queue_depth=4)
    with pytest.raises(Rejection) as ei:
        srv.submit(_payload(deadline_s="soon"))
    assert ei.value.status == 400


def test_rss_admission_limit_sheds():
    # any live process exceeds a 1-byte RSS budget
    os.environ["DELPHI_SERVE_MAX_RSS_GB"] = "0.000000001"
    srv = RepairServer(workers=1, queue_depth=4)
    with pytest.raises(Rejection) as ei:
        srv.submit(_payload())
    assert ei.value.status == 429
    assert "RSS" in ei.value.reason


def test_admission_knobs_read_env():
    """Every setting the server reads, from the environment, and from the
    session's ``repair.serve.*`` / ``repair.fleet.*`` conf when the
    environment is silent; both packages read the same values."""
    from delphi_tpu.observability.serve import RepairServer as JServer
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu_torch.session import get_session as t_session

    env = {"DELPHI_SERVE_WORKERS": "3", "DELPHI_SERVE_QUEUE_DEPTH": "17",
           "DELPHI_SERVE_DEADLINE_S": "12.5",
           "DELPHI_SERVE_RETRY_AFTER_S": "2.5",
           "DELPHI_SERVE_DRAIN_GRACE_S": "4.0",
           "DELPHI_SERVE_MAX_RSS_GB": "7.0",
           "DELPHI_SERVE_STALL_SHED_S": "9.0",
           "DELPHI_SERVE_CACHE_DIR": "/nonexistent/serve-cache",
           "DELPHI_FLEET_DIR": "/nonexistent/fleet",
           "DELPHI_FLEET_WORKER_ID": "5",
           "DELPHI_FLEET_HEARTBEAT_S": "0.25"}
    fields = ("workers", "queue_depth", "default_deadline_s",
              "retry_after_s", "drain_grace_s", "max_rss_gb",
              "stall_shed_s", "cache_dir", "fleet_dir", "worker_id",
              "fleet_heartbeat_s")
    os.environ.update(env)
    srv = RepairServer()
    assert srv.workers == 3
    assert srv.queue_depth == 17
    assert srv.default_deadline_s == 12.5
    got = [getattr(srv, f) for f in fields]
    assert got == [3, 17, 12.5, 2.5, 4.0, 7.0, 9.0, "/nonexistent/serve-cache",
                   "/nonexistent/fleet", "5", 0.25]
    assert got == [getattr(JServer(), f) for f in fields]
    for key in env:
        os.environ.pop(key)

    conf = {"repair.serve.workers": "4", "repair.serve.queue_depth": "6",
            "repair.serve.deadline_s": "8.5",
            "repair.serve.retry_after_s": "3.5",
            "repair.serve.drain_grace_s": "1.5",
            "repair.serve.max_rss_gb": "2.0",
            "repair.serve.stall_shed_s": "11.0",
            "repair.serve.cache_dir": "/nonexistent/conf-cache",
            "repair.fleet.heartbeat_s": "0.75"}
    sessions = (t_session(), j_session())
    for session in sessions:
        session.conf.update(conf)
    try:
        got = [getattr(RepairServer(), f) for f in fields]
        want = [getattr(JServer(), f) for f in fields]
    finally:
        for session in sessions:
            for key in conf:
                session.conf.pop(key, None)
    assert got == [4, 6, 8.5, 3.5, 1.5, 2.0, 11.0, "/nonexistent/conf-cache",
                   None, None, 0.75]
    assert got == want


# -- the live service ---------------------------------------------------------

def test_service_lifecycle_deadlines_warm_cache_and_drain():
    """One server, end to end: /metrics pre-seeds the serve.* and
    resilience.* counter families; a request with a tiny deadline maps to
    504 (DeadlineExceeded mid-phase or in-queue) and the worker is
    reclaimed; the next request on the same table succeeds and warms the
    fingerprint cache; drain stops admission and the server winds down."""
    cache_dir = tempfile.mkdtemp(prefix="delphi_serve_test_")
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        port = srv.port
        status, body = _get(port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["workers"] == 1

        # pre-seeded counter families: visible at zero before any request
        status, metrics = _get(port, "/metrics")
        assert status == 200
        for name in ("delphi_serve_requests", "delphi_serve_shed",
                     "delphi_serve_deadline_expired",
                     "delphi_resilience_retries",
                     "delphi_resilience_checkpoint_corrupt",
                     "delphi_resilience_plan_unmatched",
                     "delphi_resilience_degrade_cpu_refused",
                     "delphi_escalation_routed",
                     "delphi_escalation_escalated",
                     "delphi_escalation_joint_launches",
                     "delphi_escalation_adapter_calls",
                     "delphi_gauntlet_scenarios",
                     "delphi_gauntlet_cells_injected",
                     "delphi_gauntlet_repairs_correct",
                     "delphi_gauntlet_mean_f1",
                     "delphi_trace_traces", "delphi_trace_joins",
                     "delphi_trace_spans", "delphi_trace_exports",
                     "delphi_launch_ledger_records",
                     "delphi_launch_ledger_flushes",
                     "delphi_launch_ledger_loads",
                     "delphi_launch_ledger_consults",
                     "delphi_launch_ledger_merge_vetoes",
                     "delphi_load_requests", "delphi_load_answered",
                     "delphi_load_ok", "delphi_load_failed",
                     "delphi_load_shed", "delphi_load_gave_up",
                     "delphi_load_retries", "delphi_slo_segments",
                     "delphi_slo_recovery_violations",
                     "delphi_autoscale_ticks", "delphi_autoscale_up",
                     "delphi_autoscale_down",
                     "delphi_autoscale_blocked_cooldown",
                     "delphi_autoscale_blocked_hysteresis",
                     "delphi_autoscale_blocked_limit"):
            assert name in metrics, f"{name} not pre-seeded on /metrics"

        # deadline expiry -> 504, structured status, worker reclaimed
        status, resp, _ = _post(
            port, "/repair", _payload(deadline_s=0.05, request_id="late"))
        assert status == 504
        assert resp["status"] == "deadline_exceeded"
        assert resp["request_id"] == "late"

        # the reclaimed worker serves the next request on the same table
        status, resp, _ = _post(port, "/repair", _payload(request_id="ok1"))
        assert status == 200 and resp["status"] == "ok"
        assert resp["rows"] > 0
        frame1 = resp["frame"]

        # warm path: same fingerprint -> table cache hit, identical frame
        status, resp, _ = _post(port, "/repair", _payload(request_id="ok2"))
        assert status == 200 and resp["frame"] == frame1

        status, metrics = _get(port, "/metrics")
        # ok2 is always a fingerprint-cache hit; ok1 is too when the "late"
        # request got far enough to resolve the table before expiring
        assert _metric(metrics, "delphi_serve_table_cache_hits") >= 1
        assert "delphi_serve_deadline_expired 1" in metrics

        # drain: admission closes with Retry-After, in-flight (none) drains
        status, resp, headers = _post(port, "/drain", {})
        assert status == 200
        # admission closes AFTER the drain response is written (the
        # cursors-first ordering contract) — wait for that handoff to land
        deadline = time.monotonic() + 5
        while not srv._draining and time.monotonic() < deadline:
            time.sleep(0.01)
        status, resp, headers = _post(port, "/repair", _payload())
        assert status == 503
        assert headers.get("Retry-After") is not None
        srv.drain(grace_s=10)
        assert srv.wait(timeout=10)
    finally:
        srv.stop()
        shutil.rmtree(cache_dir, ignore_errors=True)
    # no serve threads may outlive the server
    leftover = [t.name for t in threading.enumerate()
                if t.name.startswith("delphi-serve")]
    assert leftover == []


def test_concurrent_escalating_request_is_isolated():
    """Per-request escalation under RequestScope: of two concurrent
    /repair requests on the same table, only the one carrying the
    repair.escalate.* options escalates; the plain request's frame stays
    bit-identical to a solo baseline, and no escalation state leaks into
    later requests (options are per-model, never env)."""
    cache_dir = tempfile.mkdtemp(prefix="delphi_serve_test_")
    srv = RepairServer(port=0, workers=2, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        port = srv.port
        status, base, _ = _post(port, "/repair", _payload(request_id="base"))
        assert status == 200 and base["status"] == "ok"
        assert "escalation" not in base
        f0 = base["frame"]

        esc_opts = {"repair.escalate": "true",
                    "repair.escalate.conf": "0.9",
                    "repair.escalate.adapter": "mock"}
        results = {}

        def call(tag, payload):
            results[tag] = _post(port, "/repair", payload)

        threads = [
            threading.Thread(target=call, args=(
                "esc", _payload(request_id="esc", options=esc_opts))),
            threading.Thread(target=call, args=(
                "plain", _payload(request_id="plain"))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)

        status_p, plain, _ = results["plain"]
        assert status_p == 200 and plain["status"] == "ok"
        assert "escalation" not in plain
        assert plain["frame"] == f0  # bit-identical to the solo baseline

        status_e, escalated, _ = results["esc"]
        assert status_e == 200 and escalated["status"] == "ok"
        summary = escalated["escalation"]
        assert summary["requested"] is True
        assert summary["routed"] >= 1
        assert summary["tiers"]["adapter"]["allowed"] is True
        assert summary["escalated"] >= 1
        # every escalated decision is visible in THAT request's frame
        by_cell = {(str(r["tid"]), str(r["attribute"])): r["repaired"]
                   for r in escalated["frame"]}
        for rid, attr, _tier, value in summary["escalated_cells"]:
            assert by_cell[(rid, attr)] == value

        # nothing sticky: a later plain request matches the baseline
        status, after, _ = _post(port, "/repair", _payload(request_id="aft"))
        assert status == 200 and "escalation" not in after
        assert after["frame"] == f0
    finally:
        srv.stop()
        shutil.rmtree(cache_dir, ignore_errors=True)


# -- fleet membership seam ----------------------------------------------------

def test_fleet_registration_and_liveness_lifecycle(tmp_path):
    """A fleet-armed worker announces itself on start (atomic
    registration file carrying the bound ephemeral port, plus a
    heartbeat-refreshed liveness file the dist-resilience scan reads)
    and removes both on stop; the JAX package's store reads the
    registration the port wrote."""
    from delphi_tpu.parallel import store as j_store
    from delphi_tpu_torch.parallel import dist_resilience as dr

    fleet_dir = str(tmp_path / "fleet")
    cache_dir = tempfile.mkdtemp(prefix="delphi_serve_test_")
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir, fleet_dir=fleet_dir,
                       worker_id="7").start()
    reg_path = os.path.join(fleet_dir, "worker_7.json")
    live_path = dr.member_liveness_path(fleet_dir, "7")
    try:
        from delphi_tpu_torch.parallel import store as dstore
        reg, status = dstore.read_json(reg_path, schema="fleet_reg",
                                       site="store.fleet", root=fleet_dir)
        assert status == "ok"
        assert reg["worker_id"] == "7"
        assert reg["port"] == srv.port
        assert reg["pid"] == os.getpid()
        assert reg["cache_dir"] == cache_dir
        assert j_store.read_json(reg_path, schema="fleet_reg",
                                 site="store.fleet",
                                 root=fleet_dir) == (reg, "ok")
        members = dr.scan_membership(fleet_dir, srv.fleet_heartbeat_s)
        assert members["7"]["status"] == "live"
    finally:
        srv.stop()
        shutil.rmtree(cache_dir, ignore_errors=True)
    assert not os.path.exists(reg_path)
    assert not os.path.exists(live_path)
    leftover = [t.name for t in threading.enumerate()
                if t.name.startswith("delphi-fleet-heartbeat")]
    assert leftover == []


def test_drain_unregisters_membership_before_closing_admission(tmp_path):
    """Ordering contract the fleet leans on: a draining worker must drop
    OUT of the membership ring (unregister liveness) BEFORE it closes
    admission — the router stops routing there ahead of the first 503,
    so a graceful drain never bounces requests off a worker the
    membership scan still calls live."""
    from delphi_tpu_torch.parallel import dist_resilience as dr

    fleet_dir = str(tmp_path / "fleet")
    srv = RepairServer(workers=1, queue_depth=4,
                       fleet_dir=fleet_dir, worker_id="3")
    # registration normally rides start(); invoke it directly so the
    # ordering is observable without the full HTTP stack
    srv._register_fleet_worker()
    live_path = dr.member_liveness_path(fleet_dir, "3")
    assert os.path.exists(live_path)

    calls = []
    real_unregister = srv.unregister_fleet_worker

    def spy():
        calls.append(("unregister", srv._draining))
        real_unregister()

    srv.unregister_fleet_worker = spy
    srv.begin_drain()
    # membership exit fired exactly once, while admission was still open
    assert calls == [("unregister", False)]
    assert srv._draining is True
    assert not os.path.exists(live_path)
    with pytest.raises(Rejection) as ei:
        srv.submit(_payload())
    assert ei.value.status == 503
    # a second drain is a no-op: the spy must not fire again
    srv.begin_drain()
    assert len(calls) == 1


def test_drain_completes_in_flight_request():
    """begin_drain while a request is in flight: admission is closed
    immediately, but the in-flight request finishes (or checkpoints) —
    drain never drops accepted work on the floor."""
    cache_dir = tempfile.mkdtemp(prefix="delphi_serve_test_")
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        job = srv.submit(_payload(request_id="inflight"))
        srv.begin_drain()
        with pytest.raises(Rejection):
            srv.submit(_payload(request_id="toolate"))
        srv.drain(grace_s=120)
        assert job.done.is_set()
        # completed (200) or abort-checkpointed at the grace boundary (503
        # with the resumable flag) — never silently dropped
        if job.status_code == 200:
            assert job.response["status"] == "ok"
        else:
            assert job.status_code == 503
            assert job.response["status"] == "aborted"
            assert job.response["resumable"] is True
    finally:
        srv.stop()
        shutil.rmtree(cache_dir, ignore_errors=True)


def test_drain_reports_stream_cursors_before_closing_admission(tmp_path):
    """The streaming side of the drain contract: POST /drain must reply
    with every stream's last durable cursor and ``resumable: true``
    BEFORE admission closes — the client of a mid-stream drain holds its
    resume point by the time the first delta can bounce off a 503."""
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=str(tmp_path / "cache")).start()
    try:
        sess = srv.streams.session("s1")
        st, _ = sess.apply(
            1, None, pd.DataFrame({"tid": ["1"], "c1": ["v"]}),
            lambda acc, sd, seq: (acc.copy(), {"snapshot_id": "snap-1"}))
        assert st == 200

        events = []
        real_cursors, real_begin = srv.stream_cursors, srv.begin_drain
        srv.stream_cursors = \
            lambda: (events.append("cursors"), real_cursors())[1]
        srv.begin_drain = \
            lambda: (events.append("begin_drain"), real_begin())[1]
        real_respond = serve_mod._ServeHandler._respond

        def spy_respond(handler, status, body, **kw):
            events.append(("respond", status))
            return real_respond(handler, status, body, **kw)

        serve_mod._ServeHandler._respond = spy_respond
        try:
            st, body, _ = _post(srv.port, "/drain", {})
        finally:
            serve_mod._ServeHandler._respond = real_respond
        assert st == 200
        assert body["status"] == "draining" and body["resumable"] is True
        assert body["streams"]["s1"]["seq"] == 1
        assert body["streams"]["s1"]["snapshot_id"] == "snap-1"
        # cursors read → 200 on the wire → admission closed, exactly once.
        # begin_drain runs AFTER the response is written, so the client can
        # return before the handler thread reaches it — wait briefly.
        deadline = time.monotonic() + 5.0
        while len(events) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert events == ["cursors", ("respond", 200), "begin_drain"]
        with pytest.raises(Rejection) as ei:
            srv.submit(_payload())
        assert ei.value.status == 503
    finally:
        srv.stop()


def test_stream_metrics_preseeded_and_healthz_tracks_recovery(tmp_path):
    """Every ``stream.*`` counter/gauge is on /metrics at zero before any
    stream traffic, and /healthz reports ``degraded`` while a stream is
    in recovery replay (serving off a rebuilt durable cursor no commit
    has confirmed yet) — then ``ok`` again after the first commit."""
    from delphi_tpu_torch.incremental.stream import StreamSession

    cache_dir = str(tmp_path / "cache")

    def run(acc, sd, seq):
        return acc.copy(), {"snapshot_id": f"snap-{seq}"}

    # durable stream state left behind by a previous server's life
    seed = StreamSession("s1", os.path.join(cache_dir, "streams", "s1"),
                         store_root=cache_dir)
    assert seed.apply(1, None, pd.DataFrame({"tid": ["1"], "c1": ["v"]}),
                      run)[0] == 200

    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        _, metrics = _get(srv.port, "/metrics")
        for name in ("delphi_stream_deltas", "delphi_stream_commits",
                     "delphi_stream_duplicates", "delphi_stream_conflicts",
                     "delphi_stream_backpressure_429",
                     "delphi_stream_commit_retries",
                     "delphi_stream_recoveries",
                     "delphi_stream_retrain_triggers",
                     "delphi_stream_retrain_swaps",
                     "delphi_stream_retrain_failed",
                     "delphi_stream_lag_rows", "delphi_stream_active",
                     "delphi_stream_recovering"):
            assert _metric(metrics, name) == 0.0
        _, text = _get(srv.port, "/healthz")
        assert json.loads(text)["status"] == "ok"

        # first touch rebuilds the session from the durable cursor:
        # recovery replay until its next commit → degraded
        sess = srv.streams.session("s1")
        assert sess.recovering is True
        _, text = _get(srv.port, "/healthz")
        health = json.loads(text)
        assert health["status"] == "degraded"
        assert health["streams"] == {"active": 1, "recovering": 1,
                                     "lag_rows": 0}

        # the real delta flow: admit → apply → release (the release is
        # what refreshes the stream gauges after the commit)
        srv.streams.admit("s1", 1)
        try:
            assert sess.apply(2, "snap-1",
                              pd.DataFrame({"tid": ["2"], "c1": ["w"]}),
                              run)[0] == 200
        finally:
            srv.streams.release("s1", 1)
        _, text = _get(srv.port, "/healthz")
        assert json.loads(text)["status"] == "ok"
        _, metrics = _get(srv.port, "/metrics")
        assert _metric(metrics, "delphi_stream_recoveries") == 1.0
        assert _metric(metrics, "delphi_stream_commits") == 1.0
        assert _metric(metrics, "delphi_stream_recovering") == 0.0
    finally:
        srv.stop()


def test_stream_backpressure_429_echoes_cursor_over_http(tmp_path):
    """A stream past its in-flight bound is refused at admission with
    429 + Retry-After + the durable cursor in the body: the client knows
    exactly where the server is and when to come back."""
    os.environ["DELPHI_STREAM_MAX_INFLIGHT"] = "1"
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=str(tmp_path / "cache")).start()
    try:
        sess = srv.streams.session("s1")
        st, _ = sess.apply(
            1, None, pd.DataFrame({"tid": ["1"], "c1": ["v"]}),
            lambda acc, sd, seq: (acc.copy(), {"snapshot_id": "snap-1"}))
        assert st == 200
        # occupy the stream's only in-flight slot
        srv.streams.admit("s1", 4)

        payload = _payload(request_id="busy")
        payload["stream"] = {"id": "s1", "seq": 2,
                             "parent_snapshot": "snap-1"}
        st, body, headers = _post(srv.port, "/repair", payload)
        assert st == 429
        assert headers.get("Retry-After") is not None
        assert body["cursor"]["seq"] == 1
        _, metrics = _get(srv.port, "/metrics")
        assert _metric(metrics, "delphi_stream_backpressure_429") >= 1.0
        assert _metric(metrics, "delphi_stream_lag_rows") == 4.0
    finally:
        srv.stop()


def test_warm_restart_reuses_persisted_launch_plans():
    """Launch-plan persistence across the serve plane: the first request
    plans every device phase once and persists the plans under
    ``<cache>/plans/<fingerprint>.json``; a server RESTARTED on the same
    cache dir reports them via the ``serve.warm_plans`` gauge and a repeat
    request with the same table fingerprint replans ZERO times — every
    phase loads its stored grouping (``launch.plan_cache.hits``) instead
    of recomputing it."""
    cache_dir = tempfile.mkdtemp(prefix="delphi_serve_test_")
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        port = srv.port
        status, resp, _ = _post(port, "/repair", _payload(request_id="cold"))
        assert status == 200 and resp["status"] == "ok"
        frame_cold = resp["frame"]

        status, metrics = _get(port, "/metrics")
        assert _metric(metrics, "delphi_launch_replans") > 0
        assert _metric(metrics, "delphi_launch_plans") > 0
        assert _metric(metrics, "delphi_serve_warm_plans") >= 1

        plans_dir = os.path.join(cache_dir, "plans")
        stored = [f for f in os.listdir(plans_dir) if f.endswith(".json")]
        assert stored, "no plan file persisted under <cache>/plans"
    finally:
        srv.stop()

    # warm restart on the same cache dir: plans survive the process-state
    # loss (the in-memory table cache does not, so the model really reruns).
    # Drop the phase checkpoints so the rerun actually computes — a
    # checkpoint resume would skip the planned phases and this test would
    # vacuously pass on replans == 0.
    shutil.rmtree(os.path.join(cache_dir, "ckpt"), ignore_errors=True)
    srv = RepairServer(port=0, workers=1, queue_depth=4,
                       cache_dir=cache_dir).start()
    try:
        port = srv.port
        status, metrics = _get(port, "/metrics")
        assert _metric(metrics, "delphi_serve_warm_plans") >= 1

        status, resp, _ = _post(port, "/repair", _payload(request_id="warm"))
        assert status == 200 and resp["status"] == "ok"
        assert resp["frame"] == frame_cold

        status, metrics = _get(port, "/metrics")
        assert _metric(metrics, "delphi_serve_table_cache_hits") == 0
        assert _metric(metrics, "delphi_launch_plan_cache_hits") > 0
        assert _metric(metrics, "delphi_launch_replans") == 0
        # the trained models came back from the per-fingerprint checkpoint
        assert _metric(metrics, "delphi_train_checkpoint_hits") > 0
    finally:
        srv.stop()
        shutil.rmtree(cache_dir, ignore_errors=True)

# -- the port against the JAX package's run() --------------------------------
# -- the port against the JAX package's run() ----------------------------------

def _as_table(frame):
    """A frame as a /repair request's ``table`` (column -> JSON values)."""
    split = json.loads(frame.to_json(orient="split"))
    return {c: [row[i] for row in split["data"]]
            for i, c in enumerate(split["columns"])}


def _sorted_records(frame) -> str:
    """What the server does to ``run()``'s frame: sorted by all columns,
    then ``to_json(orient="records")``; dumped as the response dumps it."""
    frame = frame.sort_values(list(frame.columns)).reset_index(drop=True)
    return json.dumps(json.loads(frame.to_json(orient="records")))


def _jax_run(frame, options):
    model = J.delphi.repair.setInput(frame).setRowId("tid") \
        .setErrorDetectors([J.NullErrorDetector()])
    for key, value in options.items():
        model = model.option(key, value)
    return model.run()


_MISSING_HEAVY = {"error.max_attrs_to_compute_pairwise_stats": "4",
                  "model.hp.max_evals": "1"}


@pytest.mark.parametrize("case", ["missing_heavy_2000", "smoke_frame"])
def test_served_frame_is_the_jax_run_byte_for_byte(case, tmp_path):
    """The served ``frame`` equals the JAX package's ``run()`` on the same
    table put through the server's sort and ``to_json``, byte for byte,
    and a warm repeat (table cache, phase checkpoints) answers the same
    bytes."""
    if case == "smoke_frame":
        frame, options = bench._smoke_frame(), {}
    else:
        frame = generate_scenario("missing_heavy", 2000, seed=0).dirty
        options = _MISSING_HEAVY
    want = _sorted_records(_jax_run(frame, options))
    payload = {"table": _as_table(frame), "row_id": "tid",
               "options": options}
    srv = RepairServer(port=0, workers=1,
                       cache_dir=str(tmp_path / "cache")).start()
    try:
        status, cold, _ = _post(srv.port, "/repair", payload)
        assert status == 200, cold
        assert json.dumps(cold["frame"]) == want
        status, warm, _ = _post(srv.port, "/repair", payload)
        assert status == 200 and json.dumps(warm["frame"]) == want
        _, metrics = _get(srv.port, "/metrics")
        assert _metric(metrics, "delphi_serve_table_cache_hits") == 1
        assert _metric(metrics, "delphi_resilience_checkpoint_hits") > 0
    finally:
        srv.stop()
    assert cold["rows"] == len(json.loads(want)) > 0


def test_concurrent_requests_isolate_a_scoped_fault(tmp_path):
    """Two requests side by side on different tables, one under the plan
    ``xfer.upload:1:transient,domain.bucket:1:fatal``: the clean frame is
    the solo frame bit for bit (and the JAX package's), the faulted one
    answers a structured 500, and only the faulted table's warm state (its
    table-cache entry and its model checkpoint) is evicted."""
    clean_df = bench._smoke_frame()
    fault_df = clean_df.copy()
    fault_df["c2"] = [str((i * 3) % 7) for i in range(len(fault_df))]
    base = {"table": _as_table(clean_df), "row_id": "tid"}
    faulted = {"table": _as_table(fault_df), "row_id": "tid",
               "fault_plan": "xfer.upload:1:transient,domain.bucket:1:fatal"}
    clean_fp = table_fingerprint(base["table"], "tid")
    fault_fp = table_fingerprint(faulted["table"], "tid")

    solo_srv = RepairServer(port=0, workers=1,
                            cache_dir=str(tmp_path / "solo")).start()
    try:
        status, solo, _ = _post(solo_srv.port, "/repair",
                                dict(base, request_id="solo"))
        assert status == 200
    finally:
        solo_srv.stop()
    assert json.dumps(solo["frame"]) == _sorted_records(_jax_run(clean_df,
                                                                 {}))

    srv = RepairServer(port=0, workers=2,
                       cache_dir=str(tmp_path / "pair")).start()
    try:
        results = {}
        # both requests are admitted before either worker starts
        gate = threading.Barrier(2)

        def call(tag, body):
            gate.wait(timeout=30)
            results[tag] = _post(srv.port, "/repair", body)

        threads = [threading.Thread(target=call, args=(
                       "clean", dict(base, request_id="clean"))),
                   threading.Thread(target=call, args=(
                       "fault", dict(faulted, request_id="fault")))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        st_clean, clean, _ = results["clean"]
        st_fault, fault, _ = results["fault"]
        assert st_clean == 200 and clean["frame"] == solo["frame"]
        assert st_fault == 500
        assert fault["status"] == "error" and fault["kind"] == "fatal"
        assert "FaultInjected" in fault["error"]
        with srv._lock:
            warm = set(srv._tables)
        assert warm == {clean_fp}
        assert os.path.isdir(srv._models_dir(clean_fp))
        assert not os.path.exists(srv._models_dir(fault_fp))
        _, metrics = _get(srv.port, "/metrics")
        assert _metric(metrics, "delphi_serve_failed") == 1
        assert _metric(metrics, "delphi_serve_completed") == 1
        assert _metric(metrics, "delphi_resilience_retries") >= 1
        # the clean table stays warm and answers the same bytes again
        status, again, _ = _post(srv.port, "/repair",
                                 dict(base, request_id="again"))
        assert status == 200 and again["frame"] == solo["frame"]
    finally:
        srv.stop()


def test_stream_chained_over_http_equals_one_batch_run(tmp_path):
    """Three deltas of ``bench._stream_frames()`` chained over HTTP (each
    citing the previous commit's snapshot) end on the frame of one batch
    run over the concatenation, the port's and the JAX package's; a
    replayed delta acknowledges as a duplicate."""
    full, parts = bench._stream_frames()
    srv = RepairServer(port=0, workers=1,
                       cache_dir=str(tmp_path / "cache")).start()
    try:
        parent, last = None, None
        for seq, part in enumerate(parts, start=1):
            body = {"table": _as_table(part), "row_id": "tid",
                    "request_id": f"d{seq}",
                    "stream": {"id": "chain", "seq": seq,
                               "parent_snapshot": parent}}
            status, last, _ = _post(srv.port, "/repair", body)
            assert status == 200, last
            parent = last["cursor"]["snapshot_id"]
        status, dup, _ = _post(srv.port, "/repair", body)
        assert status == 200 and dup["status"] == "duplicate"
    finally:
        srv.stop()
    port_batch = T.delphi.repair.setInput(full).setRowId("tid") \
        .setErrorDetectors([T.NullErrorDetector()]).run()
    assert json.dumps(last["frame"]) == _sorted_records(port_batch)
    assert json.dumps(last["frame"]) == _sorted_records(_jax_run(full, {}))


def test_side_by_side_requests_count_what_solo_requests_count(tmp_path):
    """Two clean requests on different tables served side by side answer
    their solo frames, and the ``launch.*`` counters they add equal the sum
    of what each adds when served alone: no plan, bucket or launch of one
    request leaks into the other's."""
    first = bench._smoke_frame()
    second = first.copy()
    second["c2"] = [str((i * 5) % 7) for i in range(len(second))]
    payloads = [{"table": _as_table(df), "row_id": "tid"}
                for df in (first, second)]

    def launch_counts(srv):
        counters = srv.recorder.registry.snapshot()["counters"]
        return {k: v for k, v in counters.items()
                if k.startswith("launch.") and "ledger" not in k}

    solo = RepairServer(port=0, workers=1,
                        cache_dir=str(tmp_path / "solo")).start()
    try:
        want = [_post(solo.port, "/repair", p)[1]["frame"]
                for p in payloads]
        solo_counts = launch_counts(solo)
    finally:
        solo.stop()

    srv = RepairServer(port=0, workers=2,
                       cache_dir=str(tmp_path / "pair")).start()
    try:
        gate = threading.Barrier(2)
        got = {}

        def call(i):
            gate.wait(timeout=30)
            got[i] = _post(srv.port, "/repair", payloads[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
        pair_counts = launch_counts(srv)
    finally:
        srv.stop()
    assert [got[i][0] for i in range(2)] == [200, 200]
    assert [got[i][1]["frame"] for i in range(2)] == want
    assert pair_counts == solo_counts
    assert pair_counts["launch.launches"] > 0
