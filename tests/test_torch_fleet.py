"""The port's repair fleet (``delphi_tpu_torch/observability/fleet.py``)
and its membership reader (``parallel/dist_resilience.scan_membership``)
against the JAX package's on the CPU.

* every case of ``tests/test_fleet.py`` against the port's
  ``FleetRouter``, with scripted in-process HTTP workers: rendezvous
  ranking, the pre-seeded ``fleet.*`` counters, all-shed, a dead worker
  evicted and its request re-dispatched, table and chain affinity, stale
  liveness evicting and a fresh stamp rejoining;
* the ``AutoscalePolicy`` / ``FleetAutoscaler`` cases of
  ``tests/test_load.py``: the decision table (sustain, hysteresis,
  cooldown, limits) and the graceful scale-down;
* ``scan_membership`` and ``rendezvous_rank`` equal to the JAX package's
  on the same directory and members;
* one real fleet of two port workers (``python -m delphi_tpu_torch.main
  --serve`` on the CPU) behind the router: worker 1 dies by a rank-scoped
  ``rank_death`` plan mid-traffic, every request completes, and every
  frame equals the single server's.
"""

import json
import os
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

import bench
import delphi_tpu_torch as T
from delphi_tpu.observability import fleet as j_fleet
from delphi_tpu.parallel import dist_resilience as j_dr
from delphi_tpu_torch import observability as obs
from delphi_tpu_torch.observability.fleet import (
    AutoscalePolicy, FleetAutoscaler, FleetRouter, rendezvous_rank,
)
from delphi_tpu_torch.observability.serve import (
    RepairServer, chain_fingerprint, table_fingerprint,
)
from delphi_tpu_torch.parallel import dist_resilience as dr
from delphi_tpu_torch.parallel import resilience as rz

_ENV_VARS = (
    "DELPHI_FAULT_PLAN", "DELPHI_FLEET_DIR", "DELPHI_FLEET_WORKER_ID",
    "DELPHI_FLEET_HEARTBEAT_S", "DELPHI_FLEET_WORKERS",
    "DELPHI_FLEET_MAX_HOPS", "DELPHI_FLEET_SPAWN_TIMEOUT_S",
    "DELPHI_SERVE_CACHE_DIR", "DELPHI_COMPILE_CACHE_DIR",
    "DELPHI_AUTOSCALE", "DELPHI_AUTOSCALE_MIN", "DELPHI_AUTOSCALE_MAX",
    "DELPHI_AUTOSCALE_UP_QUEUE", "DELPHI_AUTOSCALE_DOWN_QUEUE",
    "DELPHI_AUTOSCALE_UP_LAG_ROWS", "DELPHI_AUTOSCALE_SUSTAIN",
    "DELPHI_AUTOSCALE_COOLDOWN_S", "DELPHI_AUTOSCALE_INTERVAL_S",
)


@pytest.fixture(autouse=True)
def _clean_fleet_state():
    saved = {v: os.environ.get(v) for v in _ENV_VARS}
    for v in _ENV_VARS:
        os.environ.pop(v, None)
    rz.reset_fault_state()
    rz.clear_abort()
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
    torch.set_num_threads(threads)
    T.set_device(None)


def _payload(tag="t0"):
    return {"table": {"tid": ["1", "2"], "c0": [tag, tag]}, "row_id": "tid"}


class _ScriptedWorker:
    """An in-process HTTP 'worker' answering /repair from a script:
    ``respond(payload) -> (status, body_dict, headers_dict)``."""

    def __init__(self, respond):
        self.respond = respond
        self.requests = []
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
                outer.requests.append(payload)
                status, body, headers = outer.respond(payload)
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _register(fleet_dir, wid, port):
    """Fake a worker registration + fresh liveness stamp, the exact
    on-disk shape serve.RepairServer._register_fleet_worker writes."""
    os.makedirs(fleet_dir, exist_ok=True)
    path = os.path.join(fleet_dir, f"worker_{wid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"worker_id": wid, "port": port, "pid": os.getpid(),
                   "cache_dir": "", "started": 0.0}, f)
    os.replace(path + ".tmp", path)
    dr.touch_liveness_file(dr.member_liveness_path(fleet_dir, wid))


def _counters(router):
    return router.recorder.registry.snapshot()["counters"]


def _closed_port():
    """A port nothing listens on (bound then released)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def router(tmp_path):
    rt = FleetRouter(port=0, workers=2, cache_dir=str(tmp_path),
                     spawn=False, heartbeat_s=1.0)
    yield rt
    rt.stop()


# -- rendezvous and the membership reader -------------------------------------

def test_rendezvous_rank_is_stable_under_member_removal():
    members = [str(i) for i in range(5)]
    for fp in ("a", "b", "c", "deadbeef"):
        full = rendezvous_rank(fp, members)
        assert full == j_fleet.rendezvous_rank(fp, members)
        for gone in members:
            survivors = [m for m in members if m != gone]
            # removing ONE member never reorders the survivors
            assert rendezvous_rank(fp, survivors) == [
                m for m in full if m != gone]


def test_scan_membership_matches_the_jax_package(tmp_path):
    """Live, dead and unknown members, read from one directory by both
    packages at one clock: the same map; files that are not liveness
    stamps are skipped; a missing directory reads as no members."""
    d = str(tmp_path / "members")
    now = 1_000_000.0
    os.makedirs(d)
    for member, age in (("0", 0.5), ("1", 10.0), ("7", 2.9), ("x", 3.1)):
        with open(dr.member_liveness_path(d, member), "w") as f:
            f.write(repr(now - age))
    assert dr.member_liveness_path(d, "3") == \
        j_dr.member_liveness_path(d, "3")
    with open(os.path.join(d, "rank_9.alive"), "w") as f:
        f.write("not a stamp")
    with open(os.path.join(d, "worker_0.json"), "w") as f:
        f.write("{}")
    got = dr.scan_membership(d, 1.0, now=now)
    assert got == j_dr.scan_membership(d, 1.0, now=now)
    assert {m: v["status"] for m, v in got.items()} == {
        "0": "live", "1": "dead", "7": "live", "x": "dead", "9": "unknown"}
    assert got["1"]["age_s"] == pytest.approx(10.0)
    for interval in (0.0, 0.2, 5.0):
        assert dr.scan_membership(d, interval, now=now) == \
            j_dr.scan_membership(d, interval, now=now)
    assert dr.scan_membership(str(tmp_path / "absent"), 1.0) == {}
    path = dr.member_liveness_path(d, "0")
    for interval in (0.1, 1.0):
        assert dr.diagnose_liveness_file(path, interval, now=now) == \
            j_dr.diagnose_liveness_file(path, interval, now=now)
    assert dr.diagnose_liveness_file(None, 1.0) == "unknown"


# -- metrics / health surfaces ------------------------------------------------

def test_fleet_counters_preseeded_at_zero(router, tmp_path):
    w = _ScriptedWorker(lambda p: (200, {"status": "ok"}, {}))
    try:
        _register(router.fleet_dir, "0", w.port)
        router.start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        for name in ("delphi_fleet_requests", "delphi_fleet_dispatches",
                     "delphi_fleet_redispatches", "delphi_fleet_evictions",
                     "delphi_fleet_rejoins", "delphi_fleet_dispatch_faults",
                     "delphi_fleet_all_shed", "delphi_fleet_no_workers",
                     "delphi_fleet_affinity_hits",
                     "delphi_fleet_affinity_misses"):
            lines = [ln for ln in metrics.splitlines()
                     if ln.startswith(name + " ")]
            assert lines, f"{name} not pre-seeded on router /metrics"
            assert float(lines[0].split()[1]) == 0.0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["live"] == ["0"]
    finally:
        w.close()


# -- failover edge cases ------------------------------------------------------

def test_all_shed_returns_429_with_max_retry_after(router):
    """Every live worker shedding must terminate in ONE bounded pass:
    each worker dispatched at most once, 429 out, Retry-After = the MAX
    the fleet quoted (retrying sooner would just get shed again)."""
    shed_a = _ScriptedWorker(
        lambda p: (429, {"status": "rejected", "reason": "queue full"},
                   {"Retry-After": "3"}))
    shed_b = _ScriptedWorker(
        lambda p: (429, {"status": "rejected", "reason": "queue full"},
                   {"Retry-After": "7"}))
    try:
        _register(router.fleet_dir, "0", shed_a.port)
        _register(router.fleet_dir, "1", shed_b.port)
        router.start()
        status, body, retry_after = router.handle_repair(_payload())
        assert status == 429
        assert body["status"] == "rejected"
        assert retry_after == 7.0
        assert len(shed_a.requests) == 1
        assert len(shed_b.requests) == 1
        snap = _counters(router)
        assert snap.get("fleet.all_shed", 0) == 1
        assert snap.get("fleet.evictions", 0) == 0  # shedding != broken
    finally:
        shed_a.close()
        shed_b.close()


def test_dead_worker_is_evicted_and_request_rerouted(router):
    """A worker dying between the membership check and the dispatch
    (fresh liveness stamp, nothing listening on its port) is a
    fleet.dispatch fault: evicted, liveness dropped, the in-flight
    request re-dispatched to the survivor — and /healthz degrades."""
    ok = _ScriptedWorker(
        lambda p: (200, {"status": "ok", "frame": [{"v": 1}]}, {}))
    try:
        payload = _payload()
        fp = table_fingerprint(payload["table"], payload["row_id"])
        victim = rendezvous_rank(fp, ["0", "1"])[0]
        survivor = "1" if victim == "0" else "0"
        # the request's rendezvous HOME gets a dead port, so the first
        # dispatch always hits the corpse
        _register(router.fleet_dir, victim, _closed_port())
        _register(router.fleet_dir, survivor, ok.port)
        router.start()

        status, body, _ = router.handle_repair(payload)
        assert status == 200
        assert body["frame"] == [{"v": 1}]
        assert body["worker_id"] == survivor and body["hops"] == 2
        assert len(ok.requests) == 1

        snap = _counters(router)
        assert snap.get("fleet.dispatch_faults", 0) == 1
        assert snap.get("fleet.evictions", 0) == 1
        assert snap.get("fleet.redispatches", 0) == 1
        # anti-flapping: the corpse's stale stamp was dropped with it
        assert not os.path.exists(
            dr.member_liveness_path(router.fleet_dir, victim))

        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "degraded"
        assert victim in health["evicted"]
        assert health["live"] == [survivor]
    finally:
        ok.close()


def test_affinity_same_payload_keeps_its_home_worker(router):
    """Repeated repairs of one table must keep landing on its
    rendezvous-home replica — that is where the warm state lives."""
    workers = {
        "0": _ScriptedWorker(lambda p: (200, {"status": "ok"}, {})),
        "1": _ScriptedWorker(lambda p: (200, {"status": "ok"}, {})),
    }
    try:
        for wid, w in workers.items():
            _register(router.fleet_dir, wid, w.port)
        router.start()
        payload = _payload()
        fp = table_fingerprint(payload["table"], payload["row_id"])
        home = rendezvous_rank(fp, ["0", "1"])[0]
        for _ in range(3):
            status, _, _ = router.handle_repair(payload)
            assert status == 200
        assert len(workers[home].requests) == 3
        other = "1" if home == "0" else "0"
        assert len(workers[other].requests) == 0
        snap = _counters(router)
        assert snap.get("fleet.affinity.hits", 0) == 3
        assert snap.get("fleet.affinity.misses", 0) == 0
    finally:
        for w in workers.values():
            w.close()


def test_chain_affinity_routes_stream_deltas_by_chain_root(router):
    """Chained stream deltas must route by the CHAIN-ROOT fingerprint,
    not per-delta table content: every link of a chain lands on the home
    that holds its durable cursor and warm models, counted as
    ``fleet.affinity.chain_hits``. The delta tables are chosen so their
    TABLE fingerprints home on the OTHER worker — proof the router keyed
    on the chain."""
    from delphi_tpu.observability.serve import (
        chain_fingerprint as j_chain, table_fingerprint as j_table,
    )

    workers = {
        "0": _ScriptedWorker(lambda p: (200, {"status": "ok"}, {})),
        "1": _ScriptedWorker(lambda p: (200, {"status": "ok"}, {})),
    }
    try:
        for wid, w in workers.items():
            _register(router.fleet_dir, wid, w.port)
        router.start()
        sid = "chain-test"
        chain = chain_fingerprint({"stream": {"id": sid}})
        assert chain == j_chain({"stream": {"id": sid}})
        assert chain_fingerprint({"base_snapshot": "n"}) == \
            j_chain({"base_snapshot": "n"})
        chain_home = rendezvous_rank(chain, ["0", "1"])[0]
        tags = [t for t in (f"a{i}" for i in range(16))
                if rendezvous_rank(
                    table_fingerprint(_payload(t)["table"], "tid"),
                    ["0", "1"])[0] != chain_home][:3]
        assert tags, "no delta content hashed away from the chain home"
        for tag in tags:
            assert table_fingerprint(_payload(tag)["table"], "tid") == \
                j_table(_payload(tag)["table"], "tid")
        for seq, tag in enumerate(tags, start=1):
            payload = _payload(tag)
            payload["stream"] = {"id": sid, "seq": seq}
            status, _, _ = router.handle_repair(payload)
            assert status == 200
        assert len(workers[chain_home].requests) == len(tags)
        other = "1" if chain_home == "0" else "0"
        assert len(workers[other].requests) == 0
        snap = _counters(router)
        assert snap.get("fleet.affinity.chain_hits", 0) == len(tags)
        assert snap.get("fleet.affinity.hits", 0) == 0
        assert snap.get("fleet.affinity.misses", 0) == 0
    finally:
        for w in workers.values():
            w.close()


# -- membership from liveness files -------------------------------------------

def test_stale_liveness_evicts_and_retouch_rejoins(router):
    _register(router.fleet_dir, "0", 1)
    _register(router.fleet_dir, "1", 2)
    router.start()
    now = time.time()
    assert sorted(router.refresh_membership(now=now)) == ["0", "1"]

    # worker 1's stamp goes stale (> 3x heartbeat): evicted, not departed
    assert router.refresh_membership(now=now + 100.0) == []
    snap = _counters(router)
    assert snap.get("fleet.evictions", 0) == 2
    with router._lock:
        assert set(router._evicted) == {"0", "1"}

    # a fresh stamp rejoins the ring without operator action; worker 0's
    # stamp is rewritten genuinely stale so only 1 comes back
    with open(dr.member_liveness_path(router.fleet_dir, "0"), "w") as f:
        f.write(repr(time.time() - 100.0))
    dr.touch_liveness_file(dr.member_liveness_path(router.fleet_dir, "1"))
    live = router.refresh_membership(now=time.time())
    assert live == ["1"]
    snap = _counters(router)
    assert snap.get("fleet.rejoins", 0) == 1

    # a worker whose REGISTRATION disappears departed cleanly: dropped
    # from the ring AND the evicted set, no extra eviction counted
    os.remove(os.path.join(router.fleet_dir, "worker_0.json"))
    router.refresh_membership(now=time.time())
    with router._lock:
        assert "0" not in router._workers
        assert "0" not in router._evicted
    assert _counters(router).get("fleet.evictions", 0) == 2
    # the membership rides the report's dist section
    assert router.recorder.dist["fleet"]["live"] == ["1"]


# -- the autoscale decision table ---------------------------------------------

def _policy(**kw):
    base = dict(min_workers=1, max_workers=4, up_queue_depth=4,
                down_queue_depth=0, up_lag_rows=512, sustain_ticks=3,
                cooldown_s=30.0)
    base.update(kw)
    return AutoscalePolicy(**base)


def test_policy_scales_up_only_after_sustained_queue_pressure():
    p = _policy()
    assert p.observe(0.0, 5, 0, 2) == ("hold", "building")
    assert p.observe(1.0, 5, 0, 2) == ("hold", "building")
    action, reason = p.observe(2.0, 5, 0, 2)
    assert action == "up" and "queue_depth=5" in reason


def test_policy_lag_pressure_alone_scales_up():
    p = _policy(sustain_ticks=1)
    action, reason = p.observe(0.0, 0, 1000, 2)
    assert action == "up" and "lag_rows=1000" in reason


def test_policy_hysteresis_band_resets_streaks():
    rec = obs.start_recording("test.autoscale.hysteresis")
    try:
        p = _policy()
        p.observe(0.0, 5, 0, 2)
        p.observe(1.0, 5, 0, 2)
        # queue falls into the band (0 < 2 < 4): streak dies, no action
        assert p.observe(2.0, 2, 0, 2) == ("hold", "hysteresis")
        # pressure returns but must re-earn the full sustain window
        assert p.observe(3.0, 5, 0, 2) == ("hold", "building")
        assert p.observe(4.0, 5, 0, 2) == ("hold", "building")
        assert p.observe(5.0, 5, 0, 2)[0] == "up"
        counters = rec.registry.snapshot()["counters"]
    finally:
        obs.stop_recording(rec)
    assert counters.get("autoscale.blocked_hysteresis") == 1
    assert counters.get("autoscale.up", 0) == 0  # policy decides, never acts
    assert counters.get("autoscale.ticks") == 6


def test_policy_cooldown_blocks_consecutive_actions():
    rec = obs.start_recording("test.autoscale.cooldown")
    try:
        p = _policy(sustain_ticks=1, cooldown_s=30.0)
        assert p.observe(0.0, 5, 0, 2)[0] == "up"
        # pressure persists, but the new worker needs time to absorb load
        assert p.observe(1.0, 5, 0, 3) == ("hold", "cooldown")
        assert p.observe(29.0, 5, 0, 3) == ("hold", "cooldown")
        assert p.observe(31.0, 5, 0, 3)[0] == "up"
        counters = rec.registry.snapshot()["counters"]
    finally:
        obs.stop_recording(rec)
    assert counters.get("autoscale.blocked_cooldown") == 2


def test_policy_respects_min_and_max_limits():
    p = _policy(sustain_ticks=1)
    assert p.observe(0.0, 5, 0, 4) == ("hold", "at_max")
    q = _policy(min_workers=2, sustain_ticks=1)
    assert q.observe(0.0, 0, 0, 2) == ("hold", "at_min")
    # one replica above the floor may retire
    action, reason = q.observe(1.0, 0, 0, 3)
    assert action == "down" and "queue_depth=0" in reason


def test_policy_and_scaler_read_the_autoscale_settings():
    """The ``DELPHI_AUTOSCALE_*`` settings, read alike by both packages."""
    env = {"DELPHI_AUTOSCALE_MIN": "2", "DELPHI_AUTOSCALE_MAX": "6",
           "DELPHI_AUTOSCALE_UP_QUEUE": "5",
           "DELPHI_AUTOSCALE_DOWN_QUEUE": "1",
           "DELPHI_AUTOSCALE_UP_LAG_ROWS": "99",
           "DELPHI_AUTOSCALE_SUSTAIN": "4",
           "DELPHI_AUTOSCALE_COOLDOWN_S": "12.5",
           "DELPHI_AUTOSCALE_INTERVAL_S": "0.5"}
    os.environ.update(env)
    fields = ("min_workers", "max_workers", "up_queue_depth",
              "down_queue_depth", "up_lag_rows", "sustain_ticks",
              "cooldown_s")
    got = [getattr(AutoscalePolicy(), f) for f in fields]
    assert got == [2, 6, 5, 1, 99, 4, 12.5]
    assert got == [getattr(j_fleet.AutoscalePolicy(), f) for f in fields]
    assert FleetAutoscaler(object()).interval_s == 0.5


# -- the autoscaler's graceful scale-down -------------------------------------

class _ScriptedAutoscaler(FleetAutoscaler):
    """Seam overrides: no sockets — health polls and drain posts are
    scripted, and a drained worker departs the ring immediately."""

    def __init__(self, router, policy, health):
        super().__init__(router, policy, interval_s=3600.0)
        self.health = health  # port -> healthz dict
        self.drained = []
        self.spawned = []

    def _poll_worker(self, port):
        return self.health.get(port)

    def _post_drain(self, port):
        self.drained.append(port)
        fleet_dir = self.router.fleet_dir
        for wid, info in list(self.router._workers.items()):
            if info.get("port") == port:
                for path in (os.path.join(fleet_dir, f"worker_{wid}.json"),
                             dr.member_liveness_path(fleet_dir, wid)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        return True

    def scale_up(self, reason):
        self.spawned.append(reason)
        return "spawned"


@pytest.fixture
def scripted_fleet(tmp_path):
    router = FleetRouter(port=0, workers=2, cache_dir=str(tmp_path),
                         spawn=False, heartbeat_s=1.0)
    _register(router.fleet_dir, "0", 42001)
    _register(router.fleet_dir, "1", 42002)
    yield router
    router.stop()


def test_autoscaler_scale_down_drains_the_highest_id_first(scripted_fleet):
    rec = obs.start_recording("test.autoscale.drain")
    try:
        scaler = _ScriptedAutoscaler(
            scripted_fleet, _policy(min_workers=1, sustain_ticks=1,
                                    cooldown_s=0.0),
            health={42001: {"queue_depth": 0, "streams": {"lag_rows": 0}},
                    42002: {"queue_depth": 0, "streams": {"lag_rows": 0}}})
        victim = scaler.scale_down("test", depart_timeout_s=2.0)
        counters = rec.registry.snapshot()["counters"]
    finally:
        obs.stop_recording(rec)
    assert victim == "1"  # highest id = youngest/coldest replica
    assert scaler.drained == [42002]  # /drain, never a kill
    assert counters.get("autoscale.down") == 1
    assert scaler.events and scaler.events[0]["action"] == "down"
    assert scaler.events[0]["drained"] is True
    assert "1" not in scripted_fleet.refresh_membership()


def test_autoscaler_scale_down_respects_the_min_floor(scripted_fleet):
    scaler = _ScriptedAutoscaler(
        scripted_fleet, _policy(min_workers=2, sustain_ticks=1),
        health={})
    assert scaler.scale_down("test") is None
    assert scaler.drained == []


def test_autoscaler_tick_wires_worst_case_signals_to_actions(
        scripted_fleet):
    """collect() takes the WORST queue/lag across the ring (one hot
    replica is a problem), and tick() routes the policy verdict to the
    scale action."""
    rec = obs.start_recording("test.autoscale.tick")
    try:
        scaler = _ScriptedAutoscaler(
            scripted_fleet, _policy(sustain_ticks=1, cooldown_s=0.0),
            health={42001: {"queue_depth": 0, "streams": {"lag_rows": 0}},
                    42002: {"queue_depth": 9, "streams": {"lag_rows": 3}}})
        assert scaler.collect() == (9, 3, 2)
        action, reason = scaler.tick()
        gauges = rec.registry.snapshot()["gauges"]
    finally:
        obs.stop_recording(rec)
    assert action == "up" and scaler.spawned == [reason]
    assert gauges.get("autoscale.queue_depth") == 9
    assert gauges.get("autoscale.lag_rows") == 3


# -- a real fleet of port workers ---------------------------------------------

def _as_table(frame):
    split = json.loads(frame.to_json(orient="split"))
    return {c: [row[i] for row in split["data"]]
            for i, c in enumerate(split["columns"])}


def _post(port, body, timeout=240):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/repair", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# the workers' environment: the port on the CPU, one torch thread each
WORKER_ENV = {"DELPHI_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
              "DELPHI_FLEET_HEARTBEAT_S": "0.5",
              "DELPHI_RETRY_BASE_S": "0.001"}


def _fleet_tables():
    """Three 64-row tables: ``bench._smoke_frame()`` and two variants of
    its c2, each a distinct fingerprint."""
    base = bench._smoke_frame()
    tables = [base]
    for mult in (3, 5):
        df = base.copy()
        df["c2"] = [str((i * mult) % 7) for i in range(len(df))]
        tables.append(df)
    return [_as_table(df) for df in tables]


def test_real_fleet_loses_no_request_when_a_worker_dies(tmp_path):
    """Two port workers (``python -m delphi_tpu_torch.main --serve`` on the
    CPU, one process each) behind the router. Six requests over three
    tables; the first request of the table whose home is worker 1 carries
    ``1:xfer.upload:1:rank_death``, which kills worker 1 (exit 17) and no
    other: the router evicts it and re-dispatches, every request answers
    200 with the single server's frame, and ``/healthz`` reads
    ``degraded``. Each worker is a one-process run: it joined no cluster,
    though ``DELPHI_COORDINATOR`` was set where the router started."""
    tables = _fleet_tables()
    srv = RepairServer(port=0, workers=1,
                       cache_dir=str(tmp_path / "solo")).start()
    try:
        want = []
        for i, table in enumerate(tables):
            status, body = _post(srv.port, {"table": table, "row_id": "tid",
                                            "request_id": f"solo{i}"})
            assert status == 200, body
            want.append(body["frame"])
    finally:
        srv.stop()
    assert want[0] != want[1] or want[1] != want[2]

    homes = [rendezvous_rank(table_fingerprint(t, "tid"), ["0", "1"])[0]
             for t in tables]
    assert "1" in homes and "0" in homes
    victim_table = homes.index("1")
    router = FleetRouter(port=0, workers=2, cache_dir=str(tmp_path / "fleet"),
                         heartbeat_s=0.5, worker_env=WORKER_ENV)
    try:
        os.environ["DELPHI_COORDINATOR"] = "127.0.0.1:1"
        try:
            router.start()
        finally:
            os.environ.pop("DELPHI_COORDINATOR")
        assert sorted(router.spawn_seconds) == ["0", "1"]
        order = [0, 1, 2, 0, 1, 2]
        results = []
        for n, ti in enumerate(order):
            body = {"table": tables[ti], "row_id": "tid",
                    "request_id": f"r{n}"}
            if ti == victim_table and n < 3:
                body["fault_plan"] = "1:xfer.upload:1:rank_death"
            results.append((ti, *_post(router.port, body)))
        for ti, status, body in results:
            assert status == 200, body
            assert body["frame"] == want[ti]
        assert router._procs["1"].wait(timeout=30) == 17
        assert router._procs["0"].poll() is None
        snap = _counters(router)
        assert snap["fleet.evictions"] >= 1
        assert snap["fleet.redispatches"] >= 1
        assert snap["fleet.dispatch_faults"] >= 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "degraded"
        assert health["live"] == ["0"]
        # the survivor came up as a one-process service: a worker that
        # tried to join the coordinator (set, without a world size) would
        # have raised before it registered
        with open(router._worker_log_path("0")) as f:
            assert f.read().startswith("delphi repair service on 127.0.0.1:")
    finally:
        router.stop()
        for proc in router._procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
