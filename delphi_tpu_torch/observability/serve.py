"""Serving plane of the port: a persistent repair service over the live
HTTP plane, the JAX package's ``delphi_tpu/observability/serve.py``.

``RepairServer`` turns the one-shot pipeline into a long-lived process that
multiplexes concurrent repair sessions over shared warm state:

* the **kernel library's build cache** (``parallel/compile_plane.py``,
  ``DELPHI_COMPILE_CACHE_DIR``) — armed once at server start under the
  serve cache dir, so a restarted server (or a fleet worker) loads the
  library built there instead of running ``nvcc``; the library loads once
  per process, so ``compile_cache.*`` counts at most one request per
  process (deviation D9 of ``ROADMAP.md``: in the JAX package it counts
  XLA's persistent-cache lookups);
* **device-resident column codes** (``ops/xfer.py``) — input tables are
  encoded once per content fingerprint, registered in the session catalog,
  and their uploaded code buffers survive on the column objects across
  requests;
* **trained models cached by table fingerprint** — each request points
  ``model.checkpoint_path`` at a per-fingerprint directory under the serve
  cache dir, so a repeated table skips training (``train.checkpoint_hits``)
  and a restarted server rebuilds its warm state from disk.

Robustness-first control plane:

* **admission/queueing**: a bounded queue (``DELPHI_SERVE_QUEUE_DEPTH``)
  with load-shedding — 429 + ``Retry-After`` when the queue is full, the
  process RSS exceeds ``DELPHI_SERVE_MAX_RSS_GB``, or the span heartbeat
  says the in-flight work is wedged; 503 + ``Retry-After`` while draining;
* **per-request deadlines** (``DELPHI_SERVE_DEADLINE_S`` or the request's
  ``deadline_s`` field) threaded into the resilience seam as a
  :class:`~delphi_tpu_torch.parallel.resilience.RequestScope`: retry backoff is
  clipped to the remaining budget and expiry raises ``DeadlineExceeded`` at
  the next guarded seam / phase boundary → HTTP 504, never a wedged worker;
* **fault isolation**: each request runs under its own ``RequestScope``
  (private fault plan, abort latch, CPU latch, checkpoint dir) and its own
  provenance ledger, so one request's OOM or injected fault walks the
  degradation ladder, fails only that request, and evicts only the state it
  dirtied (its table-cache entry, device buffers, and model checkpoint) —
  other in-flight sessions stay bit-identical;
* **graceful drain**: :meth:`RepairServer.begin_drain` (or SIGTERM via
  :func:`install_signal_handlers`) stops admission; :meth:`~RepairServer.
  drain` waits a grace period, then arms each remaining request's scoped
  abort so it stops at the next phase boundary with its phase checkpoints
  on disk (resumable on resubmit), flushes per-request provenance ledgers,
  and tears the plane down.

On the card the degradation ladder's CPU rung is refused (deviation D1):
a request whose faults reach it fails alone, as a structured 500 whose
``kind`` names the fault, and ``resilience.degrade.cpu_refused`` counts it.

The HTTP surface extends the live plane (:mod:`.live`): ``GET /metrics``
(Prometheus, including all ``resilience.*`` and ``serve.*`` series),
``GET /healthz`` (admission state + queue depth), ``GET /report``
(in-flight run report), ``POST /repair`` (a micro-batched repair
request), ``POST /drain``.

A ``/repair`` request body::

    {"table": {"tid": ["0", ...], "c0": [...], ...},   # column -> values
     "row_id": "tid",
     "deadline_s": 30.0,                                # optional
     "options": {"model.max_training_row_num": "64"},   # optional
     "fault_plan": "domain.bucket:1:oom",               # optional (chaos)
     "base_snapshot": "nightly",                        # optional (delta)
     "request_id": "r1"}                                # optional

and the 200 response is ``{"request_id", "status": "ok", "rows",
"frame": [...records...]}`` — ``frame`` rows are sorted by all columns so
two servers repairing the same table respond byte-identically.

``base_snapshot`` names a snapshot under the server cache dir
(``<cache_dir>/snapshots/<id>``) and switches the request onto the
incremental repair plane (:mod:`delphi_tpu_torch.incremental`): the request
diffs its table against that snapshot's manifest, repairs only the delta,
and updates the snapshot for the next request carrying the same id. The
first request under a fresh id runs full and populates it. The id rides
per-request MODEL OPTIONS (not env), so concurrent requests against
different snapshots never race. The response echoes ``base_snapshot``
and, when the delta path ran, an ``incremental`` summary.

A ``"stream": {"id", "seq", "parent_snapshot"}`` field instead switches
the request onto the continuous ingestion plane
(:mod:`delphi_tpu_torch.incremental.stream`): chained deltas accumulate into a
per-stream table under the cache root with a durable commit cursor,
idempotent re-apply, per-stream 429 backpressure with the cursor echoed,
drift-gated background retrains, and ``/drain`` reporting every stream's
resume point before admission closes. Fleets route chained requests by
the chain-root fingerprint so a whole chain stays on (and fails over
with) one home worker.
"""

import hashlib
import json
import os
import queue
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from delphi_tpu_torch.observability import trace as _trace
from delphi_tpu_torch.observability.registry import (
    counter_inc, gauge_set, histogram_observe,
)
from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

_DEF_WORKERS = 2
_DEF_QUEUE_DEPTH = 8
_DEF_DEADLINE_S = 300.0
_DEF_RETRY_AFTER_S = 1.0
_DEF_DRAIN_GRACE_S = 30.0
_DEF_STALL_SHED_S = 120.0
_DEF_FLEET_HEARTBEAT_S = 1.0


def table_fingerprint(table: Dict[str, Any], row_id: str) -> str:
    """Content fingerprint of one /repair request's table. The SINGLE
    definition shared by the server's warm-table cache and the fleet
    router's rendezvous hashing — affinity only works because both sides
    hash the identical blob."""
    blob = json.dumps({"row_id": row_id, "table": table},
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def chain_fingerprint(payload: Dict[str, Any]) -> Optional[str]:
    """Chain-root routing key for chained requests, or None for plain
    ones. A stream's deltas (and a ``base_snapshot`` chain's follow-ups)
    each carry a DIFFERENT table, so hashing the table would scatter the
    chain across the fleet; hashing the chain root (stream id /
    base_snapshot id) pins every link to the rendezvous home whose
    snapshot, cursor, and warm models the chain built."""
    stream = payload.get("stream")
    if isinstance(stream, dict) and stream.get("id"):
        return hashlib.sha1(
            f"stream|{stream['id']}".encode()).hexdigest()
    base = payload.get("base_snapshot")
    if base:
        return hashlib.sha1(f"chain|{base}".encode()).hexdigest()
    return None


def _stream_rows(payload: Dict[str, Any]) -> int:
    """Row count of one delta payload — the unit ``stream.lag_rows``
    (admitted-but-not-yet-durable staleness) is measured in."""
    table = payload.get("table") or {}
    try:
        return max((len(v) for v in table.values()
                    if isinstance(v, (list, tuple))), default=0)
    except TypeError:
        return 0


def write_fleet_registration(fleet_dir: str, path: str,
                             info: Dict[str, Any]) -> None:
    """Writes one worker registration through the durable-store seam
    (site ``store.fleet``): envelope-framed and crash-consistent, so the
    router can never json-parse a half-written announcement. Module-level
    so the store-chaos bench can tear the real writer."""
    from delphi_tpu_torch.parallel import store as dstore
    os.makedirs(fleet_dir, exist_ok=True)
    dstore.write_json(path, info, schema="fleet_reg", site="store.fleet",
                      root=fleet_dir)

#: Counters pre-seeded to zero at server start so the Prometheus endpoint
#: always exposes the full admission/resilience series (a scrape before the
#: first fault must see `delphi_resilience_retries 0`, not a missing metric).
_SEED_COUNTERS = (
    "serve.requests", "serve.accepted", "serve.completed", "serve.failed",
    "serve.shed", "serve.rejected_draining", "serve.deadline_expired",
    "serve.aborted", "serve.handler_timeouts",
    "serve.table_cache.hits", "serve.table_cache.misses",
    "resilience.retries", "resilience.injected",
    "resilience.aborts_requested", "resilience.deadline_expired",
    "resilience.deadline_clipped", "resilience.plan.unmatched",
    "resilience.degrade.shrink", "resilience.degrade.evict",
    "resilience.degrade.cpu_fallback", "resilience.degrade.cpu_refused",
    "resilience.checkpoint.hits", "resilience.checkpoint.misses",
    "resilience.checkpoint.stale", "resilience.checkpoint.corrupt",
    "resilience.checkpoint.saves",
    "resilience.dist.rank_loss", "resilience.dist.collective_timeouts",
    "resilience.dist.single_host_latch", "resilience.dist.mesh_shrunk",
    "resilience.dist.heartbeats",
    "resilience.dist.aggregation_incomplete",
    "escalation.routed", "escalation.escalated",
    "escalation.budget_exhausted",
    "escalation.pattern.induced", "escalation.pattern.attempts",
    "escalation.pattern.repairs",
    "escalation.joint.launches", "escalation.joint.cells",
    "escalation.joint.proposals", "escalation.joint.repairs",
    "escalation.adapter.calls", "escalation.adapter.repairs",
    "escalation.adapter.call_budget_exhausted",
    "launch.plans", "launch.launches", "launch.buckets", "launch.pieces",
    "launch.padded_units", "launch.useful_units", "launch.merged_buckets",
    "launch.plan_cache.hits", "launch.replans",
    "launch.ledger.records", "launch.ledger.flushes",
    "launch.ledger.loads", "launch.ledger.consults",
    "launch.ledger.merge_vetoes",
    "trace.traces", "trace.joins", "trace.spans", "trace.exports",
    "store.writes", "store.reads", "store.misses", "store.legacy",
    "store.corrupt", "store.quarantined", "store.torn_writes",
    "store.gc.sweeps", "store.gc.evicted_files", "store.gc.lock_busy",
    "store.chain_compacted", "resilience.faults.store_corrupt",
    "stream.deltas", "stream.commits", "stream.duplicates",
    "stream.conflicts", "stream.backpressure_429", "stream.commit_retries",
    "stream.recoveries", "stream.retrain.triggers", "stream.retrain.swaps",
    "stream.retrain.failed",
    "gauntlet.scenarios", "gauntlet.scenario_errors",
    "gauntlet.cells_injected", "gauntlet.repairs",
    "gauntlet.repairs_correct",
    "load.requests", "load.answered", "load.ok", "load.failed",
    "load.shed", "load.gave_up", "load.retries",
    "slo.segments", "slo.recovery_violations",
    "autoscale.ticks", "autoscale.up", "autoscale.down",
    "autoscale.blocked_cooldown", "autoscale.blocked_hysteresis",
    "autoscale.blocked_limit",
)


def _knob_float(env: str, conf: str, default: float) -> float:
    from delphi_tpu_torch.parallel.resilience import _env_or_conf
    return _env_or_conf(env, conf, float, default)


def _knob_int(env: str, conf: str, default: int) -> int:
    from delphi_tpu_torch.parallel.resilience import _env_or_conf
    return _env_or_conf(env, conf, int, default)


class Rejection(Exception):
    """An admission refusal carrying its HTTP mapping. ``extra`` merges
    into the response body — stream backpressure echoes the durable
    cursor there, so a 429 tells the client exactly where to resume."""

    def __init__(self, status: int, reason: str,
                 retry_after_s: Optional[float] = None,
                 extra: Optional[Dict[str, Any]] = None) -> None:
        self.status = int(status)
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.extra = extra or {}
        super().__init__(reason)


class RepairJob:
    """One admitted /repair request moving through the queue → worker →
    response pipeline. ``done`` is the handler's rendezvous; ``scope`` is
    set by the worker so drain/abandonment can arm a scoped abort."""

    def __init__(self, request_id: str, payload: Dict[str, Any],
                 deadline_at: Optional[float]) -> None:
        self.request_id = request_id
        self.payload = payload
        self.deadline_at = deadline_at  # time.monotonic() basis
        self.enqueued_at = time.perf_counter()
        self.fp: Optional[str] = None  # table fingerprint once resolved
        self.scope: Optional[Any] = None
        self.status_code: int = 500
        self.response: Dict[str, Any] = {"request_id": request_id,
                                         "status": "error",
                                         "error": "not executed"}
        self.abandoned = False
        self.done = threading.Event()

    def remaining_s(self) -> Optional[float]:
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()


class RepairServer:
    """The persistent repair service. Lifecycle: ``start()`` →
    (requests...) → ``drain()`` (or ``stop()`` for an immediate teardown).
    ``port`` is the bound HTTP port (pass 0 for ephemeral — tests)."""

    def __init__(self, port: int = 0, workers: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 cache_dir: Optional[str] = None,
                 fleet_dir: Optional[str] = None,
                 worker_id: Optional[str] = None) -> None:
        self.requested_port = int(port)
        self.workers = workers if workers is not None else _knob_int(
            "DELPHI_SERVE_WORKERS", "repair.serve.workers", _DEF_WORKERS)
        self.workers = max(1, int(self.workers))
        depth = queue_depth if queue_depth is not None else _knob_int(
            "DELPHI_SERVE_QUEUE_DEPTH", "repair.serve.queue_depth",
            _DEF_QUEUE_DEPTH)
        self.queue_depth = max(1, int(depth))
        cache = cache_dir or os.environ.get("DELPHI_SERVE_CACHE_DIR")
        if not cache:
            from delphi_tpu_torch.session import get_session
            cache = get_session().conf.get("repair.serve.cache_dir")
        # a stable cache dir is what makes restart warm (model checkpoints,
        # phase checkpoints, compile cache all live under it); the tempdir
        # default still gives warmth within one server lifetime
        self.cache_dir = str(cache) if cache else tempfile.mkdtemp(
            prefix="delphi_serve_")
        self.default_deadline_s = _knob_float(
            "DELPHI_SERVE_DEADLINE_S", "repair.serve.deadline_s",
            _DEF_DEADLINE_S)
        self.retry_after_s = _knob_float(
            "DELPHI_SERVE_RETRY_AFTER_S", "repair.serve.retry_after_s",
            _DEF_RETRY_AFTER_S)
        self.drain_grace_s = _knob_float(
            "DELPHI_SERVE_DRAIN_GRACE_S", "repair.serve.drain_grace_s",
            _DEF_DRAIN_GRACE_S)
        self.max_rss_gb = _knob_float(
            "DELPHI_SERVE_MAX_RSS_GB", "repair.serve.max_rss_gb", 0.0)
        self.stall_shed_s = _knob_float(
            "DELPHI_SERVE_STALL_SHED_S", "repair.serve.stall_shed_s",
            _DEF_STALL_SHED_S)
        # fleet membership seam (observability/fleet.py): when armed, the
        # worker registers itself under the shared fleet dir and keeps a
        # liveness heartbeat the router's membership scan reads
        fleet = fleet_dir or os.environ.get("DELPHI_FLEET_DIR")
        self.fleet_dir = str(fleet) if fleet else None
        wid = (worker_id if worker_id is not None
               else os.environ.get("DELPHI_FLEET_WORKER_ID"))
        self.worker_id = str(wid) if wid is not None else None
        self.fleet_heartbeat_s = _knob_float(
            "DELPHI_FLEET_HEARTBEAT_S", "repair.fleet.heartbeat_s",
            _DEF_FLEET_HEARTBEAT_S)
        self._fleet_thread: Optional[threading.Thread] = None
        self._fleet_stop: Optional[threading.Event] = None

        self.recorder: Optional[Any] = None
        self._own_recorder: Optional[Any] = None
        self._queue: "queue.Queue[Optional[RepairJob]]" = queue.Queue(
            maxsize=self.queue_depth)
        self._workers: List[threading.Thread] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._draining = False
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._in_flight = 0
        self._active: Dict[str, RepairJob] = {}
        # table fingerprint -> (catalog name, EncodedTable)
        self._tables: Dict[str, Tuple[str, Any]] = {}
        # chained delta ingestion (incremental/stream.py) — built in
        # start() once the cache dir exists
        self.streams: Optional[Any] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def _models_dir(self, fp: str) -> str:
        return os.path.join(self.cache_dir, "models", fp[:16])

    def _ckpt_dir(self, fp: str) -> str:
        return os.path.join(self.cache_dir, "ckpt", fp[:16])

    def _snapshot_dir(self, snapshot_id: str) -> str:
        """Maps a client-supplied ``base_snapshot`` id onto the server
        cache; ids are restricted to a filename-safe alphabet so a request
        body can never escape ``<cache_dir>/snapshots/``."""
        if not snapshot_id or len(snapshot_id) > 64 or \
                not all(c.isalnum() or c in "._-" for c in snapshot_id) \
                or snapshot_id.startswith("."):
            raise ValueError(
                f"bad base_snapshot id {snapshot_id!r}: expected 1-64 "
                "chars from [A-Za-z0-9._-], not starting with '.'")
        return os.path.join(self.cache_dir, "snapshots", snapshot_id)

    def start(self) -> "RepairServer":
        from delphi_tpu_torch import observability as obs

        os.makedirs(self.cache_dir, exist_ok=True)
        # arm the kernel library's build cache under the serve cache dir
        # unless one is already configured: a restarted server, and every
        # fleet worker sharing the cache root, loads the library built there
        if not os.environ.get("DELPHI_COMPILE_CACHE_DIR"):
            os.environ["DELPHI_COMPILE_CACHE_DIR"] = os.path.join(
                self.cache_dir, "compile")
        # arm the launch-plan store next to it: plans persist per table
        # fingerprint, so a warm request skips replanning and the compile
        # plane prewarms exactly the variants the stored plan will launch
        from delphi_tpu_torch.parallel import planner
        planner.set_plan_store(os.path.join(self.cache_dir, "plans"))
        # one long-lived recorder for the server's whole life: per-request
        # model.run() recorders nest into it (start_recording returns None
        # when one is active), so every request's metrics land in ONE
        # registry served by /metrics
        self._own_recorder = obs.start_recording("repair.serve")
        self.recorder = self._own_recorder or obs.current_recorder()
        if self.recorder is None:  # pragma: no cover - defensive
            raise RuntimeError("serving plane requires a run recorder")
        for name in _SEED_COUNTERS:
            counter_inc(name, 0)
        gauge_set("serve.queue_depth", 0)
        gauge_set("serve.in_flight", 0)
        gauge_set("serve.shed_ratio", 0)
        gauge_set("serve.draining", 0)
        gauge_set("stream.lag_rows", 0)
        gauge_set("stream.active", 0)
        gauge_set("stream.recovering", 0)
        gauge_set("gauntlet.mean_f1", 0)
        gauge_set("gauntlet.mean_gap_closed", 0)
        from delphi_tpu_torch.incremental.stream import StreamManager
        self.streams = StreamManager(
            os.path.join(self.cache_dir, "streams"),
            store_root=self.cache_dir)
        self._rebuild_warm_state()

        for i in range(self.workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"delphi-serve-worker-{i}")
            t.start()
            self._workers.append(t)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.requested_port),
                                          _ServeHandler)
        self._httpd.daemon_threads = True
        self._httpd.repair_server = self  # type: ignore[attr-defined]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="delphi-serve-http")
        self._http_thread.start()
        self._register_fleet_worker()
        from delphi_tpu_torch.observability import live as _live
        _live.register_sample_hook(self._sample_admission)
        _logger.info(
            f"repair service listening on 127.0.0.1:{self.port} "
            f"(workers={self.workers}, queue={self.queue_depth}, "
            f"cache={self.cache_dir})")
        return self

    # -- fleet membership ----------------------------------------------------

    def _fleet_registration_path(self) -> Optional[str]:
        if not self.fleet_dir or self.worker_id is None:
            return None
        return os.path.join(self.fleet_dir, f"worker_{self.worker_id}.json")

    def _register_fleet_worker(self) -> None:
        """Announces this worker to the fleet router: an atomic
        registration file (the bound ephemeral port — the one fact the
        router cannot know before spawn) plus a heartbeat-refreshed
        liveness file, the same file format the dist-resilience plane
        uses for rank diagnosis."""
        reg = self._fleet_registration_path()
        if reg is None:
            return
        from delphi_tpu_torch.parallel import dist_resilience as dr

        info = {"worker_id": self.worker_id, "port": self.port,
                "pid": os.getpid(), "cache_dir": self.cache_dir,
                "started": float(time.time())}
        write_fleet_registration(self.fleet_dir, reg, info)
        live = dr.member_liveness_path(self.fleet_dir, self.worker_id)
        dr.touch_liveness_file(live)
        stop = threading.Event()
        interval = max(0.05, float(self.fleet_heartbeat_s))

        def _beat() -> None:
            while not stop.wait(interval):
                dr.touch_liveness_file(live)
                # a quarantined (corrupt) registration reads as
                # not-yet-registered at the router; re-announce so the
                # worker rejoins the ring instead of serving invisibly
                if not os.path.exists(reg):
                    try:
                        write_fleet_registration(self.fleet_dir, reg, info)
                    except OSError as e:
                        _logger.warning(
                            f"fleet re-registration failed: {e}")

        t = threading.Thread(target=_beat, daemon=True,
                             name="delphi-fleet-heartbeat")
        t.start()
        self._fleet_stop, self._fleet_thread = stop, t
        _logger.info(f"fleet worker {self.worker_id} registered in "
                     f"{self.fleet_dir} (port {self.port})")

    def unregister_fleet_worker(self) -> None:
        """Drops this worker out of fleet membership: stops the
        heartbeat, then removes the liveness and registration files so
        the router's next membership scan routes around it. Idempotent;
        a no-op outside a fleet."""
        reg = self._fleet_registration_path()
        if reg is None:
            return
        if self._fleet_stop is not None:
            self._fleet_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=5.0)
            self._fleet_thread = None
        from delphi_tpu_torch.parallel import dist_resilience as dr
        live = dr.member_liveness_path(self.fleet_dir, self.worker_id)
        for path in (live, reg):
            try:
                os.remove(path)
            except OSError:
                pass
        _logger.info(f"fleet worker {self.worker_id} unregistered")

    def _rebuild_warm_state(self) -> None:
        """Crash-safe warm-state inventory on (re)start: count the model
        checkpoints and phase checkpoints a previous life left under the
        cache dir. They are loaded lazily — the fingerprinted stores
        validate on first use — so a restart is warm without trusting any
        in-memory state that died with the old process."""
        def _count(sub: str) -> int:
            d = os.path.join(self.cache_dir, sub)
            try:
                return len([e for e in os.listdir(d)
                            if os.path.isdir(os.path.join(d, e))
                            or e.endswith(".pkl")])
            except OSError:
                return 0
        models = _count("models")
        ckpts = _count("ckpt")
        try:
            # ledger.<fp>.json launch-cost ledgers live beside the plans
            # but are not plans
            plans = len([e for e in os.listdir(
                os.path.join(self.cache_dir, "plans"))
                if e.endswith(".json") and not e.startswith("ledger.")])
        except OSError:
            plans = 0
        gauge_set("serve.warm_models", models)
        gauge_set("serve.warm_checkpoints", ckpts)
        gauge_set("serve.warm_plans", plans)
        if models or ckpts:
            _logger.info(f"warm-state rebuild: {models} model checkpoint "
                         f"dir(s), {ckpts} phase-checkpoint dir(s) under "
                         f"{self.cache_dir}")

    def begin_drain(self) -> None:
        """Stops admission; in-flight and queued work keeps running.
        Under a fleet, membership is dropped FIRST — the router must stop
        sending new work here (its next scan sees the liveness file gone)
        before admission closes, otherwise every request routed during
        the drain window eats a 503 hop instead of landing on a live
        replica directly."""
        with self._lock:
            if self._draining:
                return
        self.unregister_fleet_worker()
        with self._lock:
            self._draining = True
        gauge_set("serve.draining", 1)
        _logger.info("repair service draining: admission closed")

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Graceful shutdown: close admission, give in-flight requests
        ``grace_s`` to finish, then arm each straggler's scoped abort so it
        stops at the next guarded seam / phase boundary — its phase
        checkpoints (written at every completed phase) stay on disk, so a
        resubmitted identical request resumes instead of recomputing.
        Finally tears down workers, HTTP, and the recorder."""
        self.begin_drain()
        grace = self.drain_grace_s if grace_s is None else float(grace_s)
        deadline = time.monotonic() + max(0.0, grace)
        while time.monotonic() < deadline:
            with self._lock:
                idle = self._in_flight == 0 and self._queue.empty()
            if idle:
                break
            time.sleep(0.05)
        with self._lock:
            stragglers = list(self._active.values())
        for job in stragglers:
            if job.scope is not None:
                job.scope.request_abort("server draining")
        if stragglers:
            _logger.warning(
                f"drain grace expired: aborting {len(stragglers)} in-flight "
                "request(s) at their next checkpoint boundary")
            # give the aborts a moment to land at a seam
            settle = time.monotonic() + 10.0
            while time.monotonic() < settle:
                with self._lock:
                    if self._in_flight == 0:
                        break
                time.sleep(0.05)
        self.stop()

    def stop(self) -> None:
        """Immediate teardown (drain() calls this last)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        from delphi_tpu_torch.observability import live as _live
        _live.unregister_sample_hook(self._sample_admission)
        self.unregister_fleet_worker()
        for _ in self._workers:
            try:
                self._queue.put_nowait(None)
            except queue.Full:  # drop a queued job slot to fit the sentinel
                try:
                    dropped = self._queue.get_nowait()
                    if dropped is not None:
                        dropped.status_code = 503
                        dropped.response = {
                            "request_id": dropped.request_id,
                            "status": "rejected",
                            "error": "server shutting down"}
                        dropped.done.set()
                except queue.Empty:
                    pass
                self._queue.put_nowait(None)
        for t in self._workers:
            t.join(timeout=10.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._http_thread is not None:
                self._http_thread.join(timeout=10.0)
            self._httpd = None
        if self._own_recorder is not None:
            from delphi_tpu_torch import observability as obs
            obs.stop_recording(self._own_recorder)
            self._own_recorder = None
        # disarm the plan store armed at start() — but only if it is still
        # OURS: a later-started server (warm restart on another cache dir)
        # must keep its own store
        from delphi_tpu_torch.parallel import planner
        store = planner.get_plan_store()
        if store is not None and \
                store.root == os.path.join(self.cache_dir, "plans"):
            planner.set_plan_store(None)
        _logger.info("repair service stopped")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Blocks until the server is stopped (main.py --serve)."""
        return self._stopped.wait(timeout)

    # -- admission -----------------------------------------------------------

    def _sample_admission(self) -> None:
        """Re-samples the admission gauges outside the request path —
        registered with the live plane's resource sampler so a /metrics
        scrape on an idle (or wedged) server still reflects the current
        queue, not the last request's view. Also the one place
        ``serve.shed_ratio`` is derived from its component counters."""
        from delphi_tpu_torch.observability.registry import counter_value
        gauge_set("serve.queue_depth", self._queue.qsize())
        with self._lock:
            gauge_set("serve.in_flight", self._in_flight)
        requests = counter_value("serve.requests")
        if requests > 0:
            gauge_set("serve.shed_ratio",
                      round(counter_value("serve.shed") / requests, 6))

    def submit(self, payload: Dict[str, Any]) -> RepairJob:
        """Admission control: draining → 503, overload (RSS / wedged
        heartbeat / full queue) → 429 with Retry-After. Returns the queued
        job; the caller waits on ``job.done``."""
        counter_inc("serve.requests")
        with self._lock:
            draining = self._draining
        if draining or self._stopped.is_set():
            counter_inc("serve.rejected_draining")
            raise Rejection(503, "server is draining",
                            retry_after_s=self.retry_after_s)
        if self.max_rss_gb > 0:
            from delphi_tpu_torch.observability.live import _rss_gb
            rss = _rss_gb()
            if rss is not None and rss > self.max_rss_gb:
                counter_inc("serve.shed")
                self._sample_admission()
                raise Rejection(
                    429, f"process RSS {rss:.2f} GiB over the "
                         f"{self.max_rss_gb:.2f} GiB admission limit",
                    retry_after_s=self.retry_after_s)
        if self.stall_shed_s > 0 and self.recorder is not None:
            with self._lock:
                busy = self._in_flight > 0
            idle = time.perf_counter() - self.recorder.last_transition
            if busy and idle > self.stall_shed_s:
                counter_inc("serve.shed")
                self._sample_admission()
                raise Rejection(
                    429, f"in-flight work wedged ({idle:.0f}s without a "
                         "span heartbeat)",
                    retry_after_s=self.retry_after_s)
        request_id = str(payload.get("request_id")
                         or f"req-{time.monotonic_ns():x}")
        deadline_s = payload.get("deadline_s", self.default_deadline_s)
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise Rejection(400, f"bad deadline_s: {deadline_s!r}")
        deadline_at = (time.monotonic() + deadline_s
                       if deadline_s > 0 else None)
        stream_req = payload.get("stream")
        if stream_req is not None:
            # per-stream backpressure BEFORE the shared queue: a stream
            # past its in-flight bound gets 429 + the durable cursor so
            # it resumes exactly where the server is, instead of queuing
            # deltas the chain cannot admit yet
            from delphi_tpu_torch.incremental.stream import StreamBusy
            if not isinstance(stream_req, dict) or not stream_req.get("id"):
                raise Rejection(400, "stream must be an object with an "
                                     "'id' and a 'seq'")
            try:
                self.streams.admit(stream_req["id"], _stream_rows(payload),
                                   retry_after_s=self.retry_after_s)
            except StreamBusy as b:
                raise Rejection(
                    429, f"stream {b.stream_id} backpressure: "
                         "in-flight delta bound reached",
                    retry_after_s=b.retry_after_s,
                    extra={"cursor": b.cursor})
            except ValueError as e:
                raise Rejection(400, str(e))
        job = RepairJob(request_id, payload, deadline_at)
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            if stream_req is not None:
                self.streams.release(stream_req.get("id"),
                                     _stream_rows(payload))
            counter_inc("serve.shed")
            self._sample_admission()
            raise Rejection(429, "admission queue full",
                            retry_after_s=self.retry_after_s)
        counter_inc("serve.accepted")
        gauge_set("serve.queue_depth", self._queue.qsize())
        return job

    # -- execution -----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            gauge_set("serve.queue_depth", self._queue.qsize())
            histogram_observe("serve.queue_wait_seconds",
                              time.perf_counter() - job.enqueued_at)
            with self._lock:
                self._in_flight += 1
                self._active[job.request_id] = job
            gauge_set("serve.in_flight", self._in_flight)
            try:
                self._execute(job)
            except BaseException as e:  # a worker must survive anything
                _logger.warning(
                    f"request {job.request_id}: unhandled "
                    f"{type(e).__name__}: {e}")
                job.status_code = 500
                job.response = {"request_id": job.request_id,
                                "status": "error",
                                "error": f"{type(e).__name__}: {e}"}
            finally:
                with self._lock:
                    self._in_flight -= 1
                    self._active.pop(job.request_id, None)
                gauge_set("serve.in_flight", self._in_flight)
                job.done.set()

    def _resolve_table(self, payload: Dict[str, Any]) -> Tuple[str, str]:
        """Warm table cache: encode + validate once per content
        fingerprint, register the EncodedTable in the session catalog
        (device-resident code buffers then persist on its column objects
        across requests)."""
        import pandas as pd

        from delphi_tpu_torch.session import get_session
        from delphi_tpu_torch.table import check_input_table

        table = payload["table"]
        row_id = payload["row_id"]
        fp = table_fingerprint(table, row_id)
        with self._lock:
            cached = self._tables.get(fp)
        if cached is not None:
            counter_inc("serve.table_cache.hits")
            return cached[0], fp
        name = f"serve_{fp[:16]}"
        df = pd.DataFrame({c: pd.Series(v) for c, v in table.items()})
        encoded, _cont = check_input_table(df, row_id, name)
        get_session().register(name, encoded)
        with self._lock:
            self._tables[fp] = (name, encoded)
            n = len(self._tables)
        counter_inc("serve.table_cache.misses")
        gauge_set("serve.warm_tables", n)
        return name, fp

    def _evict_dirty(self, fp: Optional[str],
                     request_id: Optional[str] = None) -> None:
        """Drops ONLY the state a failed request dirtied: its device-
        resident code buffers (a device fault may have corrupted them;
        evicting is always safe — the next use re-uploads ground truth
        bit-identically), its fingerprint cache entry (so the next request
        re-validates and re-registers), and its per-fingerprint model
        checkpoint. Other fingerprints' warm state is untouched. The
        session-catalog entry — host-side encoded data a device fault
        cannot dirty — stays, so a concurrent request on the same table
        that already resolved the name keeps running unharmed."""
        if fp is None:
            return
        import shutil

        from delphi_tpu_torch.ops.xfer import evict_device_codes

        with self._lock:
            entry = self._tables.pop(fp, None)
            n = len(self._tables)
        if entry is not None:
            _name, encoded = entry
            try:
                evict_device_codes(encoded.columns)
            except Exception:  # pragma: no cover - eviction is best-effort
                pass
            gauge_set("serve.warm_tables", n)
        shutil.rmtree(self._models_dir(fp), ignore_errors=True)

    def _execute(self, job: RepairJob) -> None:
        """Trace envelope around one request: continues the caller's
        trace (the ``X-Delphi-Trace`` header the handler parsed into the
        payload) or mints a fresh one when ``DELPHI_TRACE_DIR`` is armed,
        stamps the response with the trace id, and flushes any launch
        costs this request recorded to the persisted ledger."""
        parsed = job.payload.get("_trace") or (None, None)
        with _trace.request_scope(parsed[0], parsed[1]) as tctx:
            try:
                self._execute_traced(job)
            finally:
                if tctx is not None and isinstance(job.response, dict):
                    job.response.setdefault("trace_id", tctx.trace_id)
                _trace.flush_ledger()

    def _execute_traced(self, job: RepairJob) -> None:
        if job.payload.get("stream") is not None:
            self._execute_stream(job)
            return
        from delphi_tpu_torch.api import Delphi
        from delphi_tpu_torch.errors import NullErrorDetector
        from delphi_tpu_torch.observability import provenance
        from delphi_tpu_torch.parallel import resilience

        t0 = time.perf_counter()
        rid = job.request_id
        payload = job.payload
        fp: Optional[str] = None
        ledger: Optional[Any] = None
        try:
            rem = job.remaining_s()
            if rem is not None and rem <= 0:
                raise resilience.DeadlineExceeded(
                    f"request {rid} deadline expired after "
                    f"{-rem:.3f}s in the admission queue")
            name, fp = self._resolve_table(payload)
            job.fp = fp
            model = Delphi.getOrCreate().repair \
                .setTableName(name) \
                .setRowId(payload["row_id"]) \
                .setErrorDetectors([NullErrorDetector()])
            model.option("model.checkpoint_path", self._models_dir(fp))
            for key, value in (payload.get("options") or {}).items():
                model.option(str(key), str(value))
            base_snapshot = payload.get("base_snapshot")
            if base_snapshot is not None:
                # per-request model options, NOT env: concurrent requests
                # against different snapshots must not race a global flag
                snap_dir = self._snapshot_dir(str(base_snapshot))
                os.makedirs(snap_dir, exist_ok=True)
                model.option("repair.incremental", "true")
                model.option("repair.snapshot.dir", snap_dir)
            prov_dir = os.environ.get("DELPHI_SERVE_PROVENANCE_DIR")
            if prov_dir:
                os.makedirs(prov_dir, exist_ok=True)
                ledger = provenance.ProvenanceLedger(
                    os.path.join(prov_dir, f"{rid}.jsonl"))
            scope = resilience.RequestScope(
                rid, fault_plan=str(payload.get("fault_plan") or ""),
                deadline_s=rem, checkpoint_dir=self._ckpt_dir(fp))
            job.scope = scope
            from delphi_tpu_torch.parallel import planner
            with resilience.request_scope(scope), \
                    provenance.scoped_ledger(ledger), \
                    planner.plan_fingerprint(fp):
                out = model.run()
            # canonical response ordering: sorted by all columns, so two
            # servers (or a solo run) repairing the same table respond
            # byte-identically regardless of internal work order
            out = out.sort_values(list(out.columns)).reset_index(drop=True)
            job.status_code = 200
            job.response = {
                "request_id": rid, "status": "ok", "rows": int(len(out)),
                "frame": json.loads(out.to_json(orient="records")),
            }
            if base_snapshot is not None:
                job.response["base_snapshot"] = str(base_snapshot)
                job.response["incremental"] = getattr(
                    model, "_last_incremental", None)
            # per-request escalation rides the generic options loop above
            # (repair.escalate / .conf / .budget / .adapter); echo the
            # summary so the caller sees what was routed and escalated
            esc_summary = getattr(model, "_last_escalation", None)
            if esc_summary is not None:
                job.response["escalation"] = esc_summary
            counter_inc("serve.completed")
        except resilience.DeadlineExceeded as e:
            counter_inc("serve.deadline_expired")
            job.status_code = 504
            job.response = {"request_id": rid, "status": "deadline_exceeded",
                            "error": str(e)}
        except resilience.RunAborted as e:
            # drain-time abort: phase checkpoints for every completed phase
            # are already on disk under the request's checkpoint dir
            counter_inc("serve.aborted")
            job.status_code = 503
            job.response = {
                "request_id": rid, "status": "aborted", "error": str(e),
                "resumable": fp is not None
                and os.path.isdir(self._ckpt_dir(fp)),
            }
        except KeyError as e:
            job.status_code = 400
            job.response = {"request_id": rid, "status": "bad_request",
                            "error": f"missing field {e}"}
        except BaseException as e:
            # one request's failure — injected fault, OOM past the ladder,
            # bad options, a genuine bug — is THAT request's structured
            # error; evict only the warm state it dirtied
            counter_inc("serve.failed")
            kind = resilience.classify_fault(e)
            if isinstance(e, resilience.FaultInjected):
                kind = e.kind
            job.status_code = 400 if isinstance(e, ValueError) else 500
            job.response = {"request_id": rid, "status": "error",
                            "kind": kind or type(e).__name__,
                            "error": f"{type(e).__name__}: {e}"}
            self._evict_dirty(fp, request_id=rid)
        finally:
            if ledger is not None:
                try:
                    ledger.write()
                except Exception as e:  # pragma: no cover - best effort
                    _logger.warning(f"request {rid}: provenance flush "
                                    f"failed: {e}")
            histogram_observe("serve.request_seconds",
                              time.perf_counter() - t0)

    def stream_cursors(self) -> Dict[str, Any]:
        """Durable resume points for every stream under the cache root —
        what /drain reports before closing admission."""
        if self.streams is None:
            return {}
        return self.streams.durable_cursors()

    def _execute_stream(self, job: RepairJob) -> None:
        """One chained stream delta: accumulate → incremental repair
        against the per-stream snapshot → durable cursor commit —
        serialized per stream by the session lock, idempotent under
        re-dispatch, with the background retrain hooked in. The admission
        slot taken in submit() is released here whatever happens."""
        from delphi_tpu_torch.api import Delphi
        from delphi_tpu_torch.errors import NullErrorDetector
        from delphi_tpu_torch.incremental.stream import StreamCommitError
        from delphi_tpu_torch.observability import provenance
        from delphi_tpu_torch.parallel import resilience

        import pandas as pd

        t0 = time.perf_counter()
        rid = job.request_id
        payload = job.payload
        stream_req = payload["stream"]
        sid = str(stream_req.get("id"))
        rows = _stream_rows(payload)
        sess = None
        ledger: Optional[Any] = None
        try:
            rem = job.remaining_s()
            if rem is not None and rem <= 0:
                raise resilience.DeadlineExceeded(
                    f"request {rid} deadline expired after "
                    f"{-rem:.3f}s in the admission queue")
            sess = self.streams.session(sid)
            row_id = payload["row_id"]
            delta_df = pd.DataFrame(
                {c: pd.Series(v) for c, v in payload["table"].items()})
            chain_fp = chain_fingerprint(payload) or "stream"
            job.fp = chain_fp

            def _repair_model(name: str, incremental: bool,
                              snap_dir: Optional[str]) -> Any:
                model = Delphi.getOrCreate().repair \
                    .setTableName(name) \
                    .setRowId(row_id) \
                    .setErrorDetectors([NullErrorDetector()])
                model.option("model.checkpoint_path",
                             self._models_dir(chain_fp))
                for key, value in (payload.get("options") or {}).items():
                    model.option(str(key), str(value))
                if incremental:
                    model.option("repair.incremental", "true")
                    model.option("repair.snapshot.dir", snap_dir)
                return model

            def _registered(name: str, frame: Any) -> str:
                from delphi_tpu_torch.session import get_session
                from delphi_tpu_torch.table import check_input_table
                encoded, _cont = check_input_table(frame, row_id, name)
                get_session().register(name, encoded)
                return name

            def run_fn(accumulated: Any, snap_dir: str, seq: int
                       ) -> Tuple[Any, Optional[Dict[str, Any]]]:
                from delphi_tpu_torch.session import get_session
                name = _registered(f"stream_{sid[:16]}_{seq}", accumulated)
                try:
                    os.makedirs(snap_dir, exist_ok=True)
                    model = _repair_model(name, True, snap_dir)
                    out = model.run()
                    # canonical ordering, same as the batch path: any
                    # replica (or a solo batch run) answers byte-identically
                    out = out.sort_values(
                        list(out.columns)).reset_index(drop=True)
                    return out, getattr(model, "_last_incremental", None)
                finally:
                    get_session().drop(name)

            # snapshot the request's trace position NOW: the retrain runs
            # later on its own thread, and adopt() joins its spans under
            # the request span that triggered it — one coherent trace
            trace_snap = _trace.capture()

            def retrain_fn(accumulated: Any) -> Dict[str, Any]:
                from delphi_tpu_torch.session import get_session
                with _trace.adopt(trace_snap):
                    name = _registered(f"stream_{sid[:16]}_retrain",
                                       accumulated)
                    try:
                        model = _repair_model(name, False, None)
                        model.run()
                        return dict(
                            getattr(model, "_last_models", None) or [])
                    finally:
                        get_session().drop(name)

            # the delta splice stamps per-cell reused/recomputed decisions
            # into the chain's provenance: a per-request ledger (file under
            # DELPHI_SERVE_PROVENANCE_DIR, else in-memory) keeps those
            # stamps isolated from every other session in this process —
            # the process-global ledger would already hold other requests'
            # cells and silently swallow the splice
            prov_dir = os.environ.get("DELPHI_SERVE_PROVENANCE_DIR")
            if prov_dir:
                os.makedirs(prov_dir, exist_ok=True)
                ledger = provenance.ProvenanceLedger(
                    os.path.join(prov_dir, f"{rid}.jsonl"))
            else:
                ledger = provenance.ProvenanceLedger(provenance.MEMORY_PATH)
            scope = resilience.RequestScope(
                rid, fault_plan=str(payload.get("fault_plan") or ""),
                deadline_s=rem, checkpoint_dir=self._ckpt_dir(chain_fp))
            job.scope = scope
            with resilience.request_scope(scope), \
                    provenance.scoped_ledger(ledger):
                status, body = sess.apply(
                    stream_req.get("seq"),
                    stream_req.get("parent_snapshot"),
                    delta_df, run_fn, retrain_fn=retrain_fn)
            frame = body.pop("frame_df", None)
            if frame is not None:
                body["rows"] = int(len(frame))
                body["frame"] = json.loads(frame.to_json(orient="records"))
            body["request_id"] = rid
            job.status_code = status
            job.response = body
            counter_inc("serve.completed" if status == 200
                        else "serve.failed")
        except resilience.DeadlineExceeded as e:
            counter_inc("serve.deadline_expired")
            job.status_code = 504
            job.response = {"request_id": rid,
                            "status": "deadline_exceeded", "error": str(e)}
        except resilience.RunAborted as e:
            counter_inc("serve.aborted")
            job.status_code = 503
            job.response = {
                "request_id": rid, "status": "aborted", "error": str(e),
                "resumable": True,
                "cursor": sess.durable_cursor() if sess else None}
        except StreamCommitError as e:
            # NOT acknowledged: the client resends from the echoed cursor
            counter_inc("serve.failed")
            job.status_code = 503
            job.response = {
                "request_id": rid, "status": "error",
                "kind": "store_corrupt", "error": str(e),
                "cursor": sess.durable_cursor() if sess else None}
        except KeyError as e:
            job.status_code = 400
            job.response = {"request_id": rid, "status": "bad_request",
                            "error": f"missing field {e}"}
        except BaseException as e:
            counter_inc("serve.failed")
            kind = resilience.classify_fault(e)
            if isinstance(e, resilience.FaultInjected):
                kind = e.kind
            job.status_code = 400 if isinstance(e, ValueError) else 500
            job.response = {
                "request_id": rid, "status": "error",
                "kind": kind or type(e).__name__,
                "error": f"{type(e).__name__}: {e}",
                "cursor": sess.durable_cursor() if sess else None}
        finally:
            if ledger is not None and ledger.path != provenance.MEMORY_PATH:
                try:
                    ledger.write()
                except Exception as e:  # pragma: no cover - best effort
                    _logger.warning(f"request {rid}: provenance flush "
                                    f"failed: {e}")
            self.streams.release(sid, rows)
            histogram_observe("serve.request_seconds",
                              time.perf_counter() - t0)


class _ServeHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:
        _logger.debug("repair service: " + fmt % args)

    @property
    def _server(self) -> RepairServer:
        return self.server.repair_server  # type: ignore[attr-defined]

    def _respond(self, status: int, body: Dict[str, Any],
                 retry_after_s: Optional[float] = None,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, Any]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if retry_after_s is not None:
            self.send_header("Retry-After",
                             str(max(1, int(round(retry_after_s)))))
        for key, value in (headers or {}).items():
            self.send_header(key, str(value))
        self.end_headers()
        self.wfile.write(data)

    def _respond_text(self, status: int, content_type: str,
                      body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        from delphi_tpu_torch.observability.live import (
            PROMETHEUS_CONTENT_TYPE, render_prometheus,
        )

        srv = self._server
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                from delphi_tpu_torch.parallel import store as dstore
                quarantined = dstore.quarantine_count(srv.cache_dir)
                recovering = (srv.streams.recovering_count()
                              if srv.streams is not None else 0)
                with srv._lock:
                    # a stream in recovery replay is serving from state
                    # rebuilt off disk that no commit has confirmed yet —
                    # degraded until its next delta lands
                    status = "draining" if srv._draining else \
                        ("degraded" if quarantined or recovering
                         else "ok")
                    body = {
                        "status": status,
                        "in_flight": srv._in_flight,
                        "queue_depth": srv._queue.qsize(),
                        "warm_tables": len(srv._tables),
                        "workers": srv.workers,
                        "quarantined": quarantined,
                        "streams": {
                            "active": (srv.streams.active_count()
                                       if srv.streams is not None else 0),
                            "recovering": recovering,
                            "lag_rows": (srv.streams.lag_rows()
                                         if srv.streams is not None
                                         else 0),
                        },
                    }
                self._respond(200, body)
            elif path == "/metrics":
                text = render_prometheus(srv.recorder).encode()
                self._respond_text(200, PROMETHEUS_CONTENT_TYPE, text)
            elif path == "/report":
                from delphi_tpu_torch.observability.report import (
                    build_run_report,
                )
                report = build_run_report(srv.recorder, run={},
                                          status="serving", error=None)
                self._respond(200, report)
            elif path.startswith("/trace/"):
                doc = _trace.load_trace(path[len("/trace/"):])
                if doc is None:
                    self._respond(404, {
                        "error": "no such trace under "
                                 f"{_trace.trace_root() or '<unset>'}"})
                else:
                    self._respond(200, doc)
            else:
                self._respond(404, {"error": f"unknown path {path}"})
        except Exception as e:  # pragma: no cover - defensive
            try:
                self._respond(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    def do_POST(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        srv = self._server
        path = self.path.split("?", 1)[0]
        try:
            if path == "/drain":
                # cursors FIRST, response SECOND, admission closed LAST:
                # the drain reply must carry every stream's durable
                # resume point before a single delta can be refused, so
                # a mid-stream drain never strands a chain without a
                # resume point (ordering pinned by a spy test)
                cursors = srv.stream_cursors()
                self._respond(200, {"status": "draining",
                                    "resumable": True,
                                    "streams": cursors})
                srv.begin_drain()
                return
            if path != "/repair":
                self._respond(404, {"error": f"unknown path {path}"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._respond(400, {"status": "bad_request",
                                    "error": f"bad JSON body: {e}"})
                return
            if not isinstance(payload, dict) \
                    or not isinstance(payload.get("table"), dict) \
                    or not isinstance(payload.get("row_id"), str):
                self._respond(400, {
                    "status": "bad_request",
                    "error": "body must be a JSON object with a 'table' "
                             "object and a 'row_id' string"})
                return
            # continue the caller's trace: the router (or a client) hands
            # us its position via X-Delphi-Trace; the worker thread joins
            # it in _execute's request scope
            tid, parent = _trace.parse_header(
                self.headers.get(_trace.TRACE_HEADER))
            if tid is not None:
                payload["_trace"] = (tid, parent)
            try:
                job = srv.submit(payload)
            except Rejection as r:
                body = {"status": "rejected", "error": r.reason}
                body.update(r.extra)
                self._respond(r.status, body,
                              retry_after_s=r.retry_after_s)
                return
            # rendezvous: the worker's deadline machinery normally answers
            # well before this backstop; the +grace covers a request wedged
            # between guarded seams, and abandoning it arms a scoped abort
            # so the worker is reclaimed at the next seam
            rem = job.remaining_s()
            wait_s = None if rem is None else max(rem, 0.0) + 15.0
            if not job.done.wait(timeout=wait_s):
                job.abandoned = True
                if job.scope is not None:
                    job.scope.request_abort("client deadline abandoned")
                counter_inc("serve.handler_timeouts")
                self._respond(504, {
                    "request_id": job.request_id,
                    "status": "deadline_exceeded",
                    "error": "request did not finish within its deadline"})
                return
            extra = None
            if isinstance(job.response, dict) \
                    and job.response.get("trace_id"):
                extra = {_trace.TRACE_HEADER: job.response["trace_id"]}
            self._respond(job.status_code, job.response, headers=extra)
        except Exception as e:  # pragma: no cover - defensive
            try:
                self._respond(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass


def install_signal_handlers(server: RepairServer) -> None:
    """SIGTERM/SIGINT → graceful drain (main-thread only; ``main.py
    --serve`` calls this, tests drive ``begin_drain``/``drain``
    directly)."""
    def _handler(signum: int, frame: Any) -> None:
        _logger.info(f"signal {signum}: draining repair service")
        threading.Thread(target=server.drain, daemon=True,
                         name="delphi-serve-drain").start()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def serve(port: int = 8080, workers: Optional[int] = None,
          cache_dir: Optional[str] = None) -> int:
    """Blocking entry point for ``main.py --serve``: starts the service,
    installs signal handlers, and waits until a drain completes."""
    server = RepairServer(port=port, workers=workers, cache_dir=cache_dir)
    server.start()
    install_signal_handlers(server)
    print(f"delphi repair service on 127.0.0.1:{server.port} "
          f"(cache {server.cache_dir})", flush=True)
    server.wait()
    return 0
