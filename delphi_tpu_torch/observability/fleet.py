"""Elastic repair fleet of the port: N ``RepairServer`` workers behind one
router, the JAX package's ``delphi_tpu/observability/fleet.py``.

One warm process is one fault domain. ``FleetRouter`` scales the serving
plane out: it spawns (or attaches to) N worker processes
(``python -m delphi_tpu_torch.main --serve``) that share one cache root —
the kernel library's build cache, snapshot dirs, per-fingerprint model and
phase checkpoints all live under it — and fronts them with the same
stdlib HTTP stack as :mod:`delphi_tpu_torch.observability.serve`. Before
it spawns workers that run on the card, the router builds the kernel
library into the shared build cache once, so that no two cold workers run
``nvcc`` side by side. Each worker is a one-process run: it joins no
cluster (``DELPHI_COORDINATOR`` is not passed on), and its
``DELPHI_PROCESS_ID`` only names it to rank-scoped fault plans.

Routing is **rendezvous hashing** on the request's table fingerprint
(:func:`~delphi_tpu_torch.observability.serve.table_fingerprint`, the same
blob the workers' warm-table caches key on): the highest-scoring live
worker owns a fingerprint, so repeated tables land on the replica whose
device buffers, models, and compiled executables are already warm, and a
membership change only remaps the fingerprints that scored the departed
worker highest — every other fingerprint keeps its home.

Membership is **derived from the dist-resilience liveness files**: each
worker heartbeats ``rank_<id>.alive`` under the shared fleet dir (the
exact file format the cluster's rank diagnosis reads), and the router's
:meth:`FleetRouter.refresh_membership` scan evicts any worker whose
stamp goes stale — stalled and dead look identical from outside, and
both mean "stop routing there". A cleanly draining worker unregisters
*before* closing admission, so the ring shrinks ahead of the 503s.

Failure handling on the hot path:

* a worker answering **429/503-rejected** is shedding, not broken — the
  router hops to the next-ranked live replica, bounded by
  ``DELPHI_FLEET_MAX_HOPS``, and if *every* live worker sheds it returns
  429 with the **max** observed ``Retry-After`` (never loops);
* a **connection-level failure** (refused/reset — the worker died
  between the membership check and the dispatch) is a ``fleet.dispatch``
  fault: the worker is evicted, its liveness file dropped (a genuinely
  live worker re-touches within one heartbeat and rejoins), and the
  in-flight request is **re-dispatched** to the next-ranked replica —
  idempotent because every request runs under its own ``RequestScope``
  and the response ordering is canonical, so the retry is bit-identical
  to what the dead worker would have answered;
* any other response (200/400/500/504) is definitive and returned
  as-is — a deterministic failure would only repeat elsewhere.

The evicted worker's fingerprints rendezvous-remap to the survivors,
which **rewarm from the shared cache root** (model + phase checkpoints,
the kernel library) instead of recomputing from scratch.

All dispatch I/O goes through ONE guarded helper,
:meth:`FleetRouter._dispatch_once` (site ``fleet.dispatch``, registered
in ``KNOWN_SITES`` and chaos-injectable). ``fleet.*`` counters are
pre-seeded on the router's ``/metrics`` at start, and fleet membership
rides the run report's ``dist`` section.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from delphi_tpu_torch.observability import trace as _trace
from delphi_tpu_torch.observability.registry import (
    counter_inc, counter_value, gauge_set,
)
from delphi_tpu_torch.observability.serve import (
    _knob_float, _knob_int, chain_fingerprint, table_fingerprint,
)
from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

_DEF_FLEET_WORKERS = 2
_DEF_MAX_HOPS = 3
_DEF_SPAWN_TIMEOUT_S = 180.0

#: Pre-seeded at router start so a scrape before the first request (or the
#: first fault) sees the whole fleet series at zero, not a missing metric.
_SEED_COUNTERS = (
    "fleet.requests", "fleet.dispatches", "fleet.redispatches",
    "fleet.evictions", "fleet.rejoins", "fleet.dispatch_faults",
    "fleet.all_shed", "fleet.no_workers",
    "fleet.affinity.hits", "fleet.affinity.misses",
    "fleet.affinity.chain_hits",
    "fleet.registration_corrupt",
    "autoscale.ticks", "autoscale.up", "autoscale.down",
    "autoscale.blocked_cooldown", "autoscale.blocked_hysteresis",
    "autoscale.blocked_limit",
    "trace.traces", "trace.joins", "trace.spans", "trace.exports",
    "launch.ledger.records", "launch.ledger.flushes",
    "launch.ledger.loads", "launch.ledger.consults",
    "launch.ledger.merge_vetoes",
    "store.corrupt", "store.quarantined",
)


def rendezvous_rank(fp: str, members: List[str]) -> List[str]:
    """Members ordered by rendezvous (highest-random-weight) score for
    fingerprint ``fp``, best first. Removing a member never reorders the
    survivors — only the fingerprints the departed member owned remap —
    which is exactly the warm-state-preserving property the fleet needs
    (consistent-hash rings buy the same at far more code)."""
    return sorted(
        members,
        key=lambda m: hashlib.sha1(f"{fp}|{m}".encode()).digest(),
        reverse=True)


class DispatchFault(Exception):
    """A connection-level dispatch failure (refused/reset/timeout) to one
    worker — the signal that the worker, not the request, is broken."""

    def __init__(self, worker_id: str, cause: BaseException) -> None:
        self.worker_id = worker_id
        self.cause = cause
        super().__init__(f"worker {worker_id}: "
                         f"{type(cause).__name__}: {cause}")


class FleetRouter:
    """The fleet front-end. Lifecycle: ``start()`` → (requests...) →
    ``drain()`` (SIGTERMs spawned workers, then stops) or ``stop()``.
    ``spawn=False`` attaches to externally started workers that registered
    under the same cache root."""

    def __init__(self, port: int = 0, workers: Optional[int] = None,
                 cache_dir: Optional[str] = None, spawn: bool = True,
                 max_hops: Optional[int] = None,
                 heartbeat_s: Optional[float] = None,
                 worker_env: Optional[Dict[str, Optional[str]]] = None
                 ) -> None:
        import tempfile

        self.requested_port = int(port)
        self.n_workers = workers if workers is not None else _knob_int(
            "DELPHI_FLEET_WORKERS", "repair.fleet.workers",
            _DEF_FLEET_WORKERS)
        self.n_workers = max(1, int(self.n_workers))
        cache = cache_dir or os.environ.get("DELPHI_SERVE_CACHE_DIR")
        self.cache_dir = str(cache) if cache else tempfile.mkdtemp(
            prefix="delphi_fleet_")
        self.fleet_dir = os.path.join(self.cache_dir, "fleet")
        self.spawn = bool(spawn)
        self.max_hops = max_hops if max_hops is not None else _knob_int(
            "DELPHI_FLEET_MAX_HOPS", "repair.fleet.max_hops", _DEF_MAX_HOPS)
        self.max_hops = max(1, int(self.max_hops))
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None \
            else _knob_float("DELPHI_FLEET_HEARTBEAT_S",
                             "repair.fleet.heartbeat_s", 1.0)
        self.spawn_timeout_s = _knob_float(
            "DELPHI_FLEET_SPAWN_TIMEOUT_S", "repair.fleet.spawn_timeout_s",
            _DEF_SPAWN_TIMEOUT_S)
        self.dispatch_timeout_s = _knob_float(
            "DELPHI_SERVE_DEADLINE_S", "repair.serve.deadline_s",
            300.0) + 30.0
        self.worker_env = dict(worker_env or {})

        self.recorder: Optional[Any] = None
        self._own_recorder: Optional[Any] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        # worker id -> registration info ({"port", "pid", "cache_dir", ...})
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._evicted: Dict[str, str] = {}     # worker id -> reason
        self._live: List[str] = []
        self._procs: Dict[str, subprocess.Popen] = {}
        self._spawned_at: Dict[str, float] = {}
        #: worker id -> seconds from its spawn to its registration file
        self.spawn_seconds: Dict[str, float] = {}

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "FleetRouter":
        from delphi_tpu_torch import observability as obs

        os.makedirs(self.fleet_dir, exist_ok=True)
        self._own_recorder = obs.start_recording("repair.fleet")
        self.recorder = self._own_recorder or obs.current_recorder()
        if self.recorder is None:  # pragma: no cover - defensive
            raise RuntimeError("fleet router requires a run recorder")
        for name in _SEED_COUNTERS:
            counter_inc(name, 0)
        gauge_set("fleet.workers", 0)
        gauge_set("fleet.live_workers", 0)
        gauge_set("fleet.evicted_workers", 0)

        if self.spawn:
            self._prebuild_kernels()
            for i in range(self.n_workers):
                self._spawn_worker(str(i))
        self._await_registrations()
        self.refresh_membership()

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.requested_port),
                                          _FleetHandler)
        self._httpd.daemon_threads = True
        self._httpd.fleet_router = self  # type: ignore[attr-defined]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="delphi-fleet-http")
        self._http_thread.start()
        with self._lock:
            live = list(self._live)
        _logger.info(f"fleet router listening on 127.0.0.1:{self.port} "
                     f"(workers={sorted(self._workers)}, live={live}, "
                     f"cache={self.cache_dir})")
        return self

    def _worker_log_path(self, wid: str) -> str:
        return os.path.join(self.fleet_dir, f"worker_{wid}.log")

    def _worker_environ(self, **fixed: str) -> Dict[str, str]:
        """A worker's environment: this process's without a cluster to join,
        then ``fixed``, then ``worker_env`` on top."""
        env = dict(os.environ)
        env.pop("DELPHI_COORDINATOR", None)
        env.update(fixed)
        for key, value in self.worker_env.items():
            if value is None:
                env.pop(key, None)
            else:
                env[key] = str(value)
        return env

    def _prebuild_kernels(self) -> None:
        """Builds the kernel library into the build cache the workers will
        load it from (``DELPHI_COMPILE_CACHE_DIR``, else ``<cache>/compile``
        as :meth:`RepairServer.start` arms it), unless the workers run on
        the CPU or the library is there already: cold workers then load it
        instead of each running ``nvcc``. Best-effort: a worker that finds
        no library builds it itself and fails its request when it cannot."""
        env = self._worker_environ()
        if env.get("DELPHI_TORCH_DEVICE", "").strip().lower() == "cpu":
            return
        from delphi_tpu_torch.ops.kernels import build
        directory = env.get("DELPHI_COMPILE_CACHE_DIR") or os.path.join(
            self.cache_dir, "compile")
        t0 = time.perf_counter()
        try:
            path, _ = build.build(directory=directory)
        except build.KernelBuildError as e:
            _logger.warning(f"fleet: kernel library not prebuilt: {e}")
            return
        _logger.info(f"fleet: kernel library {path} ready in "
                     f"{time.perf_counter() - t0:.1f}s")

    def _spawn_worker(self, wid: str) -> None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        path = os.environ.get("PYTHONPATH")
        # DELPHI_PROCESS_ID is the worker's identity for rank-scoped fault
        # plans: a plan like "1:xfer.upload:1:rank_death" kills ONLY worker
        # 1's copy of the request
        env = self._worker_environ(
            DELPHI_FLEET_DIR=self.fleet_dir, DELPHI_FLEET_WORKER_ID=wid,
            DELPHI_PROCESS_ID=wid,
            PYTHONPATH=repo_root + (os.pathsep + path if path else ""))
        cmd = [sys.executable, "-m", "delphi_tpu_torch.main", "--serve",
               "--serve-port", "0", "--serve-cache-dir", self.cache_dir]
        log = open(self._worker_log_path(wid), "w")
        try:
            proc = subprocess.Popen(cmd, env=env, cwd=repo_root,
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()
        self._procs[wid] = proc
        self._spawned_at[wid] = time.monotonic()
        _logger.info(f"spawned fleet worker {wid} (pid {proc.pid})")

    def _await_registrations(self) -> None:
        """Blocks until every spawned worker has written its registration
        file; a worker that exits before registering fails the start
        loudly with its log tail (a silently short fleet would masquerade
        as a healthy smaller one)."""
        want = set(self._procs)
        if not want:
            return
        deadline = time.monotonic() + max(1.0, self.spawn_timeout_s)
        while time.monotonic() < deadline:
            regs = self._read_registrations()
            now = time.monotonic()
            for wid in want & set(regs):
                self.spawn_seconds.setdefault(
                    wid, now - self._spawned_at.get(wid, now))
            if want <= set(regs):
                return
            for wid, proc in self._procs.items():
                if wid not in regs and proc.poll() is not None:
                    tail = ""
                    try:
                        with open(self._worker_log_path(wid)) as f:
                            tail = f.read()[-2000:]
                    except OSError:
                        pass
                    raise RuntimeError(
                        f"fleet worker {wid} exited rc={proc.returncode} "
                        f"before registering:\n{tail}")
            time.sleep(0.1)
        raise RuntimeError(
            f"fleet workers {sorted(want - set(self._read_registrations()))} "
            f"did not register within {self.spawn_timeout_s:.0f}s")

    def drain(self) -> None:
        """Graceful fleet shutdown: SIGTERM every spawned worker (each
        unregisters first, then drains its own queue), wait for them,
        then stop the router."""
        for wid, proc in self._procs.items():
            if proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except (ProcessLookupError, OSError):
                    pass
        for wid, proc in self._procs.items():
            try:
                proc.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                _logger.warning(f"fleet worker {wid} ignored SIGTERM; "
                                "killing")
                proc.kill()
        self.stop()

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc in self._procs.values():
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
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
        _logger.info("fleet router stopped")

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    # -- membership ----------------------------------------------------------

    def _read_registrations(self) -> Dict[str, Dict[str, Any]]:
        """Validated membership reads: a half-written or corrupt
        ``worker_<id>.json`` is treated as not-yet-registered (counted
        ``fleet.registration_corrupt``, quarantined by the store seam)
        instead of raising mid-route — the worker's heartbeat loop
        re-announces it on the next beat."""
        from delphi_tpu_torch.parallel import store as dstore
        regs: Dict[str, Dict[str, Any]] = {}
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            return regs
        for name in sorted(names):
            if not (name.startswith("worker_") and name.endswith(".json")):
                continue
            path = os.path.join(self.fleet_dir, name)
            try:
                info, status = dstore.read_json(
                    path, schema="fleet_reg", site="store.fleet",
                    root=self.fleet_dir)
            except Exception:
                counter_inc("fleet.registration_corrupt")
                continue
            if status == "corrupt":
                counter_inc("fleet.registration_corrupt")
                continue
            if not isinstance(info, dict) or "worker_id" not in info:
                # legacy garbage that json-parsed but isn't a registration
                counter_inc("fleet.registration_corrupt")
                continue
            regs[str(info["worker_id"])] = info
        return regs

    def refresh_membership(self, now: Optional[float] = None) -> List[str]:
        """One membership scan: merge worker registrations (new workers
        join the ring elastically), read every liveness file, evict
        workers whose stamp is stale or missing, rejoin workers that came
        back, and drop workers that unregistered cleanly (graceful
        departure, not an eviction). Returns the live ring."""
        from delphi_tpu_torch.parallel import dist_resilience as dr

        regs = self._read_registrations()
        members = dr.scan_membership(self.fleet_dir, self.heartbeat_s,
                                     now=now)
        with self._lock:
            for wid, info in regs.items():
                self._workers[wid] = info
            for wid in list(self._workers):
                if wid not in regs:
                    # registration gone: the worker drained out cleanly
                    self._workers.pop(wid, None)
                    self._evicted.pop(wid, None)
                    _logger.info(f"fleet worker {wid} departed (drained)")
            live: List[str] = []
            for wid in sorted(self._workers):
                status = members.get(wid, {}).get("status", "unknown")
                if status == "live":
                    if wid in self._evicted:
                        del self._evicted[wid]
                        counter_inc("fleet.rejoins")
                        _logger.info(f"fleet worker {wid} rejoined the ring")
                    live.append(wid)
                elif wid not in self._evicted:
                    self._evicted[wid] = f"liveness {status}"
                    counter_inc("fleet.evictions")
                    _logger.warning(f"fleet worker {wid} evicted: "
                                    f"liveness {status}")
            self._live = live
            n_workers, n_evicted = len(self._workers), len(self._evicted)
        gauge_set("fleet.workers", n_workers)
        gauge_set("fleet.live_workers", len(live))
        gauge_set("fleet.evicted_workers", n_evicted)
        self._publish_dist_section()
        return list(live)

    def _evict(self, wid: str, reason: str,
               drop_liveness: bool = False) -> None:
        """Dispatch-fault eviction. ``drop_liveness`` removes the dead
        worker's liveness file so the stale stamp can't flap it back on
        the very next scan — a worker that is actually alive re-touches
        within one heartbeat and rejoins."""
        from delphi_tpu_torch.parallel import dist_resilience as dr

        with self._lock:
            if wid in self._live:
                self._live.remove(wid)
            already = wid in self._evicted
            if not already:
                self._evicted[wid] = reason
        if not already:
            counter_inc("fleet.evictions")
            _logger.warning(f"fleet worker {wid} evicted: {reason}")
        if drop_liveness:
            try:
                os.remove(dr.member_liveness_path(self.fleet_dir, wid))
            except OSError:
                pass
        gauge_set("fleet.live_workers", len(self._live))
        gauge_set("fleet.evicted_workers", len(self._evicted))
        self._publish_dist_section()

    def _publish_dist_section(self) -> None:
        """Rolls fleet membership into the run report's ``dist`` section
        (merged over the dist-resilience section when one exists)."""
        from delphi_tpu_torch.parallel import dist_resilience as dr

        try:
            section = dict(dr.report_section() or {})
        except Exception:  # pragma: no cover - defensive
            section = {}
        with self._lock:
            section["fleet"] = {
                "workers": sorted(self._workers),
                "live": list(self._live),
                "evicted": dict(self._evicted),
            }
        if self.recorder is not None:
            self.recorder.dist = section

    # -- dispatch ------------------------------------------------------------

    def _dispatch_once(self, wid: str, data: bytes, timeout_s: float
                       ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """The ONE place router→worker HTTP happens: a guarded seam at
        site ``fleet.dispatch`` (chaos-injectable, abort-aware). Returns
        ``(status, body, headers)`` for any HTTP answer — including the
        worker's 4xx/5xx — and raises :class:`DispatchFault` for
        connection-level failures, which the caller treats as the worker
        dying between the membership check and the dispatch."""
        from delphi_tpu_torch.parallel import resilience

        resilience.maybe_abort()
        with self._lock:
            info = self._workers.get(wid)
        port = (info or {}).get("port")
        try:
            resilience._maybe_inject("fleet.dispatch")
            if not port:
                raise OSError(f"worker {wid} has no registered port "
                              "(connection refused)")
            headers = {"Content-Type": "application/json"}
            # propagate the trace across the router→worker seam: every
            # dispatch — including shed-hops and post-eviction
            # re-dispatches — carries the same trace id, so the request's
            # whole journey merges into ONE trace document
            trace_header = _trace.header_value()
            if trace_header:
                headers[_trace.TRACE_HEADER] = trace_header
            req = urllib.request.Request(
                f"http://127.0.0.1:{int(port)}/repair", data=data,
                headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                body = json.loads(resp.read() or b"{}")
                return int(resp.status), body, dict(resp.headers)
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except Exception:
                body = {"status": "error", "error": f"HTTP {e.code}"}
            return int(e.code), body, dict(e.headers or {})
        except Exception as e:
            raise DispatchFault(wid, e)

    @staticmethod
    def _retry_after_s(headers: Dict[str, str]) -> float:
        for key, value in headers.items():
            if key.lower() == "retry-after":
                try:
                    return float(value)
                except (TypeError, ValueError):
                    break
        return 1.0

    def handle_repair(self, payload: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """Routes one /repair request: rendezvous-rank the live ring on
        the table fingerprint, dispatch to the best untried worker, hop
        on shed (429/503-rejected), evict + re-dispatch on connection
        faults, return anything else as definitive. Bounded by
        ``max_hops`` and the monotonically growing tried-set, so the
        router can never loop. Returns ``(status, body,
        retry_after_s)``."""
        from delphi_tpu_torch.parallel import resilience

        counter_inc("fleet.requests")
        # chained requests (a stream delta or a base_snapshot follow-up)
        # route by the CHAIN-ROOT key, not the per-delta table content:
        # every link of a chain must land on the home that holds its
        # snapshot, durable cursor, and warm models — hashing the table
        # would scatter the chain across the ring on every append
        chain = chain_fingerprint(payload)
        fp = chain or table_fingerprint(payload["table"],
                                        payload["row_id"])
        data = json.dumps(payload).encode()
        tried: set = set()
        shed_retry_afters: List[float] = []
        hops = 0
        saw_worker = False
        while hops < self.max_hops:
            live = self.refresh_membership()
            ranked = rendezvous_rank(fp, live)
            candidates = [w for w in ranked if w not in tried]
            if not candidates:
                break
            saw_worker = True
            wid = candidates[0]
            tried.add(wid)
            hops += 1
            counter_inc("fleet.dispatches")
            if hops > 1:
                counter_inc("fleet.redispatches")
            # affinity: did this request land on its rendezvous home?
            if wid != ranked[0]:
                counter_inc("fleet.affinity.misses")
            else:
                counter_inc("fleet.affinity.chain_hits" if chain
                            else "fleet.affinity.hits")
            hits = counter_value("fleet.affinity.hits") \
                + counter_value("fleet.affinity.chain_hits")
            total = hits + counter_value("fleet.affinity.misses")
            if total > 0:
                gauge_set("fleet.affinity.hit_ratio",
                          round(hits / total, 6))
            _trace.instant("fleet.redispatch" if hops > 1
                           else "fleet.dispatch", worker=wid, hop=hops)
            try:
                status, body, headers = self._dispatch_once(
                    wid, data, self.dispatch_timeout_s)
            except DispatchFault as e:
                counter_inc("fleet.dispatch_faults")
                kind = resilience.classify_fault(e.cause) or "transient"
                self._evict(wid, f"dispatch fault ({kind}): {e.cause}",
                            drop_liveness=True)
                _trace.instant("fleet.dispatch_fault", worker=wid,
                               hop=hops, kind=kind)
                _logger.warning(f"fleet.dispatch fault on worker {wid} "
                                f"({kind}); re-dispatching")
                continue
            shedding = status in (429, 503) \
                and body.get("status") == "rejected"
            if shedding:
                shed_retry_afters.append(self._retry_after_s(headers))
                _trace.instant("fleet.shed_hop", worker=wid, hop=hops)
                continue
            if isinstance(body, dict):
                # replica attribution for clients and the load harness:
                # which worker answered, after how many dispatches —
                # lifted into X-Delphi-Worker / X-Delphi-Hops by do_POST
                body.setdefault("worker_id", wid)
                body["hops"] = hops
            return status, body, None
        if shed_retry_afters:
            counter_inc("fleet.all_shed")
            return (429, {"status": "rejected",
                          "error": "all live workers are shedding"},
                    max(shed_retry_afters))
        if not saw_worker:
            counter_inc("fleet.no_workers")
            return (503, {"status": "rejected",
                          "error": "no live fleet workers"}, 1.0)
        return (503, {"status": "error",
                      "error": f"no live worker completed the request "
                               f"after {hops} dispatch(es) to "
                               f"{len(tried)} worker(s)"},
                1.0)


class _FleetHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:
        _logger.debug("fleet router: " + fmt % args)

    @property
    def _router(self) -> FleetRouter:
        return self.server.fleet_router  # type: ignore[attr-defined]

    def _respond(self, status: int, body: Dict[str, Any],
                 retry_after_s: Optional[float] = None,
                 headers: Optional[Dict[str, Any]] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after_s is not None:
            self.send_header("Retry-After",
                             str(max(1, int(round(retry_after_s)))))
        for key, value in (headers or {}).items():
            self.send_header(key, str(value))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        from delphi_tpu_torch.observability.live import (
            PROMETHEUS_CONTENT_TYPE, render_prometheus,
        )

        rt = self._router
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                live = rt.refresh_membership()
                with rt._lock:
                    evicted = dict(rt._evicted)
                    workers = {
                        wid: {"port": info.get("port"),
                              "live": wid in live,
                              "evicted_reason": evicted.get(wid)}
                        for wid, info in sorted(rt._workers.items())}
                self._respond(200, {
                    "status": "degraded" if evicted else "ok",
                    "live": live,
                    "evicted": evicted,
                    "workers": workers,
                })
            elif path == "/metrics":
                text = render_prometheus(rt.recorder).encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            elif path == "/report":
                from delphi_tpu_torch.observability.report import (
                    build_run_report,
                )
                rt._publish_dist_section()
                report = build_run_report(rt.recorder, run={},
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
        rt = self._router
        path = self.path.split("?", 1)[0]
        try:
            if path == "/drain":
                threading.Thread(target=rt.drain, daemon=True,
                                 name="delphi-fleet-drain").start()
                self._respond(200, {"status": "draining"})
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
            # the router is where a distributed trace is born (or, when a
            # client already carries one, joined): the scope covers every
            # dispatch/shed-hop/re-dispatch instant and the header the
            # dispatch seam stamps on each worker call
            tid, parent = _trace.parse_header(
                self.headers.get(_trace.TRACE_HEADER))
            with _trace.request_scope(tid, parent) as tctx:
                status, body, retry_after_s = rt.handle_repair(payload)
                if tctx is not None and isinstance(body, dict):
                    body.setdefault("trace_id", tctx.trace_id)
            extra: Dict[str, Any] = {}
            if isinstance(body, dict):
                if body.get("worker_id") is not None:
                    extra["X-Delphi-Worker"] = body["worker_id"]
                if body.get("hops") is not None:
                    extra["X-Delphi-Hops"] = body["hops"]
                if body.get("trace_id"):
                    extra[_trace.TRACE_HEADER] = body["trace_id"]
            self._respond(status, body, retry_after_s=retry_after_s,
                          headers=extra or None)
        except Exception as e:  # pragma: no cover - defensive
            try:
                self._respond(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass


# -- queue-driven autoscaling ------------------------------------------------

_DEF_AS_MIN = 1
_DEF_AS_MAX = 4
_DEF_AS_UP_QUEUE = 4
_DEF_AS_DOWN_QUEUE = 0
_DEF_AS_UP_LAG_ROWS = 512
_DEF_AS_SUSTAIN = 3
_DEF_AS_COOLDOWN_S = 30.0
_DEF_AS_INTERVAL_S = 1.0


class AutoscalePolicy:
    """The pure scale decision — no threads, no HTTP, fully drivable by a
    fake clock.

    Signals per tick: the fleet's worst per-worker admission queue depth
    and worst ``stream.lag_rows`` (one hot replica is a problem even when
    the mean is fine). Three defenses against flapping:

    * **hysteresis** — scale-up pressure needs ``queue >= up_queue_depth``
      (or ``lag >= up_lag_rows``); scale-down needs
      ``queue <= down_queue_depth`` AND no lag pressure. The band between
      the thresholds resets both streaks;
    * **sustain** — a decision fires only after ``sustain_ticks``
      *consecutive* pressured ticks (one spiky scrape is not a trend);
    * **cooldown** — after any action, further actions are blocked for
      ``cooldown_s`` (the new worker needs time to warm and absorb load
      before it can be judged).

    ``observe`` returns ``(action, reason)`` with action one of ``"up"``
    / ``"down"`` / ``"hold"``.
    """

    def __init__(self, min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 up_queue_depth: Optional[int] = None,
                 down_queue_depth: Optional[int] = None,
                 up_lag_rows: Optional[int] = None,
                 sustain_ticks: Optional[int] = None,
                 cooldown_s: Optional[float] = None) -> None:
        def knob(value, env, opt, default):
            return value if value is not None else _knob_int(env, opt,
                                                             default)

        self.min_workers = max(1, knob(min_workers, "DELPHI_AUTOSCALE_MIN",
                                       "repair.autoscale.min", _DEF_AS_MIN))
        self.max_workers = max(self.min_workers, knob(
            max_workers, "DELPHI_AUTOSCALE_MAX", "repair.autoscale.max",
            _DEF_AS_MAX))
        self.up_queue_depth = knob(up_queue_depth,
                                   "DELPHI_AUTOSCALE_UP_QUEUE",
                                   "repair.autoscale.up_queue",
                                   _DEF_AS_UP_QUEUE)
        self.down_queue_depth = knob(down_queue_depth,
                                     "DELPHI_AUTOSCALE_DOWN_QUEUE",
                                     "repair.autoscale.down_queue",
                                     _DEF_AS_DOWN_QUEUE)
        self.up_lag_rows = knob(up_lag_rows, "DELPHI_AUTOSCALE_UP_LAG_ROWS",
                                "repair.autoscale.up_lag_rows",
                                _DEF_AS_UP_LAG_ROWS)
        self.sustain_ticks = max(1, knob(sustain_ticks,
                                         "DELPHI_AUTOSCALE_SUSTAIN",
                                         "repair.autoscale.sustain",
                                         _DEF_AS_SUSTAIN))
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else _knob_float("DELPHI_AUTOSCALE_COOLDOWN_S",
                             "repair.autoscale.cooldown_s",
                             _DEF_AS_COOLDOWN_S)
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at: Optional[float] = None

    def _cooling(self, now: float) -> bool:
        return self._last_action_at is not None \
            and (now - self._last_action_at) < self.cooldown_s

    def observe(self, now: float, queue_depth: int, lag_rows: int,
                n_live: int) -> Tuple[str, str]:
        counter_inc("autoscale.ticks")
        up_pressure = queue_depth >= self.up_queue_depth \
            or lag_rows >= self.up_lag_rows
        down_pressure = queue_depth <= self.down_queue_depth \
            and lag_rows < self.up_lag_rows
        if up_pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif down_pressure:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # inside the hysteresis band: not hot enough to grow, not
            # idle enough to shrink — and any built-up streak dies here
            if self._up_streak or self._down_streak:
                counter_inc("autoscale.blocked_hysteresis")
            self._up_streak = self._down_streak = 0
            return "hold", "hysteresis"
        if up_pressure and self._up_streak >= self.sustain_ticks:
            if n_live >= self.max_workers:
                counter_inc("autoscale.blocked_limit")
                return "hold", "at_max"
            if self._cooling(now):
                counter_inc("autoscale.blocked_cooldown")
                return "hold", "cooldown"
            self._up_streak = self._down_streak = 0
            self._last_action_at = now
            return "up", (f"queue_depth={queue_depth} "
                          f">= {self.up_queue_depth}"
                          if queue_depth >= self.up_queue_depth
                          else f"lag_rows={lag_rows} "
                               f">= {self.up_lag_rows}")
        if down_pressure and self._down_streak >= self.sustain_ticks:
            if n_live <= self.min_workers:
                counter_inc("autoscale.blocked_limit")
                return "hold", "at_min"
            if self._cooling(now):
                counter_inc("autoscale.blocked_cooldown")
                return "hold", "cooldown"
            self._up_streak = self._down_streak = 0
            self._last_action_at = now
            return "down", (f"queue_depth={queue_depth} "
                            f"<= {self.down_queue_depth}")
        return "hold", "building"


class FleetAutoscaler:
    """Closes the elasticity loop: polls every live worker's ``/healthz``
    (queue depth, stream lag), feeds the worst-case signals through
    :class:`AutoscalePolicy`, and acts on the router — scale-up spawns
    the next worker id (it registers and rendezvous-joins the ring
    elastically), scale-down picks the highest-id live worker and
    retires it GRACEFULLY: POST ``/drain`` (the worker unregisters and
    hands back its stream cursors before refusing a single request),
    wait for its clean departure from the ring, then SIGTERM the
    process. Never SIGKILL on the happy path — a killed worker loses
    nothing durable, but a drained one sheds nothing at all.

    Every decision lands in ``autoscale.*`` counters; every action is a
    trace instant (:func:`trace.background_instant`) and a structured
    entry on :attr:`events`, which the load harness rolls into the run
    report's ``slo.autoscale`` section.
    """

    def __init__(self, router: FleetRouter,
                 policy: Optional[AutoscalePolicy] = None,
                 interval_s: Optional[float] = None,
                 now_fn=time.monotonic) -> None:
        self.router = router
        self.policy = policy or AutoscalePolicy()
        self.interval_s = interval_s if interval_s is not None \
            else _knob_float("DELPHI_AUTOSCALE_INTERVAL_S",
                             "repair.autoscale.interval_s",
                             _DEF_AS_INTERVAL_S)
        self.now_fn = now_fn
        self.events: List[Dict[str, Any]] = []
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # seams (overridden by tests to script worker health / drain) ---------

    def _http_once(self, port: int, path: str, method: str = "GET",
                   timeout_s: float = 5.0,
                   site: str = "autoscale.http") -> Optional[Dict[str, Any]]:
        """The ONE place autoscaler→worker HTTP happens (health polls and
        drain posts — never repair dispatch, which stays on the router's
        ``fleet.dispatch`` seam). Chaos-injectable at ``autoscale.http``;
        any failure means "no signal this tick", never an exception — the
        membership scan, not the autoscaler, declares workers dead."""
        from delphi_tpu_torch.parallel import resilience
        try:
            resilience._maybe_inject("autoscale.http")
            req = urllib.request.Request(
                f"http://127.0.0.1:{int(port)}{path}",
                data=b"" if method == "POST" else None, method=method)
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except Exception:
            return None

    def _poll_worker(self, port: int) -> Optional[Dict[str, Any]]:
        return self._http_once(port, "/healthz")

    def _post_drain(self, port: int) -> bool:
        return self._http_once(port, "/drain", method="POST",
                               timeout_s=10.0) is not None

    # signal collection ---------------------------------------------------

    def collect(self) -> Tuple[int, int, int]:
        """(worst queue_depth, worst lag_rows, live count) across the
        ring. A worker that fails its poll contributes nothing — the
        membership scan, not the autoscaler, decides whether it is
        dead."""
        live = self.router.refresh_membership()
        queue_depth = lag_rows = 0
        with self.router._lock:
            ports = {wid: (self.router._workers.get(wid) or {}).get("port")
                     for wid in live}
        for wid, port in ports.items():
            if not port:
                continue
            health = self._poll_worker(int(port))
            if not health:
                continue
            queue_depth = max(queue_depth,
                              int(health.get("queue_depth") or 0))
            lag_rows = max(lag_rows, int(
                (health.get("streams") or {}).get("lag_rows") or 0))
        gauge_set("autoscale.queue_depth", queue_depth)
        gauge_set("autoscale.lag_rows", lag_rows)
        return queue_depth, lag_rows, len(live)

    # actions --------------------------------------------------------------

    def _event(self, action: str, reason: str, worker: Optional[str],
               **extra: Any) -> None:
        event = {"action": action, "reason": reason, "worker": worker,
                 "at_s": round(self.now_fn(), 3)}
        event.update(extra)
        self.events.append(event)
        trace_id = _trace.background_instant(f"autoscale.{action}",
                                             reason=reason, worker=worker)
        if trace_id:
            event["trace_id"] = trace_id

    def _next_worker_id(self) -> str:
        with self.router._lock:
            known = set(self.router._workers) | set(self.router._procs)
        numeric = [int(w) for w in known if str(w).isdigit()]
        return str(max(numeric) + 1 if numeric else len(known))

    def scale_up(self, reason: str) -> Optional[str]:
        wid = self._next_worker_id()
        try:
            self.router._spawn_worker(wid)
        except Exception as e:
            _logger.warning(f"autoscale spawn of worker {wid} failed: {e}")
            return None
        counter_inc("autoscale.up")
        self._event("up", reason, wid)
        _logger.info(f"autoscale: spawned worker {wid} ({reason})")
        return wid

    def _pick_victim(self) -> Optional[str]:
        """Retire the highest worker id: with ids handed out in spawn
        order that is the youngest (coldest) replica, and its departure
        remaps the fewest long-lived warm fingerprints."""
        live = self.router.refresh_membership()
        if len(live) <= self.policy.min_workers:
            return None
        return sorted(live, key=lambda w: (len(w), w))[-1]

    def scale_down(self, reason: str,
                   depart_timeout_s: float = 30.0) -> Optional[str]:
        wid = self._pick_victim()
        if wid is None:
            return None
        with self.router._lock:
            port = (self.router._workers.get(wid) or {}).get("port")
        drained = bool(port) and self._post_drain(int(port))
        if drained:
            # the worker unregistered before its drain response; wait for
            # the membership scan to see the clean departure
            deadline = time.monotonic() + depart_timeout_s
            while time.monotonic() < deadline:
                if wid not in self.router.refresh_membership():
                    break
                time.sleep(0.1)
        proc = self.router._procs.get(wid)
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout=depart_timeout_s)
            except subprocess.TimeoutExpired:
                _logger.warning(f"autoscale victim {wid} ignored SIGTERM; "
                                "killing")
                proc.kill()
        counter_inc("autoscale.down")
        self._event("down", reason, wid, drained=drained)
        _logger.info(f"autoscale: retired worker {wid} "
                     f"(drained={drained}, {reason})")
        return wid

    # loop -----------------------------------------------------------------

    def tick(self) -> Tuple[str, str]:
        queue_depth, lag_rows, n_live = self.collect()
        action, reason = self.policy.observe(self.now_fn(), queue_depth,
                                             lag_rows, n_live)
        if action == "up":
            self.scale_up(reason)
        elif action == "down":
            self.scale_down(reason)
        return action, reason

    def _loop(self) -> None:
        while not self._stopped.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # scaling must never kill the router
                _logger.warning(f"autoscale tick failed: {e}")

    def start(self) -> "FleetAutoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="delphi-fleet-autoscaler")
        self._thread.start()
        _logger.info(
            f"fleet autoscaler on (min={self.policy.min_workers}, "
            f"max={self.policy.max_workers}, "
            f"up_queue={self.policy.up_queue_depth}, "
            f"sustain={self.policy.sustain_ticks}, "
            f"cooldown={self.policy.cooldown_s}s)")
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def install_signal_handlers(router: FleetRouter) -> None:
    """SIGTERM/SIGINT → drain the whole fleet (main-thread only)."""
    def _handler(signum: int, frame: Any) -> None:
        _logger.info(f"signal {signum}: draining repair fleet")
        threading.Thread(target=router.drain, daemon=True,
                         name="delphi-fleet-drain").start()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def run_fleet(port: int = 8080, workers: Optional[int] = None,
              cache_dir: Optional[str] = None,
              autoscale: Optional[bool] = None) -> int:
    """Blocking entry point for ``main.py --fleet N``: spawns the
    workers, starts the router (plus the queue-driven autoscaler when
    ``autoscale`` — or ``DELPHI_AUTOSCALE=1`` — asks for it), and waits
    until a drain completes."""
    if autoscale is None:
        autoscale = str(os.environ.get("DELPHI_AUTOSCALE") or "").lower() \
            in ("1", "on", "true", "yes")
    router = FleetRouter(port=port, workers=workers, cache_dir=cache_dir)
    router.start()
    scaler = FleetAutoscaler(router).start() if autoscale else None
    install_signal_handlers(router)
    print(f"delphi repair fleet on 127.0.0.1:{router.port} "
          f"({router.n_workers} workers, "
          f"autoscale {'on' if scaler else 'off'}, "
          f"cache {router.cache_dir})", flush=True)
    router.wait()
    if scaler is not None:
        scaler.stop()
    return 0
