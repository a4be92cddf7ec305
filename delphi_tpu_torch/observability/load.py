"""Sustained-load harness: deterministic open-loop fleet load generation
(the JAX package's ``delphi_tpu/observability/load.py``, on the port's
registry, settings and gauntlet generators).

Every serve/fleet/stream number before this module came from chaos A/Bs
with a handful of requests. This is the plane that drives the fleet hard
enough for its queue/lag/shed/affinity signals to mean something, and
turns what comes back into a gated SLO ledger:

* **workload synthesis** — tables come from the gauntlet generators
  (:mod:`delphi_tpu_torch.gauntlet.scenarios`), one distinct table fingerprint
  per (scenario, seed) pair, so a pool of hundreds of fingerprints costs
  one function call and is byte-identical per seed;
* **zipf popularity** — request fingerprints are drawn from a seeded
  zipf distribution over the pool, so a few tables are hot and most are
  cold: exactly the shape under which rendezvous warm-affinity matters;
* **mixed request kinds** — plain batch repairs, ``base_snapshot``
  incremental chains, and chained stream deltas, in a seeded mix. Chained
  kinds serialize *within* their chain (the stream protocol 409s on
  reordering) but stay open-loop *across* chains;
* **open-loop arrival schedule** — seeded exponential interarrivals over
  phase-programmed segments (warmup / steady / spike / post_kill).
  Arrivals are NEVER coupled to completions: a slow fleet means deeper
  queues and shed responses, not a politely backing-off client;
* **bounded retry discipline** — 429/503 answers are retried honoring
  ``Retry-After`` with the same deterministic crc32-jittered backoff as
  :class:`delphi_tpu_torch.parallel.resilience.RetryPolicy`; exhausted
  retries
  are explicit ``load.shed`` / ``load.gave_up`` counters, never a silent
  truncation of the schedule — ``sent == answered + shed + gave_up``
  holds by construction;
* **the SLO ledger** — per-request records (latency, status, worker from
  ``X-Delphi-Worker``, hops from ``X-Delphi-Hops``, retry outcome,
  segment attribution) aggregate into the run report's ``slo`` section
  (schema v9): sustained QPS, p50/p90/p99 from the deterministic
  reservoirs, shed rate, warm-hit ratio, per-worker utilization, and
  per-segment breakdowns, with an intra-run recovery verdict (post-spike
  and post-kill p99 vs steady state).

A caller runs this against a live
:class:`~delphi_tpu_torch.observability.fleet.FleetRouter` (the port has
no ``bench.py``: ``chip_smoke.py``'s phase 4u and
``tests/test_torch_load.py`` drive it);
:func:`delphi_tpu_torch.observability.drift.evaluate_slo` gates a run
against a baseline report. Knobs (env beats defaults; documented in
``docs/source/internals.rst``): ``DELPHI_LOAD_SEED``,
``DELPHI_LOAD_REQUESTS``, ``DELPHI_LOAD_FINGERPRINTS``,
``DELPHI_LOAD_ROWS``, ``DELPHI_LOAD_RATE``, ``DELPHI_LOAD_SPIKE_X``,
``DELPHI_LOAD_ZIPF_ALPHA``, ``DELPHI_LOAD_MIX``,
``DELPHI_LOAD_RETRY_MAX``, ``DELPHI_LOAD_BASELINE``,
``DELPHI_LOAD_FAIL_OVER``.
"""

import json
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from delphi_tpu_torch.observability.registry import _Histogram, counter_inc
from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

_DEF_SEED = 0
_DEF_REQUESTS = 1200
_DEF_FINGERPRINTS = 120
_DEF_ROWS = 32
_DEF_RATE_RPS = 6.0
_DEF_SPIKE_X = 3.0
_DEF_ZIPF_ALPHA = 1.1
_DEF_MIX = "batch=0.7,incremental=0.15,stream=0.15"
_DEF_RETRY_MAX = 2
_DEF_FAIL_OVER = 0.5
_RETRY_CAP_S = 5.0

#: Counters this plane owns. Pre-seeded on both the serve and fleet
#: ``/metrics`` (their ``_SEED_COUNTERS`` tuples) so a scrape before —
#: or without — any load run sees the whole series at zero.
LOAD_COUNTERS = (
    "load.requests", "load.answered", "load.ok", "load.failed",
    "load.shed", "load.gave_up", "load.retries",
    "slo.segments", "slo.recovery_violations",
)


def load_knobs() -> Dict[str, Any]:
    """The env-tunable load shape, resolved once per run (a full load
    run reads these; a smoke overrides them explicitly)."""
    from delphi_tpu_torch.observability.serve import _knob_float, _knob_int
    import os

    return {
        "seed": _knob_int("DELPHI_LOAD_SEED", "repair.load.seed", _DEF_SEED),
        "requests": _knob_int("DELPHI_LOAD_REQUESTS",
                              "repair.load.requests", _DEF_REQUESTS),
        "fingerprints": _knob_int("DELPHI_LOAD_FINGERPRINTS",
                                  "repair.load.fingerprints",
                                  _DEF_FINGERPRINTS),
        "rows": _knob_int("DELPHI_LOAD_ROWS", "repair.load.rows", _DEF_ROWS),
        "rate_rps": _knob_float("DELPHI_LOAD_RATE", "repair.load.rate",
                                _DEF_RATE_RPS),
        "spike_x": _knob_float("DELPHI_LOAD_SPIKE_X", "repair.load.spike_x",
                               _DEF_SPIKE_X),
        "zipf_alpha": _knob_float("DELPHI_LOAD_ZIPF_ALPHA",
                                  "repair.load.zipf_alpha", _DEF_ZIPF_ALPHA),
        "mix": parse_mix(os.environ.get("DELPHI_LOAD_MIX") or _DEF_MIX),
        "retry_max": _knob_int("DELPHI_LOAD_RETRY_MAX",
                               "repair.load.retry_max", _DEF_RETRY_MAX),
        "baseline": os.environ.get("DELPHI_LOAD_BASELINE") or None,
        "fail_over": _knob_float("DELPHI_LOAD_FAIL_OVER",
                                 "repair.load.fail_over", _DEF_FAIL_OVER),
    }


def parse_mix(raw: str) -> Dict[str, float]:
    """``"batch=0.7,incremental=0.2,stream=0.1"`` → normalized weights.
    Unknown kinds are rejected loudly; an all-zero mix degrades to pure
    batch (the one kind that needs no chain bookkeeping)."""
    weights = {"batch": 0.0, "incremental": 0.0, "stream": 0.0}
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in weights:
            raise ValueError(f"unknown load mix kind {key!r} "
                             f"(expected one of {sorted(weights)})")
        weights[key] = max(0.0, float(value))
    total = sum(weights.values())
    if total <= 0:
        return {"batch": 1.0, "incremental": 0.0, "stream": 0.0}
    return {k: v / total for k, v in weights.items()}


# -- workload synthesis ------------------------------------------------------


def make_tables(n_fingerprints: int, rows: int, seed: int,
                scenarios: Optional[List[str]] = None
                ) -> List[Dict[str, Any]]:
    """``n_fingerprints`` distinct JSON tables from the gauntlet
    generators: fingerprint ``i`` is scenario ``names[i % len(names)]``
    generated at seed ``seed + i`` — byte-identical per (n, rows, seed),
    with every fingerprint distinct because the generators hash their
    seed into every sampled cell. ``scenarios`` restricts the cycle
    (each scenario family is a distinct table SHAPE, hence a distinct
    compile — the smoke pins one family so compile time doesn't dominate
    a tier-1 run; the full ``--load`` uses them all)."""
    from delphi_tpu_torch.gauntlet.scenarios import generate_scenario, \
        scenario_names

    names = list(scenarios) if scenarios else scenario_names()
    tables: List[Dict[str, Any]] = []
    for i in range(max(1, int(n_fingerprints))):
        data = generate_scenario(names[i % len(names)], rows=rows,
                                 seed=seed + i)
        split = json.loads(data.dirty.to_json(orient="split"))
        table = {c: [row[j] for row in split["data"]]
                 for j, c in enumerate(split["columns"])}
        tables.append({"index": i, "scenario": data.name,
                       "row_id": data.row_id, "table": table})
    return tables


def zipf_weights(n: int, alpha: float) -> List[float]:
    """Unnormalized zipf popularity: weight of rank ``i`` is
    ``1/(i+1)^alpha``. ``alpha`` around 1 gives the classic few-hot /
    long-cold-tail shape that makes warm affinity measurable."""
    return [1.0 / ((i + 1) ** max(0.0, float(alpha))) for i in range(n)]


# -- arrival schedule --------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    """One phase of the arrival schedule. ``rate_rps`` is the open-loop
    arrival rate for ``duration_s`` seconds."""
    name: str
    duration_s: float
    rate_rps: float


def default_segments(requests: int, rate_rps: float,
                     spike_x: float) -> List[Segment]:
    """The canonical 4-phase program: warmup (10% of requests), steady
    (50%), spike (25% at ``spike_x`` times the steady rate), post_kill
    (15% — the caller kills a worker at this boundary).
    Durations are derived so the expected request count lands on
    ``requests``."""
    rate = max(0.1, float(rate_rps))
    spike_rate = rate * max(1.0, float(spike_x))
    n = max(4, int(requests))
    return [
        Segment("warmup", (0.10 * n) / rate, rate),
        Segment("steady", (0.50 * n) / rate, rate),
        Segment("spike", (0.25 * n) / spike_rate, spike_rate),
        Segment("post_kill", (0.15 * n) / rate, rate),
    ]


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: WHEN it fires (``at_s`` from run start, in
    segment ``segment``), WHAT it repairs (fingerprint ``fp_index`` of
    the pool), and HOW (kind; chained kinds carry their lane + seq)."""
    index: int
    at_s: float
    segment: str
    kind: str                     # "batch" | "incremental" | "stream"
    fp_index: int
    lane: Optional[str] = None    # chain id for incremental/stream kinds
    seq: int = 0                  # 1-based position within the lane


def build_schedule(segments: List[Segment], n_fingerprints: int,
                   zipf_alpha: float, mix: Dict[str, float],
                   seed: int) -> List[Arrival]:
    """The full seeded arrival schedule: exponential interarrivals per
    segment, zipf-weighted fingerprint choice, seeded kind mix. Pure —
    the same (segments, n, alpha, mix, seed) always yields the identical
    schedule, which is what makes a load run replayable."""
    import random

    rng = random.Random(zlib.crc32(f"load-schedule:{seed}".encode()))
    weights = zipf_weights(n_fingerprints, zipf_alpha)
    fp_pool = list(range(n_fingerprints))
    kinds = sorted(k for k, w in mix.items() if w > 0)
    kind_weights = [mix[k] for k in kinds]
    lane_seq: Dict[str, int] = {}
    arrivals: List[Arrival] = []
    t = 0.0
    index = 0
    for seg in segments:
        seg_end = t + max(0.0, seg.duration_s)
        while True:
            t += rng.expovariate(max(0.1, seg.rate_rps))
            if t >= seg_end:
                t = seg_end
                break
            fp = rng.choices(fp_pool, weights=weights, k=1)[0]
            kind = rng.choices(kinds, weights=kind_weights, k=1)[0]
            lane = None
            seq = 0
            if kind in ("incremental", "stream"):
                # one chain per (kind, fingerprint): every link routes to
                # the same rendezvous home (chain_fingerprint) and the
                # lane serializes seq order client-side
                lane = f"{kind[0]}{fp}"
                seq = lane_seq.get(lane, 0) + 1
                lane_seq[lane] = seq
            arrivals.append(Arrival(index=index, at_s=round(t, 6),
                                    segment=seg.name, kind=kind,
                                    fp_index=fp, lane=lane, seq=seq))
            index += 1
    return arrivals


def build_payload(arrival: Arrival, tables: List[Dict[str, Any]]
                  ) -> Dict[str, Any]:
    """The /repair body for one arrival. Batch sends the whole table;
    incremental chains repair the same table against a per-lane
    ``base_snapshot`` (link 1 populates, later links reuse it); stream
    chains send disjoint row slices as seq-ordered deltas."""
    entry = tables[arrival.fp_index % len(tables)]
    table = entry["table"]
    rid = f"load-{arrival.index}"
    base: Dict[str, Any] = {"row_id": entry["row_id"], "request_id": rid}
    if arrival.kind == "incremental":
        base["table"] = table
        base["base_snapshot"] = f"load-{arrival.lane}"
        return base
    if arrival.kind == "stream":
        row_id = entry["row_id"]
        n = len(table[row_id])
        # disjoint per-seq slice: the chain accumulates the table without
        # ever re-sending a committed row (a duplicate row set would be a
        # legitimate duplicate-delta ack, which we test elsewhere)
        step = max(1, n // 4)
        lo = ((arrival.seq - 1) * step) % n
        hi = min(n, lo + step)
        base["table"] = {c: v[lo:hi] for c, v in table.items()}
        base["stream"] = {"id": f"load-{arrival.lane}", "seq": arrival.seq}
        return base
    base["table"] = table
    return base


# -- retry discipline --------------------------------------------------------


def backoff_s(request_id: str, attempt: int, retry_after_s: float,
              cap_s: float = _RETRY_CAP_S) -> float:
    """Deterministic crc32-jittered bounded backoff, the exact discipline
    of :class:`delphi_tpu_torch.parallel.resilience.RetryPolicy` with the
    server's ``Retry-After`` as the base: delay doubles per attempt from
    ``retry_after_s``, capped, jittered into [0.5x, 1.0x] by a pure
    function of (request id, attempt) — a replayed run sleeps the same
    schedule."""
    base = min(max(0.0, float(cap_s)),
               max(0.0, float(retry_after_s)) * (2 ** max(attempt - 1, 0)))
    frac = (zlib.crc32(f"{request_id}:{attempt}".encode()) % 1024) / 1024.0
    return round(base * (0.5 + 0.5 * frac), 6)


def _retry_after(headers: Dict[str, Any], default_s: float = 1.0) -> float:
    for key, value in (headers or {}).items():
        if str(key).lower() == "retry-after":
            try:
                return float(value)
            except (TypeError, ValueError):
                break
    return default_s


# -- the open-loop runner ----------------------------------------------------


@dataclass
class RequestRecord:
    """What one request contributed to the ledger. ``latency_s`` is
    measured from the SCHEDULED arrival (so lane head-of-line wait and
    retry backoff count against the SLO, exactly as a user would see
    them); ``outcome`` is one of ``ok`` / ``failed`` / ``shed`` /
    ``gave_up``."""
    request_id: str
    index: int
    segment: str
    kind: str
    fp_index: int
    scheduled_at_s: float
    sent_at_s: float = 0.0
    latency_s: float = 0.0
    status: Optional[int] = None
    outcome: str = "pending"
    worker: Optional[str] = None
    hops: Optional[int] = None
    retries: int = 0
    trace_id: Optional[str] = None


PostFn = Callable[[Dict[str, Any]],
                  Tuple[Optional[int], Dict[str, Any], Dict[str, Any]]]


class OpenLoopRunner:
    """Fires a schedule at a fleet, open-loop.

    The main loop sleeps to each arrival's ``at_s`` and *dispatches*
    without waiting: batch requests get their own thread; chained
    arrivals enqueue onto their lane's FIFO (one thread per lane, seq
    order preserved). Completions never back-pressure the arrival clock
    — the only coupling is the lane-internal ordering the stream
    protocol demands.

    Seams for tests: ``post_fn(payload) -> (status, body, headers)``
    (``status None`` = connection-level failure), ``now_fn`` /
    ``sleep_fn`` (fake clocks), ``on_segment(name)`` fired at each
    segment boundary (the caller uses it to probe metrics and to kill
    the victim worker at ``post_kill``).
    """

    def __init__(self, schedule: List[Arrival],
                 tables: List[Dict[str, Any]], post_fn: PostFn,
                 retry_max: int = _DEF_RETRY_MAX,
                 now_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 on_segment: Optional[Callable[[str], None]] = None
                 ) -> None:
        self.schedule = list(schedule)
        self.tables = tables
        self.post_fn = post_fn
        self.retry_max = max(0, int(retry_max))
        self.now_fn = now_fn
        self.sleep_fn = sleep_fn
        self.on_segment = on_segment
        self.records: List[RequestRecord] = []
        self._records_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._lanes: Dict[str, "queue.Queue[Optional[Arrival]]"] = {}
        self._t0: float = 0.0
        self.dispatched_at: Dict[int, float] = {}  # pacing evidence
        self.duration_s: float = 0.0

    # dispatch --------------------------------------------------------------

    def _elapsed(self) -> float:
        return self.now_fn() - self._t0

    def _record(self, rec: RequestRecord) -> None:
        with self._records_lock:
            self.records.append(rec)

    def _one_request(self, arrival: Arrival) -> None:
        """One request through the bounded-retry ladder. Every terminal
        path lands in exactly one outcome bucket, so the schedule-level
        identity ``sent == answered + shed + gave_up`` cannot drift."""
        rec = RequestRecord(
            request_id=f"load-{arrival.index}", index=arrival.index,
            segment=arrival.segment, kind=arrival.kind,
            fp_index=arrival.fp_index, scheduled_at_s=arrival.at_s)
        rec.sent_at_s = self._elapsed()
        payload = build_payload(arrival, self.tables)
        counter_inc("load.requests")
        attempt = 0
        status: Optional[int] = None
        body: Dict[str, Any] = {}
        headers: Dict[str, Any] = {}
        while True:
            attempt += 1
            status, body, headers = self.post_fn(payload)
            retryable = status is None or (
                status in (429, 503)
                and (body or {}).get("status") == "rejected")
            if not retryable or attempt > self.retry_max:
                break
            rec.retries += 1
            counter_inc("load.retries")
            self.sleep_fn(backoff_s(rec.request_id, attempt,
                                    _retry_after(headers)))
        rec.status = status
        rec.latency_s = round(max(0.0, self._elapsed() - arrival.at_s), 6)
        if status is None:
            rec.outcome = "gave_up"
            counter_inc("load.gave_up")
        elif status in (429, 503) and (body or {}).get("status") \
                == "rejected":
            rec.outcome = "shed"
            counter_inc("load.shed")
        else:
            rec.outcome = "ok" if status == 200 else "failed"
            counter_inc("load.answered")
            counter_inc("load.ok" if status == 200 else "load.failed")
        worker = None
        for key, value in (headers or {}).items():
            lk = str(key).lower()
            if lk == "x-delphi-worker":
                worker = str(value)
            elif lk == "x-delphi-hops":
                try:
                    rec.hops = int(value)
                except (TypeError, ValueError):
                    pass
        rec.worker = worker if worker is not None else (
            str(body["worker_id"]) if isinstance(body, dict)
            and body.get("worker_id") is not None else None)
        if rec.hops is None and isinstance(body, dict) \
                and body.get("hops") is not None:
            try:
                rec.hops = int(body["hops"])
            except (TypeError, ValueError):
                pass
        if isinstance(body, dict) and body.get("trace_id"):
            rec.trace_id = str(body["trace_id"])
        self._record(rec)

    def _lane_loop(self, lane_q: "queue.Queue[Optional[Arrival]]") -> None:
        while True:
            arrival = lane_q.get()
            if arrival is None:
                return
            self._one_request(arrival)

    def _dispatch(self, arrival: Arrival) -> None:
        self.dispatched_at[arrival.index] = self._elapsed()
        if arrival.lane is None:
            t = threading.Thread(target=self._one_request, args=(arrival,),
                                 name=f"delphi-load-{arrival.index}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
            return
        lane_q = self._lanes.get(arrival.lane)
        if lane_q is None:
            lane_q = queue.Queue()
            self._lanes[arrival.lane] = lane_q
            t = threading.Thread(target=self._lane_loop, args=(lane_q,),
                                 name=f"delphi-load-lane-{arrival.lane}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        lane_q.put(arrival)

    def run(self, join_timeout_s: float = 600.0) -> List[RequestRecord]:
        """Paces the whole schedule, then drains lanes and in-flight
        threads. Returns the records (also on ``self.records``)."""
        self._t0 = self.now_fn()
        current_segment: Optional[str] = None
        for arrival in self.schedule:
            if arrival.segment != current_segment:
                current_segment = arrival.segment
                if self.on_segment is not None:
                    try:
                        self.on_segment(arrival.segment)
                    except Exception as e:  # probes must not stop arrivals
                        _logger.warning(
                            f"load segment probe {arrival.segment!r} "
                            f"failed: {e}")
                counter_inc("slo.segments")
            delay = arrival.at_s - self._elapsed()
            if delay > 0:
                self.sleep_fn(delay)
            self._dispatch(arrival)
        for lane_q in self._lanes.values():
            lane_q.put(None)
        deadline = time.monotonic() + max(1.0, join_timeout_s)
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self.duration_s = round(max(self._elapsed(), 1e-9), 6)
        return self.records


# -- the SLO ledger ----------------------------------------------------------


def _percentiles(name: str, values: List[float]) -> Dict[str, Any]:
    """p50/p90/p99 (plus count/mean) through the registry's deterministic
    crc32-seeded reservoir — the same estimator the live histograms use,
    so report and /metrics percentiles agree and replays reproduce."""
    hist = _Histogram(name)
    for v in values:
        hist.observe(float(v))
    s = hist.summary()
    return {"count": s["count"], "mean": s["mean"], "p50": s["p50"],
            "p90": s["p90"], "p99": s["p99"]}


def _bucket(records: List[RequestRecord], wall_s: float) -> Dict[str, Any]:
    sent = len(records)
    by = {"ok": 0, "failed": 0, "shed": 0, "gave_up": 0}
    for r in records:
        by[r.outcome] = by.get(r.outcome, 0) + 1
    answered = by["ok"] + by["failed"]
    answered_lat = [r.latency_s for r in records
                    if r.outcome in ("ok", "failed")]
    return {
        "sent": sent,
        "answered": answered,
        "ok": by["ok"],
        "failed": by["failed"],
        "shed": by["shed"],
        "gave_up": by["gave_up"],
        "retries": sum(r.retries for r in records),
        "duration_s": round(wall_s, 3),
        "qps": round(sent / wall_s, 3) if wall_s > 0 else None,
        "answered_qps": round(answered / wall_s, 3) if wall_s > 0 else None,
        "shed_rate": round(by["shed"] / sent, 6) if sent else 0.0,
        "latency": _percentiles("slo.latency", answered_lat),
    }


def _warm_ratio(counters: Dict[str, float]) -> Optional[float]:
    hits = counters.get("fleet.affinity.hits", 0) \
        + counters.get("fleet.affinity.chain_hits", 0)
    total = hits + counters.get("fleet.affinity.misses", 0)
    return round(hits / total, 6) if total > 0 else None


def slo_section(records: List[RequestRecord], segments: List[Segment],
                duration_s: float,
                segment_counters: Optional[Dict[str, Dict[str, float]]]
                = None,
                autoscale_events: Optional[List[Dict[str, Any]]] = None,
                kill: Optional[Dict[str, Any]] = None,
                recovery_fail_over: float = _DEF_FAIL_OVER
                ) -> Dict[str, Any]:
    """The run report's ``slo`` section (schema v9) from one finished
    load run.

    ``segment_counters`` maps segment name → the *delta* of the shared
    registry's counters over that segment (the caller probes them at
    boundaries) — warm-hit ratio per segment comes from the
    ``fleet.affinity.*`` deltas. The ``recovery`` block is the intra-run
    gate: post-spike and post-kill p99 must be within
    ``recovery_fail_over`` (fractional regression) of steady-state."""
    seg_order = [s.name for s in segments]
    by_segment: Dict[str, List[RequestRecord]] = {n: [] for n in seg_order}
    for r in records:
        by_segment.setdefault(r.segment, []).append(r)
    seg_durations = {s.name: s.duration_s for s in segments}

    per_segment: Dict[str, Any] = {}
    for name in seg_order:
        recs = by_segment.get(name, [])
        bucket = _bucket(recs, seg_durations.get(name, 0.0))
        deltas = (segment_counters or {}).get(name)
        if deltas is not None:
            bucket["warm_hit_ratio"] = _warm_ratio(deltas)
        workers: Dict[str, int] = {}
        for r in recs:
            if r.worker is not None:
                workers[r.worker] = workers.get(r.worker, 0) + 1
        total_w = sum(workers.values())
        bucket["per_worker"] = {
            w: {"requests": c,
                "share": round(c / total_w, 6) if total_w else 0.0}
            for w, c in sorted(workers.items())}
        per_segment[name] = bucket

    overall = _bucket(records, duration_s)
    totals: Dict[str, float] = {}
    for deltas in (segment_counters or {}).values():
        for k, v in deltas.items():
            totals[k] = totals.get(k, 0) + v
    overall["warm_hit_ratio"] = _warm_ratio(totals) \
        if segment_counters else None
    workers_all: Dict[str, int] = {}
    for r in records:
        if r.worker is not None:
            workers_all[r.worker] = workers_all.get(r.worker, 0) + 1
    total_w = sum(workers_all.values())
    overall["per_worker"] = {
        w: {"requests": c,
            "share": round(c / total_w, 6) if total_w else 0.0}
        for w, c in sorted(workers_all.items())}

    mix: Dict[str, int] = {}
    fps = set()
    for r in records:
        mix[r.kind] = mix.get(r.kind, 0) + 1
        fps.add(r.fp_index)

    steady_p99 = (per_segment.get("steady") or {}).get(
        "latency", {}).get("p99")
    recovery: Dict[str, Any] = {"fail_over": recovery_fail_over,
                                "steady_p99_s": steady_p99}
    violations = 0
    for name in ("spike", "post_kill"):
        # the gate reads the segment AFTER the disturbance settled: the
        # spike segment itself may shed; what must recover is post-spike
        # steady behavior. "post_kill" covers both (it follows the spike
        # AND the kill).
        if name == "spike":
            continue
        seg_p99 = (per_segment.get(name) or {}).get(
            "latency", {}).get("p99")
        if steady_p99 is None or seg_p99 is None or steady_p99 <= 0:
            recovery[f"{name}_ok"] = None
            continue
        regression = max(0.0, (seg_p99 - steady_p99) / steady_p99)
        ok = regression <= recovery_fail_over
        recovery[f"{name}_p99_s"] = seg_p99
        recovery[f"{name}_regression"] = round(regression, 6)
        recovery[f"{name}_ok"] = ok
        if not ok:
            violations += 1
    recovery["violations"] = violations
    if violations:
        counter_inc("slo.recovery_violations", violations)

    consistent = overall["sent"] == (overall["answered"] + overall["shed"]
                                     + overall["gave_up"])
    return {
        "requests": {k: overall[k] for k in
                     ("sent", "answered", "ok", "failed", "shed",
                      "gave_up", "retries")},
        "consistent": consistent,
        "duration_s": overall["duration_s"],
        "qps": overall["qps"],
        "answered_qps": overall["answered_qps"],
        "shed_rate": overall["shed_rate"],
        "latency": overall["latency"],
        "warm_hit_ratio": overall["warm_hit_ratio"],
        "per_worker": overall["per_worker"],
        "per_segment": per_segment,
        "segments": [{"name": s.name, "duration_s": round(s.duration_s, 3),
                      "rate_rps": round(s.rate_rps, 3)} for s in segments],
        "mix": mix,
        "distinct_fingerprints": len(fps),
        "recovery": recovery,
        "autoscale": {"events": list(autoscale_events or [])},
        "kill": kill,
    }
