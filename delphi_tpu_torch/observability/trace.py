"""Request traces and the per-launch device-cost ledger.

The port of the JAX package's ``observability/trace.py``. Two halves, one
plane:

* **Request traces** — every run/request gets a ``trace_id``; spans from
  :mod:`delphi_tpu_torch.observability.spans` become Chrome/Perfetto trace
  events carrying ``(trace_id, span_id, parent_span_id)``. A caller joins a
  trace through :func:`request_scope` (an ``X-Delphi-Trace`` header's
  ``<trace_id>:<parent_span_id>``, :func:`parse_header`), and a worker
  thread joins its parent's through :func:`capture` / :func:`adopt`. Each
  process a trace touches writes its own part file
  ``trace.<trace_id>.<pid>.json`` under ``DELPHI_TRACE_DIR`` through the
  durable-store seam (site ``store.trace``); :func:`load_trace` merges the
  parts into one Chrome trace-event document. Sampling is deterministic on
  the trace id (``DELPHI_TRACE_SAMPLE``: keep fraction, default 1.0) so
  every process independently keeps or drops the SAME traces. Disabled (no
  ``DELPHI_TRACE_DIR``) every per-span hook is one thread-local pointer
  check. The serving plane (:mod:`.serve`) opens one request scope per
  HTTP request, and the fleet router (:mod:`.fleet`) carries it to its
  workers.

* **Launch-cost ledger** — each executed launch from
  :mod:`delphi_tpu_torch.parallel.planner` records (phase, bucket shape,
  padded/useful units, plan signature) → measured wall seconds, joined
  after a profiled run with the profiler's device seconds: the
  ``launch:<phase>/<bucket>`` ``record_function`` range opened around each
  launch is intersected with the card's kernel, memcpy and memset
  intervals (:mod:`delphi_tpu_torch.utils.profiling`). Aggregates persist
  beside the PlanStore as ``plans/ledger.<fp>.json`` (envelope-framed,
  site ``store.plan``) and feed ``main.py --plan-report`` — buckets ranked
  by pad-adjusted device milliseconds — and, behind ``DELPHI_PLAN_COST=1``
  (off by default, bit-identical planning when off), the planner's
  bucket-merge choice. The ledger records only while a run recorder is
  active.
"""

import glob
import json
import os
import threading
import time
import uuid
import zlib
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

#: HTTP header carrying ``<trace_id>`` or ``<trace_id>:<parent_span_id>``
#: across the router → worker (and client → server) dispatch seam.
TRACE_HEADER = "X-Delphi-Trace"

_tls = threading.local()
_active_lock = threading.Lock()
#: thread ident -> (thread name, TraceContext) — what the stall watchdog
#: reports so a wedged request is joinable to its exported trace.
_active: Dict[int, Tuple[str, "TraceContext"]] = {}
_flush_lock = threading.Lock()

_ledger_lock = threading.Lock()
#: fingerprint -> phase -> bucket key -> aggregate entry (in-memory, not
#: yet flushed to the plan store).
_ledger: Dict[str, Dict[str, Dict[str, Dict[str, Any]]]] = {}
#: ledger-file path -> parsed doc, the DELPHI_PLAN_COST consult cache
#: (invalidated whenever a flush rewrites the file).
_disk_cache: Dict[str, Optional[Dict[str, Any]]] = {}

_TRUTHY = frozenset({"1", "true", "yes", "on"})

#: A merge candidate is vetoed when the ledger prices the merged bucket's
#: useful unit at more than this multiple of the unmerged bucket's.
MERGE_COST_FACTOR = 1.25


def _counter(name: str, value: int = 1) -> None:
    from delphi_tpu_torch.utils import counter_inc
    counter_inc(name, value)


# -- trace context ----------------------------------------------------------

def trace_root() -> Optional[str]:
    """The trace export directory, or None when tracing is disabled."""
    root = os.environ.get("DELPHI_TRACE_DIR", "").strip()
    return root or None


def sample_rate() -> float:
    raw = os.environ.get("DELPHI_TRACE_SAMPLE", "").strip()
    try:
        rate = float(raw) if raw else 1.0
    except ValueError:
        rate = 1.0
    return min(1.0, max(0.0, rate))


def new_trace_id() -> str:
    return uuid.uuid4().hex


def _sampled(trace_id: str) -> bool:
    """Deterministic on the id, so the router, every worker it dispatches
    to, and the retrain thread all agree on keep-or-drop."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode("utf-8")) % 10000) < rate * 10000


class TraceContext:
    """One thread's view of one trace: the span-id stack, the buffered
    trace events, and the remote parent span (from the header) that roots
    this process's spans under the caller's."""

    __slots__ = ("trace_id", "root", "remote_parent", "stack", "events")

    def __init__(self, trace_id: str, root: str,
                 remote_parent: Optional[str]) -> None:
        self.trace_id = trace_id
        self.root = root
        self.remote_parent = remote_parent
        self.stack: List[str] = []
        self.events: List[Dict[str, Any]] = []


def _current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def current_trace_id() -> Optional[str]:
    ctx = _current()
    return ctx.trace_id if ctx is not None else None


def current_span_id() -> Optional[str]:
    ctx = _current()
    if ctx is None:
        return None
    return ctx.stack[-1] if ctx.stack else ctx.remote_parent


def active_traces() -> Dict[str, str]:
    """thread name -> trace_id for every thread currently inside a trace
    scope (the watchdog's join key between a stall dump and its trace)."""
    with _active_lock:
        return {name: ctx.trace_id for name, ctx in _active.values()}


def active_trace_ids() -> List[str]:
    with _active_lock:
        return sorted({ctx.trace_id for _n, ctx in _active.values()})


def _activate(ctx: TraceContext) -> Optional[TraceContext]:
    prev = _current()
    _tls.ctx = ctx
    with _active_lock:
        _active[threading.get_ident()] = (
            threading.current_thread().name, ctx)
    return prev


def _deactivate(ctx: TraceContext, prev: Optional[TraceContext]) -> None:
    _tls.ctx = prev
    ident = threading.get_ident()
    with _active_lock:
        if prev is not None:
            _active[ident] = (threading.current_thread().name, prev)
        else:
            _active.pop(ident, None)
    _flush_ctx(ctx)


@contextmanager
def request_scope(trace_id: Optional[str] = None,
                  parent_span_id: Optional[str] = None):
    """Activates a trace on this thread for one request/run.  With no
    ``trace_id`` a fresh one is minted (``trace.traces``); an id arriving
    via the header continues the caller's trace (``trace.joins``).  A
    no-op yielding None when tracing is disabled or the id samples out.
    On exit the thread's buffered events flush to this process's part
    file."""
    root = trace_root()
    if root is None:
        yield None
        return
    fresh = trace_id is None
    tid = trace_id or new_trace_id()
    if not _sampled(tid):
        yield None
        return
    ctx = TraceContext(tid, root, parent_span_id)
    _counter("trace.traces" if fresh else "trace.joins")
    prev = _activate(ctx)
    try:
        yield ctx
    finally:
        _deactivate(ctx, prev)


def capture() -> Optional[Dict[str, Any]]:
    """Snapshot of the current trace position, handed to another thread
    (the stream retrain worker) so :func:`adopt` can join it in."""
    ctx = _current()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_span_id": current_span_id()}


@contextmanager
def adopt(snapshot: Optional[Dict[str, Any]]):
    """Joins a thread into the trace captured by :func:`capture` — the
    retrain thread's spans nest under the request span that spawned it.
    ``adopt(None)`` is a no-op scope."""
    if not snapshot or not snapshot.get("trace_id"):
        yield None
        return
    with request_scope(str(snapshot["trace_id"]),
                       snapshot.get("parent_span_id")) as ctx:
        yield ctx


def begin_run_scope() -> Optional[Tuple[TraceContext,
                                        Optional[TraceContext]]]:
    """Non-contextmanager trace activation for ``start_recording`` /
    ``stop_recording`` (the run-level scope whose enter and exit happen
    in different stack frames).  Returns an opaque token for
    :func:`end_run_scope`, or None when tracing is off."""
    root = trace_root()
    if root is None:
        return None
    tid = new_trace_id()
    if not _sampled(tid):
        return None
    ctx = TraceContext(tid, root, None)
    _counter("trace.traces")
    prev = _activate(ctx)
    return ctx, prev


def end_run_scope(token) -> None:
    if token is None:
        return
    ctx, prev = token
    _deactivate(ctx, prev)


# -- header propagation -----------------------------------------------------

def header_value() -> Optional[str]:
    """``<trace_id>:<parent_span_id>`` to stamp on an outbound dispatch,
    or None when no trace is active on this thread."""
    ctx = _current()
    if ctx is None:
        return None
    parent = current_span_id()
    return f"{ctx.trace_id}:{parent}" if parent else ctx.trace_id


def parse_header(value: Optional[str]) -> Tuple[Optional[str],
                                                Optional[str]]:
    """(trace_id, parent_span_id) from an ``X-Delphi-Trace`` header, or
    (None, None) for anything malformed — a bad header must never fail a
    request, only fall back to a fresh trace."""
    if not value or not isinstance(value, str):
        return None, None
    tid, _sep, parent = value.strip().partition(":")
    tid, parent = tid.strip(), parent.strip()
    def _ok(s: str) -> bool:
        return all((c.isascii() and c.isalnum()) or c in "-_" for c in s)

    if not tid or len(tid) > 64 or not _ok(tid):
        return None, None
    if parent and (len(parent) > 64 or not _ok(parent)):
        parent = ""
    return tid, (parent or None)


# -- event emission (spans.py hooks) ----------------------------------------

def span_started(span: Any) -> None:
    """Hook from ``spans.span_enter``: stamps the span with a span id and
    its trace parent, pushes it on this thread's stack.  One pointer
    check when no trace is active."""
    ctx = _current()
    if ctx is None:
        return
    span.span_id = uuid.uuid4().hex[:16]
    span.trace_parent = ctx.stack[-1] if ctx.stack else ctx.remote_parent
    span.trace_t0 = time.time()
    ctx.stack.append(span.span_id)


def span_finished(span: Any, failed: bool = False) -> None:
    """Hook from ``spans.span_exit``: emits one Chrome complete ("X")
    event.  Pops through exception-orphaned children, mirroring
    ``span_exit``'s own stack repair."""
    ctx = _current()
    if ctx is None or getattr(span, "span_id", None) is None:
        return
    while ctx.stack and ctx.stack[-1] != span.span_id:
        ctx.stack.pop()
    if ctx.stack:
        ctx.stack.pop()
    args = {"trace_id": ctx.trace_id, "span_id": span.span_id,
            "parent_span_id": span.trace_parent}
    if failed:
        args["failed"] = True
    ctx.events.append({
        "name": span.name, "ph": "X", "cat": "span",
        "ts": round(span.trace_t0 * 1e6, 3),
        "dur": round(max(0.0, float(span.wall_s or 0.0)) * 1e6, 3),
        "pid": os.getpid(), "tid": threading.get_ident(), "args": args})
    _counter("trace.spans")


def instant(name: str, **args: Any) -> None:
    """An instant event on the active trace (router dispatch decisions,
    shed-hops, re-dispatches).  No-op outside a trace scope."""
    ctx = _current()
    if ctx is None:
        return
    payload = {"trace_id": ctx.trace_id,
               "parent_span_id": current_span_id()}
    payload.update(args)
    ctx.events.append({
        "name": name, "ph": "i", "s": "p", "cat": "trace",
        "ts": round(time.time() * 1e6, 3),
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": payload})


def background_instant(name: str, **args: Any) -> Optional[str]:
    """An instant event from OUTSIDE any request — autoscale decisions,
    scale-up/scale-down lifecycle marks.  :func:`instant` deliberately
    no-ops without an active scope, so this opens a one-event trace of
    its own and flushes it immediately.  Returns the trace id, or None
    when tracing is disabled / the id samples out."""
    with request_scope() as ctx:
        if ctx is None:
            return None
        instant(name, **args)
        return ctx.trace_id


# -- part-file export / merge ----------------------------------------------

def _part_path(root: str, trace_id: str) -> str:
    return os.path.join(root, f"trace.{trace_id}.{os.getpid()}.json")


def _flush_ctx(ctx: TraceContext) -> None:
    """Appends this scope's buffered events to the process part file
    (read-merge-rewrite under a process lock, so the router thread, the
    request worker, and the retrain thread of one trace accumulate into
    one file).  Through the store seam: a torn export quarantines instead
    of producing an unparseable trace."""
    if not ctx.events:
        return
    events, ctx.events = ctx.events, []
    from delphi_tpu_torch.parallel import store as dstore
    path = _part_path(ctx.root, ctx.trace_id)
    try:
        with _flush_lock:
            os.makedirs(ctx.root, exist_ok=True)
            doc, status = dstore.read_json(
                path, schema="trace", site="store.trace", root=ctx.root)
            if status == "ok" and isinstance(doc, dict):
                events = list(doc.get("traceEvents") or []) + events
            dstore.write_json(
                path, {"trace_id": ctx.trace_id, "pid": os.getpid(),
                       "traceEvents": events},
                schema="trace", site="store.trace", root=ctx.root)
        _counter("trace.exports")
    except Exception:  # tracing must never fail the traced request
        pass


def list_traces(root: Optional[str] = None) -> List[str]:
    root = root or trace_root()
    if not root:
        return []
    ids = set()
    for path in glob.glob(os.path.join(root, "trace.*.json")):
        parts = os.path.basename(path).split(".")
        if len(parts) >= 4:
            ids.add(parts[1])
    return sorted(ids)


def load_trace(trace_id: str,
               root: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Merges every process's part file for one trace into a single
    Chrome trace-event document (events sorted by timestamp), or None
    when no part exists."""
    root = root or trace_root()
    if not root or not trace_id or "/" in trace_id:
        return None
    from delphi_tpu_torch.parallel import store as dstore
    events: List[Dict[str, Any]] = []
    pids = set()
    pattern = os.path.join(root, f"trace.{trace_id}.*.json")
    for path in sorted(glob.glob(pattern)):
        doc, status = dstore.read_json(
            path, schema="trace", site="store.trace", root=root)
        if status != "ok" or not isinstance(doc, dict):
            continue
        events.extend(e for e in (doc.get("traceEvents") or [])
                      if isinstance(e, dict))
        pids.add(doc.get("pid"))
    if not events:
        return None
    events.sort(key=lambda e: (e.get("ts") or 0))
    return {"trace_id": trace_id, "displayTimeUnit": "ms",
            "processes": sorted(p for p in pids if p is not None),
            "traceEvents": events}


# -- launch-cost ledger -----------------------------------------------------

def _shape_tag(shape: Any) -> str:
    """Planner shapes mix ints and symbolic tags (mode names, 'host'...);
    every element stringifies into the bucket key, with the characters the
    key format reserves (and path separators) squashed."""
    dims = []
    for d in (shape or ()):
        s = str(int(d)) if isinstance(d, (int, float)) else str(d)
        dims.append("".join(c if (c.isalnum() or c in "-_") else "_"
                            for c in s))
    return "x".join(dims) or "flat"


def bucket_key(launch: Any) -> str:
    """Stable bucket identity shared by the ledger, the per-launch
    ``record_function`` range, and --plan-report: ``<shape>:p<padded>b<batch_pad>``."""
    return f"{_shape_tag(launch.shape)}:p{launch.padded_size}" \
           f"b{launch.batch_pad}"


def launch_annotation(phase: str, launch: Any) -> str:
    return f"launch:{phase}/{bucket_key(launch)}"


def _recorder_active() -> bool:
    from delphi_tpu_torch.observability import spans as _spans
    return _spans._current is not None


@contextmanager
def launch_scope(plan: Any, launch: Any):
    """Wraps the execution of ONE planned launch: measures wall time into
    the in-memory ledger, opens a ``launch:<phase>/<bucket>``
    ``record_function`` range (while a profiler records) so a profiled
    run's device intervals attribute device time back to this bucket, and
    emits a trace event nested under the enclosing phase span.  A launch
    that raises (e.g. the OOM degradation ladder shrinking the batch)
    records nothing — only executed work prices a bucket."""
    if plan is None or launch is None or not _recorder_active():
        yield
        return
    from delphi_tpu_torch.utils import _annotate
    name = launch_annotation(plan.phase, launch)
    ann = _annotate(name)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        if ann is not None:
            ann.__exit__(None, None, None)
        raise
    else:
        if ann is not None:
            ann.__exit__(None, None, None)
        wall_s = time.perf_counter() - t0
        _record_launch(plan, launch, wall_s)
        ctx = _current()
        if ctx is not None:
            ctx.events.append({
                "name": name, "ph": "X", "cat": "launch",
                "ts": round((time.time() - wall_s) * 1e6, 3),
                "dur": round(wall_s * 1e6, 3),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": {"trace_id": ctx.trace_id,
                         "parent_span_id": current_span_id(),
                         "phase": plan.phase,
                         "bucket": bucket_key(launch),
                         "useful_units": launch.useful_units,
                         "padded_units": launch.padded_units,
                         "signature": plan.signature}})


def _record_launch(plan: Any, launch: Any, wall_s: float) -> None:
    from delphi_tpu_torch.parallel import planner
    fp = planner.current_fingerprint() or "local"
    key = bucket_key(launch)
    with _ledger_lock:
        entry = _ledger.setdefault(fp, {}).setdefault(
            plan.phase, {}).setdefault(key, {
                "count": 0, "wall_s": 0.0, "device_s": 0.0,
                "useful_units": 0, "padded_units": 0,
                "signature": plan.signature})
        entry["count"] += 1
        entry["wall_s"] += float(wall_s)
        entry["useful_units"] += int(launch.useful_units)
        entry["padded_units"] += int(launch.padded_units)
        entry["signature"] = plan.signature
    _counter("launch.ledger.records")


def ledger_summary() -> Optional[Dict[str, Any]]:
    """The run report's ``launch_costs`` section: the not-yet-flushed
    in-memory aggregates plus totals.  None when nothing was recorded."""
    with _ledger_lock:
        if not _ledger:
            return None
        fingerprints = json.loads(json.dumps(_ledger))  # deep copy
    total_wall = total_device = 0.0
    n_buckets = 0
    for phases in fingerprints.values():
        for buckets in phases.values():
            for entry in buckets.values():
                total_wall += entry["wall_s"]
                total_device += entry["device_s"]
                n_buckets += 1
    return {"fingerprints": fingerprints, "buckets": n_buckets,
            "wall_s": round(total_wall, 6),
            "device_s": round(total_device, 6)}


def attach_device_costs(events: Optional[List[Any]]) -> Dict[str, float]:
    """Joins a profiled run's normalized records
    (:mod:`delphi_tpu_torch.utils.profiling`) against the per-launch
    ranges: for every ``launch:...`` range, the overlapped device
    nanoseconds become that bucket's ``device_s`` in the in-memory ledger
    (flushed afterwards by ``stop_recording``). Returns {range name:
    device_s}."""
    try:
        from delphi_tpu_torch.utils import profiling
        if not events:
            return {}
        names = {e.name for e in events
                 if e.kind == profiling.ANNOTATION
                 and e.name.startswith("launch:")}
        if not names:
            return {}
        windows = profiling.annotation_windows(events, names)
        exec_iv = profiling.device_intervals(events)
        out: Dict[str, float] = {}
        for name, iv in windows.items():
            device_s = profiling.overlap_ns(iv, exec_iv) / 1e9
            out[name] = device_s
            body = name[len("launch:"):]
            phase, _sep, bucket = body.partition("/")
            with _ledger_lock:
                for phases in _ledger.values():
                    entry = phases.get(phase, {}).get(bucket)
                    if entry is not None:
                        entry["device_s"] += device_s
        return out
    except Exception:  # attribution is best-effort evidence
        return {}


def _ledger_root(root: Optional[str] = None) -> Optional[str]:
    if root:
        return root
    from delphi_tpu_torch.parallel import planner
    store = planner.get_plan_store()
    return store.root if store is not None else None


def flush_ledger(root: Optional[str] = None) -> int:
    """Persists and clears the in-memory ledger: per fingerprint, a
    ``ledger.<fp>.json`` beside the launch plans, merged with any prior
    generations (counts/seconds/units summed).  No plan store armed →
    aggregates stay in memory for a later flush.  Returns the number of
    ledger files written."""
    root = _ledger_root(root)
    if root is None:
        return 0
    with _ledger_lock:
        if not _ledger:
            return 0
        snapshot = dict(_ledger)
        _ledger.clear()
    from delphi_tpu_torch.parallel import store as dstore
    written = 0
    for fp, phases in sorted(snapshot.items()):
        path = os.path.join(root, f"ledger.{fp}.json")
        try:
            os.makedirs(root, exist_ok=True)
            doc, status = dstore.read_json(
                path, schema="launch_ledger", site="store.plan", root=root)
            if status != "ok" or not isinstance(doc, dict):
                doc = {"fingerprint": fp, "phases": {}}
            for phase, buckets in phases.items():
                slot = doc.setdefault("phases", {}).setdefault(phase, {})
                for key, entry in buckets.items():
                    prior = slot.get(key)
                    if prior is None:
                        slot[key] = dict(entry)
                    else:
                        for field in ("count", "wall_s", "device_s",
                                      "useful_units", "padded_units"):
                            prior[field] = prior.get(field, 0) \
                                + entry[field]
                        prior["signature"] = entry["signature"]
            dstore.write_json(path, doc, schema="launch_ledger",
                              site="store.plan", root=root)
            _disk_cache.pop(path, None)
            written += 1
        except Exception:  # the ledger must never fail the run it prices
            continue
    if written:
        _counter("launch.ledger.flushes", written)
    return written


def load_ledger(fp: str,
                root: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """One fingerprint's persisted ledger doc (consult-cached), or
    None."""
    root = _ledger_root(root)
    if root is None:
        return None
    path = os.path.join(root, f"ledger.{fp}.json")
    if path in _disk_cache:
        return _disk_cache[path]
    from delphi_tpu_torch.parallel import store as dstore
    doc, status = dstore.read_json(path, schema="launch_ledger",
                                   site="store.plan", root=root)
    doc = doc if status == "ok" and isinstance(doc, dict) else None
    if doc is not None:
        _counter("launch.ledger.loads")
    _disk_cache[path] = doc
    return doc


def reset_state() -> None:
    """Test hook: drops in-memory aggregates and the consult cache."""
    with _ledger_lock:
        _ledger.clear()
    _disk_cache.clear()


# -- the DELPHI_PLAN_COST planner gate --------------------------------------

def plan_cost_enabled() -> bool:
    return os.environ.get(
        "DELPHI_PLAN_COST", "").strip().lower() in _TRUTHY


def _unit_cost(entry: Optional[Dict[str, Any]]) -> Optional[float]:
    """Measured seconds per USEFUL unit — padding is priced implicitly,
    since a padded launch burns device time its useful units must carry.
    Prefers device seconds (the honest number) over wall."""
    if not entry:
        return None
    useful = entry.get("useful_units") or 0
    if useful <= 0:
        return None
    cost = entry.get("device_s") or 0.0
    if cost <= 0.0:
        cost = entry.get("wall_s") or 0.0
    return (cost / useful) if cost > 0.0 else None


def merge_allowed(fingerprint: Optional[str], phase: str, shape: Any,
                  from_size: int, to_size: int,
                  root: Optional[str] = None) -> bool:
    """DELPHI_PLAN_COST consult: may the planner merge the ``from_size``
    bucket up into ``to_size``?  Vetoes only when the ledger has priced
    BOTH buckets and the merged one costs > MERGE_COST_FACTOR× more per
    useful unit — no data, no opinion (the merge proceeds as in the
    count-only heuristic)."""
    _counter("launch.ledger.consults")
    doc = load_ledger(fingerprint or "local", root=root)
    if doc is None:
        return True
    buckets = (doc.get("phases") or {}).get(phase)
    if not buckets:
        # per-chunk phases record as "<phase>[i]" — aggregate any match
        merged: Dict[str, Dict[str, Any]] = {}
        for name, bk in (doc.get("phases") or {}).items():
            base = name.split("[", 1)[0]
            if base != phase:
                continue
            for key, entry in bk.items():
                slot = merged.setdefault(key, {
                    "count": 0, "wall_s": 0.0, "device_s": 0.0,
                    "useful_units": 0, "padded_units": 0})
                for field in ("count", "wall_s", "device_s",
                              "useful_units", "padded_units"):
                    slot[field] += entry.get(field, 0)
        buckets = merged
    if not buckets:
        return True
    shape_tag = _shape_tag(shape)

    def _entry(size: int) -> Optional[Dict[str, Any]]:
        prefix = f"{shape_tag}:p{size}b"
        found = None
        for key, entry in buckets.items():
            if key.startswith(prefix):
                if found is None:
                    found = dict(entry)
                else:
                    for field in ("count", "wall_s", "device_s",
                                  "useful_units", "padded_units"):
                        found[field] = found.get(field, 0) \
                            + entry.get(field, 0)
        return found

    from_cost = _unit_cost(_entry(from_size))
    to_cost = _unit_cost(_entry(to_size))
    if from_cost is None or to_cost is None:
        return True
    if to_cost > from_cost * MERGE_COST_FACTOR:
        _counter("launch.ledger.merge_vetoes")
        return False
    return True


# -- reporting --------------------------------------------------------------

def run_trace_info() -> Optional[Dict[str, Any]]:
    """The run report's ``trace`` section for the currently active
    scope, or a pointer-only stub when tracing is armed but this thread
    holds no scope."""
    root = trace_root()
    if root is None:
        return None
    info: Dict[str, Any] = {"dir": root, "sample": sample_rate()}
    tid = current_trace_id()
    if tid is not None:
        info["trace_id"] = tid
    return info


def finalize_run(recorder: Any) -> None:
    """``stop_recording`` hook: joins the profiler's device time into the
    ledger (when the run was profiled), stamps the recorder with the
    report's ``trace``/``launch_costs`` sections, then flushes the ledger
    to the plan store.  Best-effort — observability never fails the
    run."""
    try:
        events = getattr(recorder, "device_events", None)
        if events:
            attach_device_costs(events)
        recorder.trace_info = run_trace_info()
        recorder.launch_costs = ledger_summary()
        flush_ledger()
    except Exception:
        pass


def plan_report(root: str) -> Dict[str, Any]:
    """``main.py --plan-report``: every persisted ledger under ``root``
    (a plans dir, or a serve cache dir containing one), buckets ranked
    by pad-adjusted device milliseconds — total measured cost scaled by
    padded/useful, i.e. what the bucket WOULD cost if every unit it
    launched were real work. It reads ledgers of either package."""
    candidates = [root, os.path.join(root, "plans")]
    ledger_root = next(
        (c for c in candidates
         if glob.glob(os.path.join(c, "ledger.*.json"))), root)
    from delphi_tpu_torch.parallel import store as dstore
    rows: List[Dict[str, Any]] = []
    n_ledgers = 0
    for path in sorted(glob.glob(
            os.path.join(ledger_root, "ledger.*.json"))):
        doc, status = dstore.read_json(
            path, schema="launch_ledger", site="store.plan",
            root=ledger_root)
        if status != "ok" or not isinstance(doc, dict):
            continue
        n_ledgers += 1
        fp = doc.get("fingerprint") or \
            os.path.basename(path)[len("ledger."):-len(".json")]
        for phase, buckets in sorted((doc.get("phases") or {}).items()):
            for key, entry in sorted(buckets.items()):
                useful = entry.get("useful_units") or 0
                padded = entry.get("padded_units") or 0
                device_s = entry.get("device_s") or 0.0
                wall_s = entry.get("wall_s") or 0.0
                cost_ms = (device_s if device_s > 0.0 else wall_s) * 1e3
                pad_factor = (padded / useful) if useful > 0 else 1.0
                rows.append({
                    "fingerprint": fp, "phase": phase, "bucket": key,
                    "launches": entry.get("count", 0),
                    "useful_units": useful, "padded_units": padded,
                    "pad_waste": round(1.0 - (useful / padded), 4)
                    if padded > 0 else 0.0,
                    "device_ms": round(device_s * 1e3, 3),
                    "wall_ms": round(wall_s * 1e3, 3),
                    "pad_adjusted_device_ms":
                        round(cost_ms * pad_factor, 3),
                })
    rows.sort(key=lambda r: (-r["pad_adjusted_device_ms"],
                             r["fingerprint"], r["phase"], r["bucket"]))
    return {"root": ledger_root, "ledgers": n_ledgers,
            "buckets": rows}
