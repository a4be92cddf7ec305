"""Resilience plane: the guarded seam every device launch and upload of the
port runs behind, the fault-injection harness, the phase-checkpoint store
and the backend-init deadline probe. The JAX package's module, name for
name.

Each guarded call site wraps its launch in :func:`run_guarded`, which

* **classifies** a raised exception into the fault taxonomy
  (``init_timeout`` / ``oom`` / ``transfer`` / ``compile`` / ``transient``
  / ``rank_loss`` / ``store_corrupt``) with :func:`classify_fault`. An
  unclassifiable exception is a program bug and re-raises at once; so do a
  failed kernel build or launch and a sticky CUDA error (an illegal
  address, a device-side assert), which no retry can cure;
* **retries** a classified fault with bounded exponential backoff and
  deterministic jitter (:class:`RetryPolicy`);
* when the retries run out, walks the **degradation ladder**: *shrink*
  (:class:`ShrinkBatch` tells the call site to halve its batch), then
  *evict* (the caller's ``evict`` callback drops device-resident buffers),
  then *CPU*, and only then re-raises. The CPU rung latches only on a run
  whose device is the CPU, where it moves nothing and keeps the JAX
  package's counters and notes; on a run on the card it is refused
  (counted as ``resilience.degrade.cpu_refused`` and noted) and the
  classified fault re-raises, so no work leaves the card unasked.

Every event counts in ``utils.counters`` as ``resilience.*``, and each
degradation is stamped into the provenance ledger as a run note.

**Fault injection** (``DELPHI_FAULT_PLAN``, else the session conf
``repair.fault.plan``): comma-separated ``site:nth:kind`` triples, or
``rank:site:nth:kind``; ``site`` is an ``fnmatch`` pattern over
:data:`KNOWN_SITES`, ``nth`` the 1-based count of entries into that site
(attempts count), ``kind`` a taxonomy kind, ``fatal`` (unclassifiable),
``stall`` (wedge the thread), ``rank_death`` (exit 17), ``crash`` (exit
23) or ``torn_write`` (the store truncates the file). Each entry fires
once, and an injected fault carries the runtime's own wording, so the real
classifier runs.

**Phase checkpoints** (``DELPHI_CHECKPOINT_DIR`` / ``repair.checkpoint.dir``):
:class:`PhaseCheckpointStore` keeps each phase's outputs under a
fingerprint of the input and options, so a run that died resumes at the
last completed phase. Pickles carry no CUDA tensor.

**Request scopes** carry a per-request plan, deadline, abort and CPU latch
and checkpoint directory; the serving plane
(:mod:`delphi_tpu_torch.observability.serve`) opens one per request, and
the live plane's stall watchdog calls :func:`on_watchdog_stall`.
"""

import contextlib
import fnmatch
import hashlib
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from delphi_tpu_torch.ops.kernels.build import (KernelBuildError,
                                                KernelLaunchError)
from delphi_tpu_torch.utils import (counter_inc, current_phase,
                                    histogram_observe, setup_logger)

_logger = setup_logger()

_FALSY = frozenset({"0", "false", "no", "off"})

# -- fault taxonomy ----------------------------------------------------------

KIND_INIT_TIMEOUT = "init_timeout"
KIND_OOM = "oom"
KIND_TRANSFER = "transfer"
KIND_COMPILE = "compile"
KIND_TRANSIENT = "transient"
KIND_RANK_LOSS = "rank_loss"
KIND_STORE_CORRUPT = "store_corrupt"
FAULT_KINDS = (KIND_INIT_TIMEOUT, KIND_OOM, KIND_TRANSFER, KIND_COMPILE,
               KIND_TRANSIENT, KIND_RANK_LOSS, KIND_STORE_CORRUPT)


class BackendInitTimeout(RuntimeError):
    """The backend-init probe hit its deadline: raised instead of
    stalling the run forever."""


class RankLost(RuntimeError):
    """A peer rank died or wedged during a cross-rank interaction
    (classified ``rank_loss``; :mod:`delphi_tpu_torch.parallel.
    dist_resilience` raises it when a collective without a local fallback
    fails)."""


class StoreCorrupt(RuntimeError):
    """A durable-store envelope failed validation (truncated payload, crc
    mismatch, garbled header). The store catches it and reads the file as
    a quarantined miss; classified ``store_corrupt``."""


class FaultInjected(BaseException):
    """An exception the fault plan injected, worded as the runtime words
    the real fault. BaseException, as in the JAX package: no ``except
    Exception`` fallback may absorb a fault the seam could not handle."""

    def __init__(self, kind: str, site: str, n: int) -> None:
        self.kind = kind
        super().__init__(_INJECT_MESSAGES.get(kind, _INJECT_MESSAGES["fatal"])
                         .format(site=site, n=n))


class ShrinkBatch(Exception):
    """The ladder chose 'shrink': the call site halves its batch and runs
    the guarded launch on each half (the results are value-identical)."""


class RunAborted(BaseException):
    """Raised at the next seam entry or phase boundary after
    :func:`request_abort`. BaseException: an abort ends the run."""


class DeadlineExceeded(BaseException):
    """A request scope's deadline expired (at a seam entry, a phase
    boundary, or when the next retry would sleep past it)."""


_INJECT_MESSAGES = {
    KIND_OOM: ("RESOURCE_EXHAUSTED: out of memory while trying to allocate "
               "buffer (injected at {site} call {n})"),
    KIND_INIT_TIMEOUT: ("DEADLINE_EXCEEDED: backend initialization timed "
                        "out (injected at {site} call {n})"),
    KIND_TRANSFER: ("INTERNAL: failed to transfer buffer to device "
                    "(injected at {site} call {n})"),
    KIND_COMPILE: ("INVALID_ARGUMENT: XLA compilation failed for module "
                   "(injected at {site} call {n})"),
    KIND_TRANSIENT: ("UNAVAILABLE: connection to coordination service "
                     "lost (injected at {site} call {n})"),
    KIND_RANK_LOSS: ("DEADLINE_EXCEEDED: collective operation timed out "
                     "waiting for remote ranks (injected at {site} "
                     "call {n})"),
    KIND_STORE_CORRUPT: ("durable store envelope failed checksum "
                         "validation (injected at {site} call {n})"),
    "torn_write": ("durable store write torn mid-flight "
                   "(injected at {site} call {n})"),
    "fatal": "injected unclassifiable fault at {site} call {n}",
}

#: Plan kinds that do not raise: ``stall`` wedges the calling thread,
#: ``rank_death`` exits with code 17, ``crash`` exits with code 23 (at a
#: store site: the temporary file written, the rename not landed).
SPECIAL_INJECT_KINDS = frozenset({"stall", "rank_death", "crash"})

#: Plan kinds the durable store handles itself: ``torn_write`` truncates
#: the destination and the writer believes it succeeded.
STORE_INJECT_KINDS = frozenset({"torn_write"})

# The JAX package's patterns: case-sensitive status codes, then lower-case
# word patterns; the first matching kind wins.
_CODE_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    (KIND_OOM, re.compile(r"RESOURCE_EXHAUSTED")),
    (KIND_TRANSIENT, re.compile(r"UNAVAILABLE|ABORTED|DATA_LOSS"
                                r"|INTERNAL: RecvBuf|INTERNAL: Failed to "
                                r"complete all kernels")),
)
_WORD_PATTERNS: Tuple[Tuple[str, "re.Pattern"], ...] = (
    (KIND_INIT_TIMEOUT, re.compile(
        r"backend.{0,40}init\w*.{0,40}(timed out|timeout|deadline)"
        r"|init\w*.{0,40}(timed out|deadline exceeded)"
        r"|deadline_exceeded.{0,60}init", re.IGNORECASE | re.DOTALL)),
    (KIND_RANK_LOSS, re.compile(
        r"collective.{0,60}(timed out|timeout|deadline)"
        r"|(rank|peer|process \d+).{0,40}"
        r"(lost|died|unreachable|disconnected|terminated)"
        r"|heartbeat.{0,40}(missed|stale|timed out)"
        r"|barrier.{0,40}(timed out|timeout)"
        r"|shutting down.{0,40}coordination service"
        # gloo, the port's collective transport: a peer that exited, a
        # reset of its socket, a send or receive past the group's timeout
        r"|connection closed by peer.{0,200}remote worker"
        r"|gloo.{0,200}connection (closed|reset) by peer"
        r"|timed out waiting \d+\s*ms for (send|recv)",
        re.IGNORECASE | re.DOTALL)),
    (KIND_OOM, re.compile(
        r"out of memory|\boom\b|exhausted|failed to allocate"
        r"|allocation.{0,30}(failed|exceed)|hbm.{0,30}exceed",
        re.IGNORECASE | re.DOTALL)),
    (KIND_TRANSFER, re.compile(
        r"failed to transfer|transfer.{0,30}(buffer|failed|error)"
        r"|copy.{0,20}to device|TransferTo\w+|device buffer.{0,20}"
        r"(lost|invalid|deleted)", re.IGNORECASE | re.DOTALL)),
    (KIND_COMPILE, re.compile(
        r"compil\w+.{0,30}(failed|error)|failed.{0,30}compil"
        r"|xla.{0,30}lower|lowering.{0,20}(failed|error)|mosaic",
        re.IGNORECASE | re.DOTALL)),
    (KIND_TRANSIENT, re.compile(
        r"connection (reset|refused|closed)|socket closed|broken pipe"
        r"|temporarily unavailable|try again", re.IGNORECASE | re.DOTALL)),
    (KIND_STORE_CORRUPT, re.compile(
        r"store (envelope|write).{0,50}"
        r"(checksum|crc|truncat|corrupt|torn)"
        r"|envelope.{0,30}failed checksum", re.IGNORECASE | re.DOTALL)),
)

# CUDA errors that poison the context: every later call fails alike, so a
# retry or a rung of the ladder would only hide the first one
_STICKY_CUDA = re.compile(
    r"illegal memory access|illegal address|illegal instruction"
    r"|misaligned address|device-side assert|unspecified launch failure"
    r"|uncorrectable ECC error|hardware stack error"
    r"|cudaErrorIllegal|cudaErrorLaunchFailure|cudaErrorAssert",
    re.IGNORECASE)


def _is_dist_backend_error(exc: BaseException) -> bool:
    """``torch.distributed.DistBackendError``: a collective's backend
    failed, which on this plane means a peer is gone."""
    import torch
    dist = getattr(torch, "distributed", None)
    err = getattr(dist, "DistBackendError", None) if dist else None
    return err is not None and isinstance(exc, err)


def classify_fault(exc: BaseException) -> Optional[str]:
    """Maps an exception to a fault kind, or None for one that must
    re-raise unretried: program bugs, the plane's own control exceptions,
    a failed kernel build or launch, and sticky CUDA errors.
    ``torch.cuda.OutOfMemoryError`` classifies as ``oom``."""
    if isinstance(exc, (ShrinkBatch, RunAborted, DeadlineExceeded,
                        KernelBuildError, KernelLaunchError)):
        return None
    if isinstance(exc, BackendInitTimeout):
        return KIND_INIT_TIMEOUT
    if isinstance(exc, RankLost) or _is_dist_backend_error(exc):
        return KIND_RANK_LOSS
    if isinstance(exc, StoreCorrupt):
        return KIND_STORE_CORRUPT
    msg = f"{type(exc).__name__}: {exc}"
    if not isinstance(exc, FaultInjected) and _STICKY_CUDA.search(msg):
        return None
    if type(exc).__name__ == "OutOfMemoryError" \
            and type(exc).__module__.startswith("torch"):
        return KIND_OOM
    # init_timeout and rank_loss outrank the codes: both typically arrive
    # spelled DEADLINE_EXCEEDED/UNAVAILABLE
    for kind, pat in _WORD_PATTERNS[:2]:
        if pat.search(msg):
            return kind
    for kind, pat in _CODE_PATTERNS:
        if pat.search(msg):
            return kind
    for kind, pat in _WORD_PATTERNS[2:]:
        if pat.search(msg):
            return kind
    return None


# -- retry policy ------------------------------------------------------------

_RETRY_CAP_S = 5.0


def _env_or_conf(env: str, conf_key: str, cast, default):
    raw = os.environ.get(env)
    if raw is None or not raw.strip():
        from delphi_tpu_torch.session import get_session
        raw = get_session().conf.get(conf_key)
        if raw is None or not str(raw).strip():
            return default
    try:
        return cast(str(raw).strip())
    except (TypeError, ValueError):
        _logger.warning(f"{env}/{conf_key}: unparsable value {raw!r}, "
                        f"using default {default!r}")
        return default


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter: the delay of
    (site, attempt) is a pure function (a crc32-derived fraction), so a
    replayed plan sleeps the same schedule as in the JAX package."""

    def __init__(self, max_retries: int = 2, base_s: float = 0.05,
                 cap_s: float = _RETRY_CAP_S) -> None:
        self.max_retries = max(0, int(max_retries))
        self.base_s = max(0.0, float(base_s))
        self.cap_s = max(self.base_s, float(cap_s))

    def backoff_s(self, site: str, attempt: int) -> float:
        base = min(self.cap_s, self.base_s * (2 ** max(attempt - 1, 0)))
        frac = (zlib.crc32(f"{site}:{attempt}".encode()) % 1024) / 1024.0
        return round(base * (0.5 + 0.5 * frac), 6)


def default_policy() -> RetryPolicy:
    """``DELPHI_RETRY_MAX`` retries per guarded call (default 2) starting at
    ``DELPHI_RETRY_BASE_S`` seconds (default 0.05), doubling up to 5 s;
    session conf ``repair.resilience.retry_max`` /
    ``repair.resilience.retry_base_s``."""
    return RetryPolicy(
        max_retries=_env_or_conf("DELPHI_RETRY_MAX",
                                 "repair.resilience.retry_max", int, 2),
        base_s=_env_or_conf("DELPHI_RETRY_BASE_S",
                            "repair.resilience.retry_base_s", float, 0.05))


# -- fault injection ---------------------------------------------------------

#: Every site name of the JAX package's guarded seam, so one plan text
#: validates alike in both packages. The port enters each of them but
#: ``freq.pairs``, the JAX package's XLA pair-count route (noted beside
#: it).
KNOWN_SITES = frozenset({
    "backend.init",
    "xfer.upload",
    "freq.singles",
    # the JAX package's XLA pair-count route: the port counts every pair
    # with kernel K1, under freq.pairs_pallas
    "freq.pairs",
    "freq.pairs_pallas",
    "freq.distinct",
    # the process-local tables' distinct-count merge
    "freq.distinct_merge",
    # the fleet router and the autoscaler (observability/fleet.py)
    "fleet.dispatch",
    "autoscale.http",
    "domain.score",
    "domain.weak_label",
    # the launch planner's bucketed domain launches
    "domain.bucket",
    "detect.percentile",
    "detect.rank",
    "detect.sorted_count",
    "detect.group_extrema",
    "gbdt.cv_chunk",
    "gbdt.fit_chunk",
    "escalate.joint",
    # cross-rank collectives (parallel/distributed.py, dist_resilience.py)
    "dist.heartbeat",
    "dist.allgather_bytes",
    "dist.allgather_sum",
    "dist.allgather_any",
    "dist.allgather_max",
    # the multi-host run report
    "report.gather",
    # the row-shard plane's merges (parallel/rowshard.py)
    "shard.detect.merge",
    "shard.freq.merge",
    "shard.distinct.merge",
    "shard.entropy.merge",
    "shard.domain.weak",
    # the durable store's sites (parallel/store.py STORE_SITES)
    "store.plan",
    "store.checkpoint",
    "store.model",
    "store.manifest",
    "store.snapshot_state",
    "store.provenance",
    "store.report",
    "store.fleet",
    "store.fsck",
    "store.stream_cursor",
    "store.stream_state",
    "store.trace",
})

_PLAN_RE = re.compile(r"^\s*([^:\s]+)\s*:\s*(\d+)\s*:\s*([a-z_]+)\s*$")
_PLAN_RANK_RE = re.compile(r"^\s*([^:\s]+)\s*:\s*([^:\s]+)\s*:"
                           r"\s*(\d+)\s*:\s*([a-z_]+)\s*$")

_PLAN_KINDS = frozenset(FAULT_KINDS) | {"fatal"} | SPECIAL_INJECT_KINDS \
    | STORE_INJECT_KINDS


def parse_fault_plan(text: str) -> Tuple[Tuple[Any, ...], ...]:
    """``(site, nth, kind)`` per triple, with the rank pattern as a fourth
    element for ``rank:site:nth:kind``. Raises ``ValueError`` on a
    malformed entry, an unknown kind or an ``nth`` below 1."""
    triples = []
    for part in text.split(","):
        if not part.strip():
            continue
        m = _PLAN_RE.match(part)
        rank_pat = None
        if m is None:
            m4 = _PLAN_RANK_RE.match(part)
            if not m4:
                raise ValueError(
                    f"DELPHI_FAULT_PLAN: bad triple {part!r} "
                    "(expected site:nth:kind or rank:site:nth:kind)")
            rank_pat, pat, nth, kind = (m4.group(1), m4.group(2),
                                        int(m4.group(3)), m4.group(4))
        else:
            pat, nth, kind = m.group(1), int(m.group(2)), m.group(3)
        if kind not in _PLAN_KINDS:
            raise ValueError(
                f"DELPHI_FAULT_PLAN: unknown fault kind {kind!r} "
                f"(one of {', '.join(FAULT_KINDS)}, fatal, "
                f"{', '.join(sorted(SPECIAL_INJECT_KINDS))})")
        if nth < 1:
            raise ValueError("DELPHI_FAULT_PLAN: nth is 1-based")
        triples.append((pat, nth, kind) if rank_pat is None
                       else (pat, nth, kind, rank_pat))
    return tuple(triples)


def _injection_rank() -> str:
    """The process index rank-scoped entries match: ``DELPHI_PROCESS_ID``
    when it is set, else the rank of the joined process group
    (:func:`delphi_tpu_torch.parallel.distributed.process_index`, 0 before
    a join)."""
    env = os.environ.get("DELPHI_PROCESS_ID", "")
    if env.strip().isdigit():
        return env.strip()
    from delphi_tpu_torch.parallel import distributed
    return str(distributed.process_index())


def _entry_hit(entry: Tuple[Any, ...], site: str, n: int,
               rank_text: Optional[str]) -> Optional[str]:
    """The kind to fire when plan ``entry`` matches this (site, entry
    count) on this rank, else None."""
    pat, nth, kind = entry[0], entry[1], entry[2]
    if nth != n or not fnmatch.fnmatchcase(site, pat):
        return None
    if len(entry) > 3 and entry[3] is not None:
        if not fnmatch.fnmatchcase(
                rank_text if rank_text is not None else _injection_rank(),
                entry[3]):
            return None
    return kind


def _fault_plan_text() -> str:
    env = os.environ.get("DELPHI_FAULT_PLAN")
    if env is not None:
        return env
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.fault.plan")
    return str(conf) if conf else ""


_plan_lock = threading.Lock()
_plan_state: Dict[str, Any] = {"text": None, "triples": (), "fired": set(),
                               "calls": {}}
_validated_plans: set = set()


def validate_fault_plan(triples: Sequence[Tuple[Any, ...]],
                        source: str = "DELPHI_FAULT_PLAN") -> Tuple[str, ...]:
    """The plan's site patterns that match no :data:`KNOWN_SITES` entry
    (they can never fire): warned once per (source, patterns) and counted
    in ``resilience.plan.unmatched`` once per pattern."""
    unmatched = tuple(sorted(
        {entry[0] for entry in triples
         if not any(fnmatch.fnmatchcase(s, entry[0])
                    for s in KNOWN_SITES)}))
    if unmatched:
        key = (source, unmatched)
        with _plan_lock:
            first = key not in _validated_plans
            if first:
                _validated_plans.add(key)
        if first:
            for _ in unmatched:
                counter_inc("resilience.plan.unmatched")
            _logger.warning(
                f"{source}: fault-plan site pattern(s) "
                f"{', '.join(repr(p) for p in unmatched)} match no "
                f"registered guarded site — these triples will never fire. "
                f"Known sites: {', '.join(sorted(KNOWN_SITES))}")
    return unmatched


def reset_fault_state() -> None:
    """Forgets fired entries, per-site entry counts and validation warnings
    (a test or a script that replays a plan in one process)."""
    with _plan_lock:
        _plan_state.update(text=None, triples=(), fired=set(), calls={})
        _validated_plans.clear()


def _stall_forever() -> None:
    """Wedges the calling thread (the injected ``stall``); tests patch it."""
    threading.Event().wait()


def _fire_injection(kind: str, site: str, n: int, source: str) -> None:
    """Fires one matched entry: the special kinds wedge or exit, every
    other kind raises :class:`FaultInjected`."""
    counter_inc("resilience.injected")
    _logger.warning(f"{source}: injecting {kind} at {site} (call {n})")
    if kind == "stall":
        _stall_forever()
        return
    if kind == "rank_death":
        os._exit(17)
    if kind == "crash":
        # at a store site: the temporary file is on disk, the rename has
        # not landed
        os._exit(23)
    raise FaultInjected(kind, site, n)


def _maybe_inject(site: str) -> None:
    scope = current_scope()
    if scope is not None:
        # a request scope owns injection: the process plan is not read
        scope.maybe_inject(site)
        return
    text = _fault_plan_text()
    armed = None
    with _plan_lock:
        if text != _plan_state["text"]:
            _plan_state.update(text=text,
                               triples=parse_fault_plan(text) if text else (),
                               fired=set(), calls={})
            armed = _plan_state["triples"]
        triples = _plan_state["triples"]
        if not triples:
            return
        n = _plan_state["calls"].get(site, 0) + 1
        _plan_state["calls"][site] = n
        rank_text = _injection_rank() \
            if any(len(t) > 3 for t in triples) else None
        hit = None
        for i, entry in enumerate(triples):
            if i in _plan_state["fired"]:
                continue
            kind = _entry_hit(entry, site, n, rank_text)
            if kind is not None:
                _plan_state["fired"].add(i)
                hit = (kind, n)
                break
    if armed:
        validate_fault_plan(armed)
    if hit is not None:
        _fire_injection(hit[0], site, hit[1], "fault plan")


# -- request scopes ----------------------------------------------------------

_scope_tls = threading.local()


class RequestScope:
    """Per-request resilience state: a private fault plan (fire-once and
    entry counts of its own), a deadline, abort and CPU latches, and an
    optional checkpoint-directory override. While a scope is active on a
    thread, the process-wide plan and latches are neither read nor
    written."""

    def __init__(self, request_id: str, *, fault_plan: str = "",
                 deadline_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None) -> None:
        self.request_id = str(request_id)
        self.plan_triples = parse_fault_plan(fault_plan) if fault_plan else ()
        if self.plan_triples:
            validate_fault_plan(self.plan_triples,
                                f"request {self.request_id} fault plan")
        self.deadline_at = (time.monotonic() + float(deadline_s)
                            if deadline_s is not None and float(deadline_s) > 0
                            else None)
        self.checkpoint_dir = checkpoint_dir
        self.abort_reason: Optional[str] = None
        self.cpu_latch: Dict[str, Any] = {"active": False, "site": None}
        self._lock = threading.Lock()
        self._fired: set = set()
        self._calls: Dict[str, int] = {}

    def remaining_s(self) -> Optional[float]:
        """Seconds to the deadline (negative once past), None without
        one."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0.0

    def request_abort(self, reason: str) -> None:
        """Arms this request's abort latch only."""
        if self.abort_reason is None:
            self.abort_reason = str(reason)
            counter_inc("resilience.aborts_requested")

    def maybe_inject(self, site: str) -> None:
        if not self.plan_triples:
            return
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            rank_text = _injection_rank() \
                if any(len(t) > 3 for t in self.plan_triples) else None
            hit = None
            for i, entry in enumerate(self.plan_triples):
                if i in self._fired:
                    continue
                kind = _entry_hit(entry, site, n, rank_text)
                if kind is not None:
                    self._fired.add(i)
                    hit = (kind, n)
                    break
        if hit is not None:
            _fire_injection(hit[0], site, hit[1],
                            f"request {self.request_id} fault plan")


def current_scope() -> Optional[RequestScope]:
    """The scope active on this thread, or None."""
    return getattr(_scope_tls, "scope", None)


@contextlib.contextmanager
def request_scope(scope: RequestScope):
    """Activates ``scope`` on the current thread."""
    prev = getattr(_scope_tls, "scope", None)
    _scope_tls.scope = scope
    try:
        yield scope
    finally:
        _scope_tls.scope = prev


# -- CPU fallback latch ------------------------------------------------------

_cpu_latch: Dict[str, Any] = {"active": False, "phase": None, "site": None}


def cpu_fallback_active() -> bool:
    """True while the CPU latch holds. The process latch holds until the
    :class:`~delphi_tpu_torch.utils.phase_span` open when it latched ends
    (outside every phase, until :func:`clear_cpu_fallback`); a scope's
    latch holds for the rest of the request. Only a run on the CPU
    latches (a run on the card refuses the rung in :func:`run_guarded`),
    so the latch moves no work: it keeps the JAX package's state."""
    scope = current_scope()
    if scope is not None:
        return bool(scope.cpu_latch["active"])
    if not _cpu_latch["active"]:
        return False
    span = _cpu_latch["phase"]
    if span is not None and not span.open:
        clear_cpu_fallback()
        return False
    return True


def clear_cpu_fallback() -> None:
    _cpu_latch.update(active=False, phase=None, site=None)


def _latch_cpu_fallback(site: str) -> bool:
    scope = current_scope()
    if scope is not None:
        scope.cpu_latch.update(active=True, site=site)
        return True
    _cpu_latch.update(active=True, phase=current_phase(), site=site)
    return True


def _run_on_card() -> bool:
    from delphi_tpu_torch.device import get_device
    return get_device().type == "cuda"


# -- abort -------------------------------------------------------------------

_abort_state: Dict[str, Optional[str]] = {"reason": None}


def request_abort(reason: str) -> None:
    """Arms the abort latch: the run raises :class:`RunAborted` at the next
    seam entry or phase boundary (phase checkpoints land at phase ends)."""
    if _abort_state["reason"] is None:
        _abort_state["reason"] = str(reason)
        counter_inc("resilience.aborts_requested")


def abort_requested() -> Optional[str]:
    return _abort_state["reason"]


def clear_abort() -> None:
    _abort_state["reason"] = None


def maybe_abort() -> None:
    """Raises at a safe stopping point when an abort or a deadline applies.
    Inside a scope only the scope's latches count."""
    scope = current_scope()
    if scope is not None:
        if scope.abort_reason is not None:
            raise RunAborted(f"run aborted: {scope.abort_reason}")
        rem = scope.remaining_s()
        if rem is not None and rem <= 0.0:
            counter_inc("resilience.deadline_expired")
            raise DeadlineExceeded(
                f"request {scope.request_id} deadline exceeded "
                f"({-rem:.3f}s past)")
        return
    reason = _abort_state["reason"]
    if reason is not None:
        raise RunAborted(f"run aborted: {reason}")


def on_watchdog_stall(recorder: Any, idle_s: float) -> None:
    """The stall watchdog's checkpoint-and-abort hook (the watchdog is
    :mod:`delphi_tpu_torch.observability.live`'s). Armed when a checkpoint
    directory is configured or
    ``DELPHI_STALL_ABORT`` is truthy; an explicitly falsy flag disarms it.
    With a directory, writes ``stall_abort.json`` there."""
    flag = os.environ.get("DELPHI_STALL_ABORT")
    directory = checkpoint_dir()
    if flag is not None and flag.strip():
        enabled = flag.strip().lower() not in _FALSY
    else:
        enabled = directory is not None
    if not enabled:
        return
    counter_inc("resilience.stall_aborts")
    request_abort(f"watchdog stall: no span transition for {idle_s:.1f}s")
    if directory:
        from delphi_tpu_torch.parallel import store as dstore
        try:
            from delphi_tpu_torch.observability import trace as _trace
            dstore.write_json(
                os.path.join(directory, "stall_abort.json"),
                {"idle_s": round(idle_s, 3),
                 "active_spans": recorder.active_spans(),
                 "transition_count": recorder.transition_count,
                 # the wedged request's trace identity: the join key
                 # between this marker and its /trace/<id> document
                 "trace_ids": _trace.active_trace_ids(),
                 "traces": _trace.active_traces()},
                schema="marker", site="store.checkpoint", root=directory)
        except Exception as e:  # the marker is best-effort evidence
            _logger.warning(f"failed to write stall marker: {e}")


# -- the guarded seam --------------------------------------------------------

#: Entries (attempts) into each guarded site since a caller last cleared
#: it, counted whether or not a plan is armed.
entries: Dict[str, int] = {}

def _stamp_ledger(action: str, site: str, kind: str) -> None:
    from delphi_tpu_torch.observability.provenance import active_ledger
    led = active_ledger()
    if led is not None:
        led.record_note(f"resilience.{action}", f"{site}: {kind}")


def run_guarded(site: str, thunk: Callable[[], Any], *,
                can_shrink: bool = False,
                evict: Optional[Callable[[], Any]] = None,
                cpu_fallback: bool = True,
                policy: Optional[RetryPolicy] = None,
                sleep: Optional[Callable[[float], None]] = None,
                classify: Callable[[BaseException], Optional[str]]
                = classify_fault) -> Any:
    """Runs one device launch or upload under the plane (see the module
    docstring). ``sleep`` is injectable for tests."""
    pol = policy or default_policy()
    do_sleep = sleep if sleep is not None else time.sleep
    scope = current_scope()
    attempt = 0
    budget = pol.max_retries
    evicted = False
    while True:
        maybe_abort()
        attempt += 1
        entries[site] = entries.get(site, 0) + 1
        try:
            _maybe_inject(site)
            return thunk()
        except (ShrinkBatch, RunAborted):
            raise
        except (Exception, FaultInjected) as exc:
            kind = classify(exc)
            if kind is None:
                raise
            counter_inc(f"resilience.faults.{kind}")
            _logger.warning(
                f"{site}: classified {kind} fault on attempt {attempt}: "
                f"{type(exc).__name__}: {exc}")
            if budget > 0:
                budget -= 1
                delay = pol.backoff_s(site, attempt)
                if scope is not None:
                    rem = scope.remaining_s()
                    if rem is not None and delay >= rem:
                        counter_inc("resilience.deadline_clipped")
                        raise DeadlineExceeded(
                            f"request {scope.request_id}: {site} retry "
                            f"backoff {delay:.3f}s exceeds remaining "
                            f"deadline {max(rem, 0.0):.3f}s") from exc
                counter_inc("resilience.retries")
                histogram_observe("resilience.backoff_seconds", delay)
                do_sleep(delay)
                continue
            # retries spent: shrink, then evict, then the CPU latch (on a
            # run on the card the rung is refused and the fault re-raises)
            if can_shrink:
                counter_inc("resilience.degrade.shrink")
                _stamp_ledger("shrink", site, kind)
                _logger.warning(f"{site}: degrading — shrink batch ({kind})")
                raise ShrinkBatch(site) from exc
            if evict is not None and not evicted:
                evicted = True
                counter_inc("resilience.degrade.evict")
                _stamp_ledger("evict", site, kind)
                _logger.warning(
                    f"{site}: degrading — evicting device residency and "
                    f"re-uploading ({kind})")
                evict()
                budget = pol.max_retries
                continue
            already_latched = (scope.cpu_latch["active"] if scope is not None
                               else cpu_fallback_active())
            if cpu_fallback and not already_latched and _run_on_card():
                counter_inc("resilience.degrade.cpu_refused")
                _stamp_ledger("cpu_refused", site, kind)
                _logger.warning(
                    f"{site}: the CPU rung is refused on the card; "
                    f"re-raising ({kind})")
                raise
            if cpu_fallback and not already_latched \
                    and _latch_cpu_fallback(site):
                counter_inc("resilience.degrade.cpu_fallback")
                _stamp_ledger("cpu_fallback", site, kind)
                _logger.warning(
                    f"{site}: degrading — CPU for the remainder of the "
                    f"phase ({kind})")
                budget = pol.max_retries
                continue
            raise


# -- backend-init deadline probe ---------------------------------------------

def init_deadline_s() -> float:
    """Deadline of the backend-init probe in seconds:
    ``DELPHI_INIT_DEADLINE_S`` / ``repair.init.deadline_s`` (default 180;
    0 probes inline with no deadline)."""
    return _env_or_conf("DELPHI_INIT_DEADLINE_S", "repair.init.deadline_s",
                        float, 180.0)


def probe_backend(deadline_s: Optional[float] = None,
                  probe: Optional[Callable[[], Any]] = None) -> Any:
    """``torch.cuda.init()`` and ``torch.cuda.device_count()`` under a
    deadline, probed from a daemon thread: a hanging init raises
    :class:`BackendInitTimeout` instead of stalling the run. The port
    never degrades to the CPU on it (its one card is the single device the
    JAX package degrades to). ``probe`` is injectable for tests."""
    deadline = init_deadline_s() if deadline_s is None else float(deadline_s)
    _maybe_inject("backend.init")

    def _probe() -> int:
        import torch
        torch.cuda.init()
        return torch.cuda.device_count()

    fn = probe if probe is not None else _probe
    if deadline <= 0:
        return fn()
    out: Dict[str, Any] = {}

    def work() -> None:
        try:
            out["devices"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=work, daemon=True,
                         name="delphi-backend-probe")
    t.start()
    t.join(deadline)
    if t.is_alive():
        raise BackendInitTimeout(
            f"backend initialization timed out after {deadline:.1f}s "
            "(DELPHI_INIT_DEADLINE_S hard deadline)")
    if "error" in out:
        raise out["error"]
    return out["devices"]


def note_fault(exc: BaseException, site: str) -> Optional[str]:
    """Classifies and counts a fault handled outside :func:`run_guarded`
    (the durable store's corrupt reads). Returns the kind, or None."""
    kind = classify_fault(exc)
    if kind is not None:
        counter_inc(f"resilience.faults.{kind}")
        _logger.warning(f"{site}: classified {kind} fault: "
                        f"{type(exc).__name__}: {exc}")
    return kind


# -- phase checkpoint store --------------------------------------------------

def checkpoint_dir() -> Optional[str]:
    """``DELPHI_CHECKPOINT_DIR`` / ``repair.checkpoint.dir``, or None when
    phase checkpoints are off (the default). An active scope's
    ``checkpoint_dir`` overrides both (an empty string turns them off)."""
    scope = current_scope()
    if scope is not None and scope.checkpoint_dir is not None:
        return scope.checkpoint_dir.strip() or None
    env = os.environ.get("DELPHI_CHECKPOINT_DIR")
    if env is not None and env.strip():
        return env.strip()
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.checkpoint.dir")
    return str(conf).strip() if conf and str(conf).strip() else None


_PHASE_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def fingerprint_digest(fingerprint: Dict[str, Any]) -> str:
    """Stable hex digest of a fingerprint dict: canonical JSON (sorted keys,
    non-JSON leaves stringified) through sha1, equal to the JAX package's
    for equal dicts."""
    canonical = json.dumps(fingerprint, sort_keys=True, default=str)
    return hashlib.sha1(canonical.encode("utf-8", "replace")).hexdigest()


class PhaseCheckpointStore:
    """Fingerprinted per-phase pickles under one directory, written through
    the durable store (site ``store.checkpoint``): crash-consistent, and a
    corrupt file is quarantined and read as a miss. The fingerprint is the
    JAX package's, and each file also names the package that wrote it: a
    file the JAX package wrote (its statistics and models are its own
    computation) reads as corrupt, is quarantined and recomputed. Pickles
    run code as they load: point the directory only at files this package
    wrote."""

    VERSION = 1
    PACKAGE = "delphi_tpu_torch"

    def __init__(self, directory: str, fingerprint: Dict[str, Any]) -> None:
        self.directory = directory
        self.fingerprint = fingerprint
        self.digest = fingerprint_digest(fingerprint)

    def _path(self, phase: str) -> str:
        return os.path.join(self.directory,
                            f"phase_{_PHASE_SAFE.sub('_', phase)}.pkl")

    def load(self, phase: str) -> Optional[Any]:
        from delphi_tpu_torch.parallel import store as dstore
        path = self._path(phase)
        payload, status = dstore.read_pickle(
            path, schema="phase_ckpt", site="store.checkpoint",
            root=self.directory)
        if status == "missing":
            counter_inc("resilience.checkpoint.misses")
            return None
        if status != "corrupt" and isinstance(payload, dict) \
                and payload.get("package") != self.PACKAGE:
            dstore.mark_corrupt(path, "store.checkpoint",
                                "phase checkpoint written by another "
                                "package", self.directory)
            status = "corrupt"
        if status == "corrupt":
            _logger.warning(f"Ignoring corrupt phase checkpoint {path}")
            counter_inc("resilience.checkpoint.corrupt")
            return None
        if not isinstance(payload, dict) \
                or payload.get("version") != self.VERSION \
                or payload.get("fingerprint") != self.fingerprint:
            _logger.warning(
                f"Ignoring stale phase checkpoint {path}: input/options "
                "changed since it was written")
            counter_inc("resilience.checkpoint.stale")
            return None
        counter_inc("resilience.checkpoint.hits")
        _logger.info(f"Resuming phase '{phase}' from checkpoint {path} "
                     f"(fingerprint {self.digest[:12]})")
        return payload["payload"]

    def save(self, phase: str, payload: Any) -> None:
        from delphi_tpu_torch.parallel import store as dstore
        try:
            dstore.write_pickle(
                self._path(phase),
                {"version": self.VERSION,
                 "package": self.PACKAGE,
                 "fingerprint": self.fingerprint,
                 "phase": phase,
                 "payload": payload},
                schema="phase_ckpt", site="store.checkpoint",
                root=self.directory)
            counter_inc("resilience.checkpoint.saves")
            _logger.info(
                f"Phase '{phase}' checkpointed to {self._path(phase)}")
        except Exception as e:
            # a failed checkpoint write never fails the run
            _logger.warning(f"Failed to write phase checkpoint for "
                            f"'{phase}': {e}")
