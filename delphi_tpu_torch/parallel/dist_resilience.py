"""Distributed resilience plane: bounded collectives, rank liveness and the
coordinated single-host degrade. The JAX package's
``parallel/dist_resilience.py``, name for name, over the port's gloo seam
(:mod:`delphi_tpu_torch.parallel.distributed`).

* :func:`guarded_collective` — the seam every host collective routes
  through. The collective runs on a watchdog thread under a deadline
  (``DELPHI_COLLECTIVE_TIMEOUT_S`` / ``repair.collective.timeout_s``,
  default 120 s, ``0`` disables it); on expiry, or on a classified
  cross-rank failure (gloo's dead-peer and timeout errors classify as
  ``rank_loss``), the caller degrades through its ``fallback``.
  Collectives are never retried: the peers may have moved on.
* **Membership** — :func:`ensure_membership` gathers the rank ids through
  the guarded seam at deterministic sync points only (after the join);
  a collective on a background thread would deadlock the cluster. Only
  the local liveness-file toucher (``DELPHI_LIVENESS_DIR`` /
  ``repair.liveness.dir``, every ``DELPHI_HEARTBEAT_S``) runs on a thread.
  After a timeout the files diagnose each peer: a stale file means dead,
  a fresh one stalled, none unknown.
* **Coordinated degrade** — :func:`declare_rank_lost` counts the loss
  (``resilience.dist.*``), notes it in the provenance ledger, writes a
  ``rank_loss.json`` marker next to the phase checkpoints
  (``DELPHI_CHECKPOINT_DIR``) and latches single-host execution: every
  later collective returns its local fallback and the row-shard plane
  reads off, and :func:`~delphi_tpu_torch.parallel.mesh.get_active_mesh`
  answers the shrunk mesh of this rank alone
  (``resilience.dist.mesh_shrunk``).

The clocks and the watchdog wait are module-level seams (``_monotonic``,
``_wall``, ``_wait``) for fake-clock tests.
"""

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()

# injectable time/wait seams (fake-clock tests)
_monotonic = time.monotonic
_wall = time.time


def _wait(event: threading.Event, timeout_s: float) -> bool:
    """Waits for the collective worker; True when it finished in time."""
    return event.wait(timeout_s)


# -- configuration -----------------------------------------------------------

def collective_timeout_s() -> float:
    """Watchdog deadline of one host collective in seconds:
    ``DELPHI_COLLECTIVE_TIMEOUT_S`` / ``repair.collective.timeout_s``
    (default 120; ``0`` disables the watchdog)."""
    from delphi_tpu_torch.parallel.resilience import _env_or_conf
    return _env_or_conf("DELPHI_COLLECTIVE_TIMEOUT_S",
                        "repair.collective.timeout_s", float, 120.0)


def heartbeat_interval_s() -> float:
    """Liveness-file touch period in seconds: ``DELPHI_HEARTBEAT_S`` /
    ``repair.heartbeat.interval_s`` (default 15; ``0`` disables the
    toucher). A peer's file older than 3x this reads as dead."""
    from delphi_tpu_torch.parallel.resilience import _env_or_conf
    return _env_or_conf("DELPHI_HEARTBEAT_S",
                        "repair.heartbeat.interval_s", float, 15.0)


def liveness_dir() -> Optional[str]:
    """Shared directory of the per-rank liveness files
    (``DELPHI_LIVENESS_DIR`` / ``repair.liveness.dir``), or None (the
    default: the seam is off)."""
    from delphi_tpu_torch.parallel.resilience import _env_or_conf
    d = _env_or_conf("DELPHI_LIVENESS_DIR", "repair.liveness.dir", str, "")
    return d.strip() or None


# -- distributed degrade state -----------------------------------------------

_lock = threading.Lock()
_state: Dict[str, Any] = {
    "latched": False, "latch_site": None, "reason": None,
    "lost": set(), "alive": None, "expected": None, "diagnosis": {},
    "aggregation_incomplete": False, "mesh_shrunk": False,
}


def single_host_latched() -> bool:
    """True after a rank loss: every collective returns its local fallback
    for the rest of the process."""
    return _state["latched"]


def degraded_ranks() -> List[int]:
    """Sorted ranks declared lost so far."""
    with _lock:
        return sorted(_state["lost"])


def reset_dist_state() -> None:
    """Forgets the latch, lost ranks and membership, and stops the
    liveness toucher (tests that replay scenarios in one process)."""
    stop_liveness()
    with _lock:
        _state.update(latched=False, latch_site=None, reason=None,
                      lost=set(), alive=None, expected=None, diagnosis={},
                      aggregation_incomplete=False, mesh_shrunk=False)


def mark_aggregation_incomplete() -> None:
    """Report aggregation degraded to this rank's own view (a peer was
    lost before or during the ``report.gather`` collective)."""
    with _lock:
        first = not _state["aggregation_incomplete"]
        _state["aggregation_incomplete"] = True
    if first:
        counter_inc("resilience.dist.aggregation_incomplete")


def note_mesh_shrunk() -> None:
    """The first re-entry on the shrunk mesh of this rank alone (counted
    once a run)."""
    with _lock:
        first = not _state["mesh_shrunk"]
        _state["mesh_shrunk"] = True
    if first:
        counter_inc("resilience.dist.mesh_shrunk")


def report_section() -> Optional[Dict[str, Any]]:
    """The run report's ``dist`` section, or None while the membership
    protocol was never touched."""
    with _lock:
        touched = (_state["latched"] or _state["lost"]
                   or _state["aggregation_incomplete"]
                   or _state["alive"] is not None)
        if not touched:
            return None
        return {
            "expected_ranks": _state["expected"],
            "alive_ranks": (list(_state["alive"])
                            if _state["alive"] is not None else None),
            "degraded_ranks": sorted(_state["lost"]),
            "single_host_latched": bool(_state["latched"]),
            "latch_site": _state["latch_site"],
            "reason": _state["reason"],
            "diagnosis": {str(r): v for r, v in _state["diagnosis"].items()},
            "aggregation_incomplete": bool(_state["aggregation_incomplete"]),
            "mesh_shrunk": bool(_state["mesh_shrunk"]),
        }


# -- liveness files ----------------------------------------------------------

_toucher: Dict[str, Any] = {"thread": None, "stop": None}


_LIVENESS_PREFIX = "rank_"
_LIVENESS_SUFFIX = ".alive"


def member_liveness_path(directory: str, member) -> str:
    """Liveness file of one member under a membership directory."""
    return os.path.join(directory,
                        f"{_LIVENESS_PREFIX}{member}{_LIVENESS_SUFFIX}")


def touch_liveness_file(path: str) -> None:
    """Stamps one liveness file with the wall clock as its content (not its
    mtime: fake clocks and skewed hosts read one timebase). Best-effort."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(repr(float(_wall())))
        os.replace(tmp, path)
    except Exception as e:  # liveness is evidence, never a failure source
        _logger.warning(f"liveness touch failed: {e}")


def liveness_file_age_s(path: Optional[str],
                        now: Optional[float] = None) -> Optional[float]:
    """Seconds since the file at ``path`` was stamped, or None when it is
    absent or unreadable."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            stamp = float(f.read().split()[0])
    except Exception:
        return None
    return max(0.0, (now if now is not None else float(_wall())) - stamp)


def diagnose_liveness_file(path: Optional[str], interval_s: float,
                           now: Optional[float] = None) -> str:
    """``live`` (stamp fresher than 3x the heartbeat interval), ``dead``
    (stale stamp) or ``unknown`` (no file)."""
    age = liveness_file_age_s(path, now=now)
    if age is None:
        return "unknown"
    return "live" if age <= 3.0 * max(interval_s, 0.001) else "dead"


def scan_membership(directory: str, interval_s: float,
                    now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
    """``{member_id: {"age_s": float|None, "status": live|dead|unknown}}``
    for every liveness file under ``directory``: the fleet router's ring
    is built from it."""
    members: Dict[str, Dict[str, Any]] = {}
    try:
        entries = os.listdir(directory)
    except OSError:
        return members
    for name in sorted(entries):
        if not (name.startswith(_LIVENESS_PREFIX)
                and name.endswith(_LIVENESS_SUFFIX)):
            continue
        member = name[len(_LIVENESS_PREFIX):-len(_LIVENESS_SUFFIX)]
        path = os.path.join(directory, name)
        members[member] = {
            "age_s": liveness_file_age_s(path, now=now),
            "status": diagnose_liveness_file(path, interval_s, now=now),
        }
    return members


def _liveness_path(rank: int) -> Optional[str]:
    d = liveness_dir()
    return member_liveness_path(d, int(rank)) if d else None


def touch_liveness() -> None:
    """Writes this rank's liveness stamp under ``DELPHI_LIVENESS_DIR``."""
    from delphi_tpu_torch.parallel import distributed as dist
    path = _liveness_path(dist.process_index())
    if path:
        touch_liveness_file(path)


def peer_liveness_age_s(rank: int, now: Optional[float] = None
                        ) -> Optional[float]:
    """Seconds since ``rank`` last touched its liveness file, or None."""
    return liveness_file_age_s(_liveness_path(rank), now=now)


def diagnose_peer(rank: int, now: Optional[float] = None) -> str:
    """``dead`` (stale file), ``stalled`` (fresh file: alive but wedged)
    or ``unknown`` (no seam, no file)."""
    age = peer_liveness_age_s(rank, now=now)
    if age is None:
        return "unknown"
    return "stalled" if age <= 3.0 * max(heartbeat_interval_s(), 0.001) \
        else "dead"


def start_liveness() -> bool:
    """Starts the liveness toucher thread (local file I/O only).
    Idempotent; False when the seam is off or the interval is 0."""
    interval = heartbeat_interval_s()
    if liveness_dir() is None or interval <= 0:
        return False
    touch_liveness()
    with _lock:
        t = _toucher["thread"]
        if t is not None and t.is_alive():
            return True
        stop = threading.Event()
        t = threading.Thread(target=_touch_loop, args=(stop,),
                             daemon=True, name="delphi-liveness")
        _toucher.update(thread=t, stop=stop)
    t.start()
    return True


def _touch_loop(stop: threading.Event) -> None:
    while not stop.wait(max(0.05, heartbeat_interval_s())):
        touch_liveness()


def stop_liveness() -> None:
    with _lock:
        t, stop = _toucher["thread"], _toucher["stop"]
        _toucher.update(thread=None, stop=None)
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive():
        t.join(timeout=1.0)


# -- coordinated degrade -----------------------------------------------------

def _write_loss_marker(site: str, reason: str, lost: List[int],
                       diagnosis: Dict[int, str]) -> None:
    """``rank_loss.json`` next to the phase checkpoints, whose last
    completed phase is where a restarted cluster resumes."""
    from delphi_tpu_torch.parallel import distributed as dist
    from delphi_tpu_torch.parallel import resilience as rz
    directory = rz.checkpoint_dir()
    if not directory:
        return
    from delphi_tpu_torch.parallel import store as dstore
    try:
        dstore.write_json(
            os.path.join(directory, "rank_loss.json"),
            {"site": site, "reason": reason,
             "lost_ranks": sorted(int(r) for r in lost),
             "diagnosis": {str(r): v for r, v in diagnosis.items()},
             "surviving_rank": int(dist.process_index()),
             "wall_time": float(_wall())},
            schema="marker", site="store.checkpoint", root=directory)
    except Exception as e:  # the marker is best-effort evidence
        _logger.warning(f"failed to write rank_loss marker: {e}")


def declare_rank_lost(site: str, *, reason: str) -> List[int]:
    """A cross-rank interaction at ``site`` failed or timed out: declares
    every peer lost, diagnoses each through the liveness files, counts the
    transitions, writes the marker and latches single-host execution.
    Returns the ranks newly declared lost."""
    from delphi_tpu_torch.parallel import distributed as dist
    from delphi_tpu_torch.parallel import resilience as rz
    me = dist.process_index()
    n = dist.process_count()
    peers = [r for r in range(n) if r != me]
    diagnosis = {r: diagnose_peer(r) for r in peers}
    with _lock:
        new = [r for r in peers if r not in _state["lost"]]
        _state["lost"].update(peers)
        first = not _state["latched"]
        if first:
            _state.update(latched=True, latch_site=site, reason=reason)
        _state["diagnosis"].update(diagnosis)
        _state["expected"] = max(int(_state["expected"] or 0), n)
    counter_inc(f"resilience.faults.{rz.KIND_RANK_LOSS}")
    for _ in new:
        counter_inc("resilience.dist.rank_loss")
    if first:
        counter_inc("resilience.dist.single_host_latch")
        rz._stamp_ledger("rank_loss", site, rz.KIND_RANK_LOSS)
        _write_loss_marker(site, reason, new or peers, diagnosis)
        _logger.warning(
            f"{site}: rank(s) {sorted(new or peers)} declared lost "
            f"({reason}); diagnosis {diagnosis} — latching single-host "
            "execution for the rest of the run")
    return new


# -- the guarded collective seam ---------------------------------------------

def guarded_collective(site: str, thunk: Callable[[], Any], *,
                       fallback: Optional[Callable[[], Any]] = None,
                       timeout_s: Optional[float] = None) -> Any:
    """Runs one host collective under the plane.

    One process: ``thunk`` inline. After a latch: ``fallback()`` without
    entering the collective (entering would hang), or :class:`RankLost`
    without one. Several processes: the fault plan fires on the caller's
    thread (an injected ``stall`` wedges this rank where a real wedge
    would), then ``thunk`` runs on a daemon watchdog thread under the
    deadline. On expiry, or on a failure :func:`~delphi_tpu_torch.
    parallel.resilience.classify_fault` classifies, the rank degrades
    through :func:`declare_rank_lost` and returns ``fallback()``. An
    unclassified error re-raises: program bugs stay loud."""
    from delphi_tpu_torch.parallel import distributed as dist
    from delphi_tpu_torch.parallel import resilience as rz
    rz.maybe_abort()
    if dist.process_count() <= 1:
        return thunk()
    if single_host_latched():
        if fallback is not None:
            return fallback()
        raise rz.RankLost(
            f"collective at {site} entered after single-host latch "
            f"(lost ranks {degraded_ranks()}) with no local fallback")
    try:
        rz._maybe_inject(site)
    except rz.FaultInjected as exc:
        if rz.classify_fault(exc) == rz.KIND_RANK_LOSS \
                and fallback is not None:
            declare_rank_lost(site, reason=f"injected rank loss: {exc}")
            return fallback()
        raise
    deadline = collective_timeout_s() if timeout_s is None \
        else float(timeout_s)
    if deadline <= 0:
        return thunk()
    out: Dict[str, Any] = {}
    done = threading.Event()

    def _work():
        try:
            out["value"] = thunk()
        except BaseException as e:
            out["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_work, daemon=True,
                         name=f"delphi-collective-{site}")
    t.start()
    if not _wait(done, deadline):
        # the wedged thread is a daemon and leaks by design: it cannot be
        # cancelled, and this thread must keep making progress
        counter_inc("resilience.dist.collective_timeouts")
        _logger.warning(
            f"{site}: collective timed out after {deadline:.1f}s "
            "(DELPHI_COLLECTIVE_TIMEOUT_S) — degrading")
        declare_rank_lost(
            site, reason=f"collective timed out after {deadline:.1f}s")
        if fallback is not None:
            return fallback()
        raise rz.RankLost(
            f"collective operation at {site} timed out after "
            f"{deadline:.1f}s waiting for remote ranks")
    if "error" in out:
        exc = out["error"]
        kind = rz.classify_fault(exc)
        if kind is not None and fallback is not None:
            counter_inc(f"resilience.faults.{kind}")
            declare_rank_lost(
                site, reason=f"collective failed "
                f"({kind}): {type(exc).__name__}: {exc}")
            return fallback()
        raise exc
    return out["value"]


# -- membership --------------------------------------------------------------

def ensure_membership(site: str = "dist.heartbeat") -> List[int]:
    """The rank heartbeat: a rank-id all-gather through the guarded seam at
    a deterministic sync point. Touches this rank's liveness file, records
    the agreed membership and returns the alive ranks; a timeout degrades
    through the rank-loss path and returns this rank alone."""
    from delphi_tpu_torch.parallel import distributed as dist
    me = int(dist.process_index())
    n = int(dist.process_count())
    touch_liveness()
    if n <= 1 or single_host_latched():
        return [me]

    def _gather():
        return [int(r) for r in dist._all_gather(
            np.asarray([me], dtype=np.int64)).reshape(-1)]

    alive = sorted(set(guarded_collective(site, _gather,
                                          fallback=lambda: [me])))
    with _lock:
        _state["alive"] = list(alive)
        _state["expected"] = max(int(_state["expected"] or 0), n)
    counter_inc("resilience.dist.heartbeats")
    return alive
