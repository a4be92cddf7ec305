"""Streaming repair plane: crash-exact continuous delta ingestion.

A :class:`StreamSession` sustains a *chain* of repair requests: a client
streams appended/updated partitions, each request carries ``(stream id,
seq, parent snapshot id)`` where ``parent`` is the previous response's
snapshot id, and the server accumulates the concatenated table and runs
the incremental executor over it against a per-stream snapshot
directory. The invariant the whole plane defends: after delta N the
stream's end-state (repair frame + spliced provenance) is bit-identical
to ONE batch run over the concatenation of deltas 1..N — streaming is an
execution strategy, never a different answer. In the port the batch CLI's
``--stream N`` drives a session; the HTTP serving plane that carries
streams for remote clients is :mod:`delphi_tpu_torch.observability.serve`
(a ``"stream"`` field on ``POST /repair``).

**Durable cursor.** Every committed delta writes, through the durable
store (:mod:`delphi_tpu_torch.parallel.store`), a *new generation* of two
files under the stream directory::

    table.<seq>.pkl     the accumulated input table   (site store.stream_state)
    cursor.<seq>.json   the commit record             (site store.stream_cursor)

in that order, with a validated read-back after each write. Generations
never overwrite each other, so a torn write of generation N (the store's
``torn_write`` fault truncates the destination in place with the writer
believing success) can never destroy generation N-1 — and the read-back
converts believed-success into detected-failure *before* the delta is
acknowledged: the write is retried once (the quarantine of the torn file
makes room), and if it still cannot be verified the delta fails with the
last durable cursor echoed so the client resends. An acknowledged delta
is therefore durable by construction. The snapshot directory itself
(manifest + state) is a pure cache: if a crash tears it, the next delta
falls back to a full run over the durable accumulated table
(``incremental.fallback``) and repopulates it — same end state.

**Idempotent re-apply.** ``seq`` must be exactly ``cursor.seq + 1``. A
re-sent delta (``seq <= cursor.seq``) with matching content digest is
acknowledged as a duplicate with the current cursor (the at-least-once
retry loop after a worker death or router re-dispatch); a same-``seq``
digest mismatch, a gap, or a ``parent`` that does not match the durable
head are 409 conflicts carrying the cursor so the client can resync.

**Recovery.** A session constructed over a directory that already holds
a durable cursor (worker restart, or a fleet survivor inheriting the
chain through the shared cache root) scans cursor generations newest-
first, quarantining corrupt ones, and resumes at the newest generation
whose cursor AND table both validate. The session reports
``recovering=True`` (surfaced as ``/healthz`` degraded) until the first
post-recovery delta commits.

**Backpressure.** :class:`StreamManager` bounds in-flight deltas per
stream (``DELPHI_STREAM_MAX_INFLIGHT``); past the bound admission
answers 429 with the durable cursor echoed, and the ``stream.lag_rows``
gauge exposes rows admitted but not yet durably repaired — the
bounded-staleness signal.

**Drift-gated background retrain.** Per-attribute value histograms are
baselined at model-training time (not per step — a slow drift moves each
step's histogram only slightly, so the per-delta PSI gate in the planner
keeps reusing frozen models and the stream never blocks). When the PSI
of the accumulated table against the *training-time* baseline crosses
``DELPHI_STREAM_DRIFT_MAX``, a replacement model trains off-thread over
a copy of the accumulated table and is atomically swapped into the
snapshot state through the store seam under the session lock
(``stream.retrain.swaps``); baselines refresh at the swap, so the
trigger re-arms only on the next real drift.

Retention: cursor/table generations are pruned to
``DELPHI_STREAM_KEEP`` after each commit, and the snapshot chain rides
the existing ``DELPHI_SNAPSHOT_CHAIN_KEEP`` compaction + store quota GC.
"""

import hashlib
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import pandas as pd

from delphi_tpu_torch.incremental import manifest as mf
from delphi_tpu_torch.incremental.planner import (
    _aligned_hist_counts, drift_max_setting,
)
from delphi_tpu_torch.observability.drift import population_stability_index
from delphi_tpu_torch.parallel import store as dstore
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.utils import counter_inc, gauge_set, setup_logger

_logger = setup_logger()

__all__ = [
    "StreamBusy", "StreamCommitError", "StreamManager", "StreamSession",
    "keep_setting", "max_inflight_setting", "stream_drift_max_setting",
    "validate_stream_id",
]

_DEF_MAX_INFLIGHT = 2
_DEF_KEEP = 2

_CURSOR_RE = re.compile(r"^cursor\.(\d{8})\.json$")
_TABLE_FMT = "table.{seq:08d}.pkl"
_CURSOR_FMT = "cursor.{seq:08d}.json"

#: extra write attempt after a failed read-back before giving up — one
#: retry absorbs a single torn write (the quarantine clears the debris)
_COMMIT_ATTEMPTS = 2


def max_inflight_setting() -> int:
    """``DELPHI_STREAM_MAX_INFLIGHT`` env over the
    ``repair.stream.max_inflight`` session conf (default 2): deltas a
    single stream may have admitted-but-uncommitted before admission
    answers 429 + cursor echo."""
    env = os.environ.get("DELPHI_STREAM_MAX_INFLIGHT")
    if env:
        return max(1, int(env))
    conf = get_session().conf.get("repair.stream.max_inflight")
    return max(1, int(conf)) if conf else _DEF_MAX_INFLIGHT


def keep_setting() -> int:
    """``DELPHI_STREAM_KEEP`` env over the ``repair.stream.keep`` session
    conf (default 2): cursor/table generations retained per stream. The
    floor is 2 — one generation of headroom is what makes a torn write of
    the newest generation recoverable."""
    env = os.environ.get("DELPHI_STREAM_KEEP")
    if env:
        return max(2, int(env))
    conf = get_session().conf.get("repair.stream.keep")
    return max(2, int(conf)) if conf else _DEF_KEEP


def stream_drift_max_setting() -> float:
    """``DELPHI_STREAM_DRIFT_MAX`` env over the
    ``repair.stream.drift_max`` session conf; defaults to the
    incremental planner's drift knee. This gate compares against the
    *training-time* baseline, so it accumulates drift the planner's
    step-over-step gate cannot see."""
    env = os.environ.get("DELPHI_STREAM_DRIFT_MAX")
    if env:
        return float(env)
    conf = get_session().conf.get("repair.stream.drift_max")
    return float(conf) if conf else drift_max_setting()


def validate_stream_id(stream_id: Any) -> str:
    """Same filename-safe alphabet as serve's ``base_snapshot`` ids: a
    request body must never be able to escape the streams root."""
    sid = str(stream_id or "")
    if not sid or len(sid) > 64 \
            or not all(c.isalnum() or c in "._-" for c in sid) \
            or sid.startswith("."):
        raise ValueError(
            f"bad stream id {stream_id!r}: expected 1-64 chars from "
            "[A-Za-z0-9._-], not starting with '.'")
    return sid


def delta_digest(delta: pd.DataFrame) -> str:
    """Content digest of one delta partition — the idempotency key a
    re-sent delta is matched on."""
    blob = delta.to_json(orient="split", default_handler=str)
    return hashlib.sha1(blob.encode()).hexdigest()


class StreamBusy(Exception):
    """Per-stream backpressure refusal (HTTP 429): the stream already has
    ``max_inflight`` admitted-but-uncommitted deltas. Carries the durable
    cursor so the client knows exactly where to resume."""

    def __init__(self, stream_id: str, cursor: Optional[Dict[str, Any]],
                 retry_after_s: float = 1.0) -> None:
        self.stream_id = stream_id
        self.cursor = cursor
        self.retry_after_s = retry_after_s
        super().__init__(
            f"stream {stream_id}: in-flight delta bound reached")


class StreamCommitError(Exception):
    """A commit write could not be verified even after retry — the delta
    is NOT acknowledged; the client must resend from the durable
    cursor."""


def _public_cursor(cursor: Optional[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """The client-facing cursor: everything but the (bulky, server-
    internal) drift baselines."""
    if cursor is None:
        return None
    return {k: v for k, v in cursor.items() if k != "baselines"}


class StreamSession:
    """One stream's server-side handle. All durable state lives on disk
    under ``directory``; the in-memory accumulated table is a cache a
    restart or failover rebuilds from the newest valid generation."""

    def __init__(self, stream_id: str, directory: str,
                 store_root: Optional[str] = None) -> None:
        self.stream_id = validate_stream_id(stream_id)
        self.directory = directory
        self.store_root = store_root or directory
        self.snapshot_dir = os.path.join(directory, "snapshot")
        self.lock = threading.RLock()
        self.cursor: Optional[Dict[str, Any]] = None
        self.table: Optional[pd.DataFrame] = None
        # admission slots (guarded by the manager's lock, not self.lock —
        # admission must never block behind an executing delta)
        self.pending = 0
        self.pending_rows = 0
        self._retrain_pending = False
        self._retrain_thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self._load_durable()
        # a durable cursor found at construction means this process did
        # not produce the in-memory state it is about to serve from: the
        # session is in recovery replay until the next commit proves the
        # rebuilt state live (surfaced as /healthz degraded)
        self.recovering = self.cursor is not None
        if self.recovering:
            counter_inc("stream.recoveries")
            _logger.info(
                f"stream {self.stream_id}: recovered at durable cursor "
                f"seq={self.cursor['seq']} "
                f"snapshot={self.cursor.get('snapshot_id')}")

    # -- durable state -------------------------------------------------------

    def _table_path(self, seq: int) -> str:
        return os.path.join(self.directory, _TABLE_FMT.format(seq=seq))

    def _cursor_path(self, seq: int) -> str:
        return os.path.join(self.directory, _CURSOR_FMT.format(seq=seq))

    def _generations(self) -> List[int]:
        """Cursor generation seqs present on disk, newest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        seqs = [int(m.group(1)) for m in
                (_CURSOR_RE.match(n) for n in names) if m]
        return sorted(seqs, reverse=True)

    def _load_durable(self) -> None:
        """Resume point: the newest generation whose cursor AND table
        both validate. Corrupt generations are quarantined by the store
        reads themselves; stepping past one is exactly the torn-write
        recovery path."""
        for seq in self._generations():
            cursor, status = dstore.read_json(
                self._cursor_path(seq), schema="stream_cursor",
                site="store.stream_cursor", root=self.store_root)
            if status != "ok" or not isinstance(cursor, dict):
                continue
            table, tstatus = dstore.read_pickle(
                self._table_path(seq), schema="stream_state",
                site="store.stream_state", root=self.store_root)
            if tstatus != "ok" or not isinstance(table, pd.DataFrame):
                _logger.warning(
                    f"stream {self.stream_id}: cursor generation {seq} "
                    f"has no valid table ({tstatus}); stepping back")
                continue
            self.cursor, self.table = cursor, table
            return

    def durable_cursor(self) -> Optional[Dict[str, Any]]:
        return _public_cursor(self.cursor)

    def _state_frame(self) -> Optional[pd.DataFrame]:
        state = mf.load_state(self.snapshot_dir)
        frame = (state or {}).get("frame")
        return frame if isinstance(frame, pd.DataFrame) else None

    def _write_verified(self, path: str, write: Callable[[], None],
                        read: Callable[[], Tuple[Any, str]],
                        what: str) -> None:
        """Write-then-validated-read-back: the conversion of a torn write
        the writer believed succeeded into a detected failure *before*
        the delta is acknowledged. One retry (the read-back quarantined
        the torn file); a second failure refuses the commit."""
        for attempt in range(_COMMIT_ATTEMPTS):
            write()
            _, status = read()
            if status == "ok":
                return
            counter_inc("stream.commit_retries")
            _logger.warning(
                f"stream {self.stream_id}: {what} write did not verify "
                f"({status}), attempt {attempt + 1}/{_COMMIT_ATTEMPTS}")
        raise StreamCommitError(
            f"stream {self.stream_id}: {what} could not be durably "
            f"written after {_COMMIT_ATTEMPTS} attempts")

    def _commit(self, seq: int, digest: str, table: pd.DataFrame,
                snapshot_id: Optional[str],
                baselines: Dict[str, Any]) -> Dict[str, Any]:
        """Table generation first, cursor generation LAST — the cursor is
        the commit point. A crash between the two leaves the previous
        cursor authoritative and the un-acked delta re-sendable."""
        tpath, cpath = self._table_path(seq), self._cursor_path(seq)
        self._write_verified(
            tpath,
            lambda: dstore.write_pickle(
                tpath, table, schema="stream_state",
                site="store.stream_state", root=self.store_root),
            lambda: dstore.read_pickle(
                tpath, schema="stream_state",
                site="store.stream_state", root=self.store_root),
            "accumulated table")
        cursor = {
            "version": 1,
            "stream_id": self.stream_id,
            "seq": int(seq),
            "snapshot_id": snapshot_id,
            "delta_sha1": digest,
            "rows_total": int(len(table)),
            "baselines": baselines,
            "updated_at": float(time.time()),
        }
        self._write_verified(
            cpath,
            lambda: dstore.write_json(
                cpath, cursor, schema="stream_cursor",
                site="store.stream_cursor", root=self.store_root),
            lambda: dstore.read_json(
                cpath, schema="stream_cursor",
                site="store.stream_cursor", root=self.store_root),
            "cursor")
        self._prune(int(seq))
        return cursor

    def _prune(self, head_seq: int) -> None:
        keep = keep_setting()
        for seq in self._generations():
            if seq <= head_seq - keep:
                for path in (self._cursor_path(seq), self._table_path(seq)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass

    # -- drift gate / background retrain -------------------------------------

    def _current_histograms(self) -> Dict[str, Any]:
        manifest = mf.load_manifest(self.snapshot_dir)
        if not manifest:
            return {}
        return {name: col.get("histogram")
                for name, col in (manifest.get("columns") or {}).items()
                if col.get("histogram")}

    def _drifted_attrs(self, hists: Dict[str, Any],
                       baselines: Dict[str, Any]) -> List[str]:
        drift_max = stream_drift_max_setting()
        out = []
        for name, base in baselines.items():
            cur = hists.get(name)
            if not cur:
                continue
            psi = population_stability_index(
                *_aligned_hist_counts(cur, base))
            if psi > drift_max:
                out.append(name)
        return sorted(out)

    def _maybe_retrain(self, retrain_fn: Optional[Callable],
                       hists: Dict[str, Any]) -> None:
        """Training-time-baseline drift gate. The replacement trains
        off-thread over a copy of the accumulated table; only the swap
        itself takes the session lock, so the stream keeps committing
        deltas against the frozen models while training runs."""
        if retrain_fn is None or self._retrain_pending or not hists:
            return
        baselines = (self.cursor or {}).get("baselines") or {}
        drifted = self._drifted_attrs(hists, baselines)
        if not drifted:
            return
        self._retrain_pending = True
        counter_inc("stream.retrain.triggers")
        snapshot_table = self.table.copy()
        trigger_hists = dict(hists)
        _logger.info(f"stream {self.stream_id}: drift past the stream "
                     f"gate on {drifted}; background retrain started")

        def _work() -> None:
            try:
                models = retrain_fn(snapshot_table)
                with self.lock:
                    self._swap_models(dict(models or {}), trigger_hists)
            except Exception as e:
                counter_inc("stream.retrain.failed")
                _logger.warning(f"stream {self.stream_id}: background "
                                f"retrain failed: {e}")
            finally:
                self._retrain_pending = False

        t = threading.Thread(
            target=_work, daemon=True,
            name=f"delphi-stream-retrain-{self.stream_id[:8]}")
        t.start()
        self._retrain_thread = t

    def _swap_models(self, models: Dict[str, Any],
                     trigger_hists: Dict[str, Any]) -> None:
        """Atomic swap of the frozen per-attribute models in the snapshot
        state (one store-seam write — readers see old or new, never a
        mix), with the drift baselines refreshed to the trigger-time
        histograms so the gate re-arms instead of re-firing."""
        state = mf.load_state(self.snapshot_dir)
        if state is None:
            _logger.warning(f"stream {self.stream_id}: no snapshot state "
                            "to swap retrained models into")
            return
        merged = dict(state.get("models") or {})
        merged.update(models)
        state["models"] = merged
        dstore.write_pickle(
            os.path.join(self.snapshot_dir, "state.pkl"), state,
            schema="snapshot_state", site="store.snapshot_state",
            root=self.store_root)
        if self.cursor is not None:
            baselines = dict(self.cursor.get("baselines") or {})
            for name in models:
                if name in trigger_hists:
                    baselines[name] = trigger_hists[name]
            self.cursor["baselines"] = baselines
        counter_inc("stream.retrain.swaps")
        _logger.info(f"stream {self.stream_id}: retrained models for "
                     f"{sorted(models)} swapped into the snapshot")

    def retrain_join(self, timeout_s: float = 60.0) -> None:
        """Test/drain hook: wait for an in-flight background retrain."""
        t = self._retrain_thread
        if t is not None:
            t.join(timeout=timeout_s)

    # -- the protocol --------------------------------------------------------

    def apply(self, seq: Any, parent: Optional[str],
              delta: pd.DataFrame, run_fn: Callable,
              retrain_fn: Optional[Callable] = None
              ) -> Tuple[int, Dict[str, Any]]:
        """Applies one chained delta. ``run_fn(accumulated_df,
        snapshot_dir, seq) -> (frame_df, incremental_summary)`` runs the
        actual repair (serve and the CLI each bring their own); the
        returned body carries ``frame_df`` (a DataFrame the transport
        layer serializes) plus the cursor. Returns ``(http_status,
        body)``."""
        with self.lock:
            counter_inc("stream.deltas")
            try:
                seq = int(seq)
            except (TypeError, ValueError):
                return 400, {"status": "bad_request",
                             "error": f"bad stream seq: {seq!r}"}
            if seq < 1:
                return 400, {"status": "bad_request",
                             "error": f"stream seq must be >= 1, got {seq}"}
            digest = delta_digest(delta)
            cur = self.cursor
            cur_seq = int(cur["seq"]) if cur else 0

            if seq <= cur_seq:
                if seq == cur_seq and cur.get("delta_sha1") != digest:
                    counter_inc("stream.conflicts")
                    return 409, {
                        "status": "conflict",
                        "error": f"seq {seq} already committed with "
                                 "different delta content",
                        "cursor": _public_cursor(cur)}
                # at-least-once retry after a worker death / re-dispatch:
                # acknowledge idempotently with the durable cursor (and,
                # for the head seq, the committed frame — so a re-sent
                # final delta still yields the full answer)
                counter_inc("stream.duplicates")
                body = {"status": "duplicate", "seq": seq,
                        "cursor": _public_cursor(cur),
                        "stream": self._stream_info()}
                if seq == cur_seq:
                    frame = self._state_frame()
                    if frame is not None:
                        # canonical ordering, same as a committed delta's
                        # response: a duplicate ack is byte-identical
                        body["frame_df"] = frame.sort_values(
                            list(frame.columns)).reset_index(drop=True)
                self.recovering = False
                return 200, body

            if seq != cur_seq + 1:
                counter_inc("stream.conflicts")
                return 409, {
                    "status": "gap",
                    "error": f"expected seq {cur_seq + 1}, got {seq}",
                    "cursor": _public_cursor(cur)}
            if parent and cur is None:
                counter_inc("stream.conflicts")
                return 409, {
                    "status": "parent_mismatch",
                    "error": "stream has no durable cursor; restart at "
                             "seq 1 without a parent snapshot",
                    "cursor": None}
            if parent and cur is not None \
                    and cur.get("snapshot_id") \
                    and parent != cur.get("snapshot_id"):
                counter_inc("stream.conflicts")
                return 409, {
                    "status": "parent_mismatch",
                    "error": f"parent snapshot {parent} does not match "
                             f"the durable head "
                             f"{cur.get('snapshot_id')}",
                    "cursor": _public_cursor(cur)}

            if self.table is None:
                accumulated = delta.reset_index(drop=True)
            else:
                accumulated = pd.concat([self.table, delta],
                                        ignore_index=True)

            frame, summary = run_fn(accumulated, self.snapshot_dir, seq)
            snapshot_id = (summary or {}).get("snapshot_id")

            # training-time drift baselines: seeded from the histograms
            # the FIRST run (which trains every model) saw, refreshed per
            # attribute only when a retrain swaps that attribute's model
            hists = self._current_histograms()
            baselines = dict((cur or {}).get("baselines") or {})
            for name, hist in hists.items():
                baselines.setdefault(name, hist)

            self.cursor = self._commit(seq, digest, accumulated,
                                       snapshot_id, baselines)
            self.table = accumulated
            self.recovering = False
            counter_inc("stream.commits")
            self._maybe_retrain(retrain_fn, hists)

            body = {"status": "ok", "seq": seq,
                    "cursor": _public_cursor(self.cursor),
                    "stream": self._stream_info(),
                    "frame_df": frame}
            if summary is not None:
                body["incremental"] = summary
            return 200, body

    def _stream_info(self) -> Dict[str, Any]:
        cur = self.cursor or {}
        return {"id": self.stream_id, "seq": int(cur.get("seq", 0)),
                "snapshot_id": cur.get("snapshot_id"),
                "rows_total": int(cur.get("rows_total", 0))}


def load_durable_cursor(directory: str, store_root: Optional[str] = None
                        ) -> Optional[Dict[str, Any]]:
    """The newest valid cursor under one stream directory WITHOUT
    rebuilding the session (no table unpickle) — what /drain reports as
    the resume point, including for streams this process never served."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    seqs = sorted((int(m.group(1)) for m in
                   (_CURSOR_RE.match(n) for n in names) if m),
                  reverse=True)
    for seq in seqs:
        cursor, status = dstore.read_json(
            os.path.join(directory, _CURSOR_FMT.format(seq=seq)),
            schema="stream_cursor", site="store.stream_cursor",
            root=store_root or directory)
        if status == "ok" and isinstance(cursor, dict):
            return _public_cursor(cursor)
    return None


class StreamManager:
    """All streams of one server: lazy per-stream sessions under
    ``root``, per-stream admission slots, and the aggregate gauges
    (``stream.lag_rows`` / ``stream.active`` / ``stream.recovering``)."""

    def __init__(self, root: str, store_root: Optional[str] = None) -> None:
        self.root = root
        self.store_root = store_root or root
        self._sessions: Dict[str, StreamSession] = {}
        self._lock = threading.Lock()

    def session(self, stream_id: Any) -> StreamSession:
        sid = validate_stream_id(stream_id)
        with self._lock:
            sess = self._sessions.get(sid)
        if sess is not None:
            return sess
        # construction (the durable scan) happens outside the manager
        # lock; a racing second constructor loses and is discarded
        fresh = StreamSession(sid, os.path.join(self.root, sid),
                              store_root=self.store_root)
        with self._lock:
            sess = self._sessions.setdefault(sid, fresh)
        self._publish_gauges()
        return sess

    def admit(self, stream_id: Any, rows: int,
              retry_after_s: float = 1.0) -> StreamSession:
        """Backpressure check at admission time (HTTP thread, before the
        job queue): bounded in-flight deltas per stream."""
        sess = self.session(stream_id)
        limit = max_inflight_setting()
        with self._lock:
            if sess.pending >= limit:
                counter_inc("stream.backpressure_429")
                raise StreamBusy(sess.stream_id, sess.durable_cursor(),
                                 retry_after_s=retry_after_s)
            sess.pending += 1
            sess.pending_rows += max(0, int(rows))
        self._publish_gauges()
        return sess

    def release(self, stream_id: Any, rows: int) -> None:
        try:
            sid = validate_stream_id(stream_id)
        except ValueError:
            return
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                return
            sess.pending = max(0, sess.pending - 1)
            sess.pending_rows = max(0, sess.pending_rows - max(0, int(rows)))
        self._publish_gauges()

    def lag_rows(self) -> int:
        with self._lock:
            return sum(s.pending_rows for s in self._sessions.values())

    def recovering_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values() if s.recovering)

    def active_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _publish_gauges(self) -> None:
        gauge_set("stream.lag_rows", self.lag_rows())
        gauge_set("stream.active", self.active_count())
        gauge_set("stream.recovering", self.recovering_count())

    def durable_cursors(self) -> Dict[str, Any]:
        """Resume points for every stream under the root — disk is the
        authority, so a drain reports chains this process never touched
        (they arrived via the shared fleet cache root)."""
        out: Dict[str, Any] = {}
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in sorted(names):
            d = os.path.join(self.root, name)
            if not os.path.isdir(d) or name == "quarantine":
                continue
            cursor = load_durable_cursor(d, store_root=self.store_root)
            if cursor is not None:
                out[name] = cursor
        return out
