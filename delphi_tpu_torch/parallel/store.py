"""The durable store: every artifact the port writes to disk goes through
here, in the JAX package's envelope format, so each package reads the
other's JSON and JSONL files.

Envelope (one header line, then the raw payload bytes)::

    #DELPHI-STORE v1 <schema> <length> <crc32hex>\\n
    <payload bytes>

The header names what the artifact is, its payload length (a truncated
write shows) and a crc32 of the payload (a damaged one shows). JSON
payloads stay readable below the header; JSONL payloads stay
line-parseable when ``#``-prefixed lines are skipped.

Writes go to a temporary file in the same directory, which is fsynced,
renamed over the destination and followed by an fsync of the directory,
so a crash leaves either the old file or the new one. Between the fsync
and the rename every write passes its site's fault-injection point
(:mod:`delphi_tpu_torch.parallel.resilience`): ``store.<site>:N:torn_write``
truncates the destination, ``store.<site>:N:crash`` exits the process.

A read returns ``(payload, status)``, status one of ``ok``, ``missing``,
``legacy`` (no envelope header) or ``corrupt``. A corrupt file is counted
and moved into ``<root>/quarantine/``, so it is never loaded again; the
caller sees a cache miss. Pickles are read through an unpickler that
admits only the classes of ``builtins``, ``collections``, ``datetime``,
numpy, pandas (with pyarrow, which backs pandas' string columns), torch
and this package: a pickle naming any other class
(one the JAX package wrote holds ``delphi_tpu`` classes, and loading them
would import JAX) reads as corrupt.

``DELPHI_STORE_QUOTA_GB`` arms a lock-file-guarded LRU sweep of a root
after writes (validated reads bump atime); :func:`fsck` validates a whole
root (``python -m delphi_tpu_torch.main --fsck ROOT``).
"""

import io
import json
import os
import pickle
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from delphi_tpu_torch.parallel.resilience import StoreCorrupt, note_fault
from delphi_tpu_torch.utils import counter_inc, gauge_set, setup_logger

_logger = setup_logger()

MAGIC = b"#DELPHI-STORE"
ENVELOPE_VERSION = 1

QUARANTINE_DIR = "quarantine"
_GC_LOCK_FILE = ".store_gc.lock"
_TMP_PREFIX = ".store_"

#: Every durable-store site, with the artifact it covers (the JAX
#: package's list; the port writes the provenance, manifest, snapshot-state
#: and stream sites so far).
STORE_SITES: Dict[str, str] = {
    "store.plan": "launch-plan documents (parallel/planner.py PlanStore)",
    "store.checkpoint": "phase checkpoints + stall/rank-loss markers",
    "store.model": "trained-model checkpoints (model.checkpoint_path)",
    "store.manifest": "snapshot manifest.json (incremental/manifest.py)",
    "store.snapshot_state": "snapshot state.pkl (incremental/manifest.py)",
    "store.provenance": "provenance ledger JSONL dumps",
    "store.report": "run-report JSON files",
    "store.fleet": "fleet worker registration files",
    "store.stream_cursor": "per-stream durable cursors "
                           "(incremental/stream.py, one file per commit)",
    "store.stream_state": "per-stream accumulated tables "
                          "(incremental/stream.py, one file per commit)",
    "store.trace": "distributed-trace part files "
                   "(observability/trace.py, one file per process)",
}

#: Schema tags paired with the sites above: fsck reports per-store health
#: from the tag in each envelope header.
SCHEMA_SITES: Dict[str, str] = {
    "launch_plan": "store.plan",
    "phase_ckpt": "store.checkpoint",
    "marker": "store.checkpoint",
    "model_ckpt": "store.model",
    "snapshot_manifest": "store.manifest",
    "snapshot_state": "store.snapshot_state",
    "provenance": "store.provenance",
    "run_report": "store.report",
    "fleet_reg": "store.fleet",
    "stream_cursor": "store.stream_cursor",
    "stream_state": "store.stream_state",
    "trace": "store.trace",
    "launch_ledger": "store.plan",
}

# the top-level modules whose classes a stored pickle may name; pyarrow
# arrays back pandas' string columns under pandas 3
_PICKLE_MODULES = frozenset({"builtins", "collections", "datetime", "numpy",
                             "pandas", "pyarrow", "torch",
                             "delphi_tpu_torch"})

# roots this process has touched (quarantine_count without a root)
_seen_roots: set = set()
_seen_lock = threading.Lock()

# per-root monotonic stamp of the last post-write sweep; under _seen_lock
_last_gc: Dict[str, float] = {}


# -- envelope ---------------------------------------------------------------

def encode_envelope(payload: bytes, schema: str) -> bytes:
    """Frames payload bytes: magic, version, schema tag, length, crc32."""
    if not isinstance(payload, bytes):
        raise TypeError(f"payload must be bytes, got {type(payload)}")
    header = (f"{MAGIC.decode()} v{ENVELOPE_VERSION} {schema} "
              f"{len(payload)} {zlib.crc32(payload) & 0xFFFFFFFF:08x}\n")
    return header.encode("ascii") + payload


def decode_envelope(blob: bytes,
                    schema: Optional[str] = None) -> Tuple[bytes, str]:
    """Validates a framed blob and returns ``(payload, schema_tag)``.
    Raises :class:`StoreCorrupt` on any defect, and ``ValueError`` for a
    blob without the magic prefix (a file written before the envelope)."""
    if not blob.startswith(MAGIC):
        raise ValueError("not a delphi-store envelope")
    nl = blob.find(b"\n")
    if nl < 0:
        raise StoreCorrupt("envelope header truncated (no newline)")
    try:
        fields = blob[:nl].decode("ascii").split()
    except UnicodeDecodeError as e:
        raise StoreCorrupt(f"envelope header undecodable: {e}")
    if len(fields) != 5:
        raise StoreCorrupt(
            f"envelope header malformed ({len(fields)} fields, want 5)")
    _, version, tag, length, crc_hex = fields
    if version != f"v{ENVELOPE_VERSION}":
        raise StoreCorrupt(f"unknown envelope version {version!r}")
    if schema is not None and tag != schema:
        raise StoreCorrupt(
            f"schema mismatch: file says {tag!r}, expected {schema!r}")
    try:
        want_len = int(length)
        want_crc = int(crc_hex, 16)
    except ValueError:
        raise StoreCorrupt("envelope length/crc fields unparsable")
    payload = blob[nl + 1:]
    if len(payload) != want_len:
        raise StoreCorrupt(
            f"payload truncated: {len(payload)} bytes, header "
            f"promised {want_len}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != want_crc:
        raise StoreCorrupt("payload crc32 mismatch")
    return payload, tag


# -- roots / quarantine -----------------------------------------------------

def _root_for(path: str, root: Optional[str]) -> str:
    r = os.path.abspath(root) if root else os.path.dirname(
        os.path.abspath(path))
    with _seen_lock:
        _seen_roots.add(r)
    return r


def quarantine_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), QUARANTINE_DIR)


def quarantine_count(root: Optional[str] = None) -> int:
    """Files in quarantine under ``root``, or under every root this process
    has touched."""
    if root is not None:
        roots = [os.path.abspath(root)]
    else:
        with _seen_lock:
            roots = sorted(_seen_roots)
    n = 0
    for r in roots:
        try:
            n += sum(1 for e in os.scandir(quarantine_dir(r))
                     if e.is_file())
        except OSError:
            pass
    return n


def quarantine(path: str, root: str, reason: str, site: str) -> Optional[str]:
    """Moves a corrupt artifact into ``<root>/quarantine/`` (unlinks it when
    even the rename fails), so it is never loaded again but stays
    inspectable. Returns the quarantined path."""
    qdir = quarantine_dir(root)
    base = os.path.basename(path)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, base)
        i = 1
        while os.path.exists(dest):
            dest = os.path.join(qdir, f"{base}.{i}")
            i += 1
        os.replace(path, dest)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            return None
        dest = None
    counter_inc("store.quarantined")
    _logger.warning(f"{site}: quarantined corrupt artifact {path} "
                    f"({reason})" + (f" -> {dest}" if dest else " (removed)"))
    return dest


def _note_corrupt(path: str, site: str, root: str, exc: BaseException) -> None:
    counter_inc("store.corrupt")
    note_fault(exc, site)
    quarantine(path, root, str(exc), site)


# -- atomic writes ----------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # no directory fds on this platform: the rename must do
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _torn_offset(site: str, length: int) -> int:
    # deterministic tear point, the JAX package's, so a replay tears alike
    return zlib.crc32(site.encode()) % max(1, length)


def _inject_mid_write(site: str, blob: bytes, path: str) -> bool:
    """The store's chaos point, after the temporary file is written and
    fsynced, before the rename. A ``torn_write`` entry writes a truncated
    copy of the envelope to the destination and returns True (the caller
    skips the rename and believes the write succeeded); a ``crash`` entry
    exits the process inside the injection point."""
    from delphi_tpu_torch.parallel import resilience as rz
    try:
        rz._maybe_inject(site)
    except rz.FaultInjected as e:
        if e.kind != "torn_write":
            raise
        cut = _torn_offset(site, len(blob))
        with open(path, "wb") as f:
            f.write(blob[:cut])
            f.flush()
            os.fsync(f.fileno())
        counter_inc("store.torn_writes")
        _logger.warning(f"{site}: injected torn write: {path} truncated "
                        f"at byte {cut} of {len(blob)}")
        return True
    return False


def write_bytes(path: str, payload: bytes, *, schema: str, site: str,
                root: Optional[str] = None) -> None:
    """Writes one envelope-framed artifact crash-consistently. ``root`` is
    the cache root whose quarantine and quota apply (default: the file's
    directory). Raises ``OSError`` upward."""
    r = _root_for(path, root)
    blob = encode_envelope(payload, schema)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX, dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        if _inject_mid_write(site, blob, path):
            os.unlink(tmp)
        else:
            os.replace(tmp, path)
            _fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    counter_inc("store.writes")
    _logger.debug(f"{site}: wrote {path} ({len(blob)} bytes)")
    maybe_gc(r)


def read_bytes(path: str, *, schema: str, site: str,
               root: Optional[str] = None) -> Tuple[Optional[bytes], str]:
    """Validated read: ``(payload, "ok")``, ``(None, "missing")``,
    ``(raw_blob, "legacy")`` for a file without an envelope, or
    ``(None, "corrupt")`` after the file was counted and quarantined."""
    r = _root_for(path, root)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        if not isinstance(e, FileNotFoundError):
            _logger.warning(f"{site}: unreadable {path}: {e}")
        counter_inc("store.misses")
        return None, "missing"
    try:
        payload, _ = decode_envelope(blob, schema)
    except StoreCorrupt as e:
        _note_corrupt(path, site, r, e)
        return None, "corrupt"
    except ValueError:
        counter_inc("store.legacy")
        return blob, "legacy"
    counter_inc("store.reads")
    try:
        # LRU recency for the quota sweep: only atime moves, so mtime keeps
        # meaning "content last written"
        st = os.stat(path)
        os.utime(path, ns=(time.time_ns(), st.st_mtime_ns))
    except OSError:
        pass
    return payload, "ok"


def mark_corrupt(path: str, site: str, reason: str,
                 root: Optional[str] = None) -> None:
    """Quarantines a file whose envelope validated but whose payload the
    consumer could not deserialize: the same counters as an envelope
    failure."""
    _note_corrupt(path, site, _root_for(path, root), StoreCorrupt(reason))


def write_json(path: str, obj: Any, *, schema: str, site: str,
               root: Optional[str] = None, indent: Optional[int] = None,
               sort_keys: bool = True) -> None:
    # no default= fallback: a payload json cannot encode raises before any
    # file operation, so an existing artifact survives intact
    body = json.dumps(obj, sort_keys=sort_keys, indent=indent) + "\n"
    write_bytes(path, body.encode("utf-8"), schema=schema, site=site,
                root=root)


def read_json(path: str, *, schema: str, site: str,
              root: Optional[str] = None) -> Tuple[Optional[Any], str]:
    payload, status = read_bytes(path, schema=schema, site=site, root=root)
    if payload is None:
        return None, status
    try:
        return json.loads(payload.decode("utf-8")), status
    except (ValueError, UnicodeDecodeError) as e:
        mark_corrupt(path, site, f"json payload unparsable: {e}", root)
        return None, "corrupt"


class _PortUnpickler(pickle.Unpickler):
    """Admits only the classes of :data:`_PICKLE_MODULES`."""

    def find_class(self, module: str, name: str) -> Any:
        if module.split(".", 1)[0] not in _PICKLE_MODULES:
            raise pickle.UnpicklingError(
                f"class {module}.{name} is outside the modules a "
                "delphi_tpu_torch store pickle may name")
        return super().find_class(module, name)


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as its CPU copy: no store file holds a CUDA
    tensor, and the objects pickled stay where they are."""

    def reducer_override(self, obj: Any) -> Any:
        import torch
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return obj.detach().cpu().__reduce_ex__(pickle.DEFAULT_PROTOCOL)
        return NotImplemented


def write_pickle(path: str, obj: Any, *, schema: str, site: str,
                 root: Optional[str] = None) -> None:
    buf = io.BytesIO()
    _HostPickler(buf).dump(obj)
    write_bytes(path, buf.getvalue(), schema=schema, site=site, root=root)


def read_pickle(path: str, *, schema: str, site: str,
                root: Optional[str] = None) -> Tuple[Optional[Any], str]:
    """Pickles run code as they load: point the store only at directories
    this package wrote. A pickle naming a class outside
    :data:`_PICKLE_MODULES` (a JAX-written one, say) reads as corrupt and
    is quarantined, as any unreadable pickle is; nothing is imported for
    it."""
    payload, status = read_bytes(path, schema=schema, site=site, root=root)
    if payload is None:
        return None, status
    try:
        return _PortUnpickler(io.BytesIO(payload)).load(), status
    except Exception as e:
        mark_corrupt(path, site, f"pickle payload unparsable: {e}", root)
        return None, "corrupt"


def write_jsonl(path: str, rows: Iterable[Any], *, schema: str, site: str,
                root: Optional[str] = None) -> None:
    # one encoder for every line: the bytes of json.dumps(r, default=str)
    body = "\n".join(map(json.JSONEncoder(default=str).encode, rows))
    body += "\n" if body else ""
    write_bytes(path, body.encode("utf-8"), schema=schema, site=site,
                root=root)


def read_jsonl(path: str, *, schema: str, site: str,
               root: Optional[str] = None) -> Tuple[Optional[List[Any]], str]:
    payload, status = read_bytes(path, schema=schema, site=site, root=root)
    if payload is None:
        return None, status
    try:
        lines = payload.decode("utf-8").splitlines()
        return [json.loads(ln) for ln in lines
                if ln.strip() and not ln.startswith("#")], status
    except (ValueError, UnicodeDecodeError) as e:
        mark_corrupt(path, site, f"jsonl payload unparsable: {e}", root)
        return None, "corrupt"


def replace_file(src: str, dst: str) -> None:
    """Durable same-volume rename (``os.replace``, then a directory fsync)
    for moves inside the store, such as archiving a snapshot manifest into
    its chain."""
    os.replace(src, dst)
    _fsync_dir(os.path.dirname(os.path.abspath(dst)) or ".")


# -- quota GC ---------------------------------------------------------------

def quota_bytes() -> Optional[int]:
    """``DELPHI_STORE_QUOTA_GB`` as bytes, or None when unset or unparsable
    (no sweep)."""
    raw = os.environ.get("DELPHI_STORE_QUOTA_GB")
    if raw is None or not raw.strip():
        return None
    try:
        gb = float(raw.strip())
    except ValueError:
        _logger.warning(f"DELPHI_STORE_QUOTA_GB: unparsable {raw!r}")
        return None
    return max(0, int(gb * (1 << 30)))


def _env_seconds(name: str, default: float, least: float) -> float:
    raw = os.environ.get(name)
    try:
        return max(least, float(raw)) if raw and raw.strip() else default
    except ValueError:
        return default


def _acquire_gc_lock(root: str, now: Optional[float] = None) -> Optional[str]:
    """O_CREAT|O_EXCL lock file: one sweeper per root across processes. A
    lock older than ``DELPHI_STORE_GC_LOCK_STALE_S`` (default 600 s) is
    presumed left by a killed sweeper and broken."""
    lock = os.path.join(root, _GC_LOCK_FILE)
    for attempt in (0, 1):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()} {time.time()}\n")
            return lock
        except FileExistsError:
            try:
                age = (now if now is not None else time.time()) \
                    - os.path.getmtime(lock)
            except OSError:
                continue  # the holder finished between open and stat
            if attempt == 0 and age > _env_seconds(
                    "DELPHI_STORE_GC_LOCK_STALE_S", 600.0, 1.0):
                _logger.warning(f"breaking stale GC lock {lock} "
                                f"({age:.0f}s old)")
                try:
                    os.unlink(lock)
                except OSError:
                    pass
                continue
            counter_inc("store.gc.lock_busy")
            return None
        except OSError:
            return None
    return None


def _is_tmp_debris(name: str) -> bool:
    return name.startswith((_TMP_PREFIX, ".snap_", ".run_report_",
                            ".provenance_", ".phase_")) \
        or name.endswith(".tmp")


def gc_sweep(root: str, quota: Optional[int] = None,
             protect: Iterable[str] = (),
             now: Optional[float] = None) -> Dict[str, Any]:
    """One quota sweep of a root, under the lock: removes temporary files
    older than a minute (crash debris), compacts snapshot manifest chains
    to their live base, then evicts the least recently used files (the
    later of write and validated read) until the root fits ``quota``
    (default: the environment's). Paths under a ``protect`` prefix and
    the quarantine are never evicted. Returns a summary, or
    ``{"skipped": ...}`` when another process holds the lock or no quota
    applies."""
    root = os.path.abspath(root)
    quota = quota_bytes() if quota is None else quota
    if quota is None:
        return {"skipped": "no quota"}
    lock = _acquire_gc_lock(root, now=now)
    if lock is None:
        return {"skipped": "locked"}
    from delphi_tpu_torch.incremental import manifest as mf
    try:
        counter_inc("store.gc.sweeps")
        tick = now if now is not None else time.time()
        protect_abs = tuple(os.path.abspath(p) for p in protect)
        removed_tmp = 0
        compacted = 0
        entries: List[Tuple[float, int, str]] = []  # (recency, size, path)
        for dirpath, dirnames, filenames in os.walk(root):
            # quarantined evidence is exempt; nested roots keep their own
            # quarantine directories, so prune by name at every level
            dirnames[:] = [d for d in dirnames if d != QUARANTINE_DIR]
            if mf.MANIFEST_FILE in filenames:
                compacted += mf.compact_chain(dirpath, keep=0)
                filenames = [n for n in os.listdir(dirpath)
                             if os.path.isfile(os.path.join(dirpath, n))]
            for name in filenames:
                path = os.path.join(dirpath, name)
                if name == _GC_LOCK_FILE:
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                if _is_tmp_debris(name):
                    # only debris old enough that no live writer owns it
                    if tick - st.st_mtime > 60.0:
                        try:
                            os.unlink(path)
                            removed_tmp += 1
                        except OSError:
                            pass
                    continue
                entries.append((max(st.st_atime, st.st_mtime),
                                int(st.st_size), path))
        total = sum(size for _, size, _ in entries)
        evicted_files = 0
        evicted_bytes = 0
        entries.sort()  # least recently used first
        for _, size, path in entries:
            if total <= quota:
                break
            if any(os.path.abspath(path).startswith(p)
                   for p in protect_abs):
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted_files += 1
            evicted_bytes += size
        counter_inc("store.gc.evicted_files", evicted_files)
        gauge_set("store.root_bytes", float(total))
        if evicted_files or removed_tmp or compacted:
            _logger.info(
                f"store GC swept {root}: evicted {evicted_files} files "
                f"({evicted_bytes} bytes), {removed_tmp} tmp orphans, "
                f"{compacted} chain manifests; {total} bytes remain "
                f"(quota {quota})")
        return {"root": root, "quota": quota, "total_bytes": total,
                "evicted_files": evicted_files,
                "evicted_bytes": evicted_bytes,
                "tmp_removed": removed_tmp, "chain_compacted": compacted}
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def maybe_gc(root: str) -> None:
    """Sweep after a write: at most once per ``DELPHI_STORE_GC_INTERVAL_S``
    (default 60 s) per root, only when a quota is set. Never raises: the
    sweep must not fail the write that triggered it."""
    if quota_bytes() is None:
        return
    root = os.path.abspath(root)
    tick = time.monotonic()
    with _seen_lock:
        last = _last_gc.get(root)
        if last is not None and tick - last < _env_seconds(
                "DELPHI_STORE_GC_INTERVAL_S", 60.0, 0.0):
            return
        _last_gc[root] = tick
    try:
        gc_sweep(root)
    except Exception as e:  # pragma: no cover - defensive
        _logger.warning(f"store GC sweep of {root} failed: {e}")


def reset_gc_state() -> None:
    """Forgets per-root sweep stamps and seen roots (tests)."""
    with _seen_lock:
        _last_gc.clear()
        _seen_roots.clear()


# -- fsck -------------------------------------------------------------------

def fsck(root: str, repair: bool = True) -> Dict[str, Any]:
    """Scans a root: validates every envelope and reports per-store health
    keyed by the schema tags found; with ``repair``, quarantines corrupt
    files, removes temporary files and runs a quota sweep. Files without
    an envelope are reported and left alone."""
    root = os.path.abspath(root)
    _root_for(os.path.join(root, "x"), root)
    per_store: Dict[str, Dict[str, int]] = {}
    summary: Dict[str, Any] = {"root": root, "scanned": 0, "ok": 0,
                               "legacy": 0, "corrupt": 0, "quarantined": 0,
                               "tmp_removed": 0}

    def bucket(tag: str) -> Dict[str, int]:
        return per_store.setdefault(
            tag, {"ok": 0, "legacy": 0, "corrupt": 0})

    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != QUARANTINE_DIR]
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            if name == _GC_LOCK_FILE:
                continue
            if _is_tmp_debris(name):
                if repair:
                    try:
                        os.unlink(path)
                        summary["tmp_removed"] += 1
                    except OSError:
                        pass
                continue
            summary["scanned"] += 1
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            if not blob.startswith(MAGIC):
                summary["legacy"] += 1
                bucket("(legacy)")["legacy"] += 1
                continue
            try:
                _, tag = decode_envelope(blob)
            except StoreCorrupt as e:
                summary["corrupt"] += 1
                nl = blob.find(b"\n")
                head = blob[:nl if 0 <= nl < 200 else 200]
                fields = head.decode("ascii", "replace").split()
                tag = fields[2] if len(fields) >= 3 else "(unreadable)"
                bucket(tag)["corrupt"] += 1
                if repair:
                    site = SCHEMA_SITES.get(tag, "store.fsck")
                    counter_inc("store.corrupt")
                    note_fault(StoreCorrupt(f"fsck: {path}: {e}"), site)
                    if quarantine(path, root, str(e), site):
                        summary["quarantined"] += 1
                continue
            summary["ok"] += 1
            bucket(tag)["ok"] += 1
    summary["per_store"] = per_store
    summary["quarantine_files"] = quarantine_count(root)
    summary["gc"] = gc_sweep(root) if repair else {"skipped": "report-only"}
    return summary
