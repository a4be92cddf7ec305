"""Snapshot manifests: content identity of an encoded table, persisted.

A snapshot directory holds two files:

* ``manifest.json`` — versioned, JSON, atomic: per-column whole-content
  fingerprints, chunked row-block fingerprints (``block_rows`` rows per
  block), capped per-column value histograms (the drift gate's baseline),
  and the row-id column's fingerprints. Everything the delta planner needs
  to diff an incoming table WITHOUT touching the prior data.
* ``state.pkl`` — pickle, atomic: the prior repair-candidates frame, the
  trained per-attribute models (their tensors on the CPU), and the
  provenance ledger entries the executor splices reused cells from. The
  store reads it through an unpickler that admits this package's classes
  and no other package's, so a ``state.pkl`` the JAX package wrote reads
  as corrupt (a counted fallback to a full run, which rewrites it).

Fingerprints hash the DECODED value strings (vocab spellings), so they are
invariant under column reorder (columns key by name), vocab permutation
(two encodings of the same data always agree), and block-size changes (the
whole-column fingerprint never looks at block boundaries). A manifest is
the JAX package's dict for the same table, ``snapshot_id`` included, so
the JSON file reads alike in both packages.
"""

import hashlib
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from delphi_tpu_torch.parallel import store as dstore
from delphi_tpu_torch.parallel.resilience import fingerprint_digest
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.table import EncodedTable
from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()

MANIFEST_VERSION = 1
MANIFEST_FILE = "manifest.json"
STATE_FILE = "state.pkl"

# rows per fingerprint block: DELPHI_SNAPSHOT_BLOCK_ROWS /
# repair.snapshot.block_rows (block granularity of the updated-row diff)
_DEFAULT_BLOCK_ROWS = 4096
# value histograms keep the top-K values by count; the tail folds into
# "__other__" so a manifest never grows with the domain
_HISTOGRAM_TOP_K = 64

_NULL_SENTINEL = "\x00NULL"
_SEP = "\x1f"


def block_rows_setting() -> int:
    """``DELPHI_SNAPSHOT_BLOCK_ROWS`` env over the
    ``repair.snapshot.block_rows`` session conf (default 4096)."""
    env = os.environ.get("DELPHI_SNAPSHOT_BLOCK_ROWS")
    if env:
        return max(1, int(env))
    conf = get_session().conf.get("repair.snapshot.block_rows")
    return max(1, int(conf)) if conf else _DEFAULT_BLOCK_ROWS


def _sha1(text: str) -> str:
    return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()


def value_strings(table: EncodedTable, name: str) -> List[str]:
    """Per-row canonical value spellings of one column (NULL -> sentinel):
    the byte stream both the whole-column and the block fingerprints hash."""
    if name == table.row_id:
        return [str(v) for v in table.row_id_values.tolist()]
    decoded = table.column(name).decode()
    return [_NULL_SENTINEL if v is None else str(v) for v in decoded.tolist()]


def fingerprint_values(values: List[str], block: int) -> Tuple[str, List[str]]:
    """(whole-column sha1, per-block sha1 list). The whole fingerprint hashes
    the full value stream directly — block boundaries never enter it — so it
    is stable across ``block_rows`` settings; a block fingerprint depends
    only on its own rows."""
    whole = _sha1(_SEP.join(values))
    blocks = [_sha1(_SEP.join(values[lo:lo + block]))
              for lo in range(0, len(values), block)]
    return whole, blocks


def value_histogram(table: EncodedTable, name: str) -> Dict[str, Any]:
    """Capped value-count histogram of one column — the snapshot-side
    baseline the planner's PSI drift gate compares future runs against."""
    col = table.column(name)
    codes = col.codes
    valid = codes >= 0
    counts = np.bincount(codes[valid], minlength=len(col.vocab)) \
        if valid.any() else np.zeros(len(col.vocab), dtype=np.int64)
    # deterministic top-K: count desc, then spelling asc
    order = sorted(range(len(counts)), key=lambda i: (-int(counts[i]),
                                                      str(col.vocab[i])))
    top = [i for i in order[:_HISTOGRAM_TOP_K] if counts[i] > 0]
    values = {str(col.vocab[i]): int(counts[i]) for i in top}
    other = int(counts.sum()) - sum(values.values())
    return {"values": values, "other": other,
            "null": int((~valid).sum())}


def build_manifest(table: EncodedTable, options_digest: str = "",
                   mode: str = "repair_candidates",
                   block: Optional[int] = None) -> Dict[str, Any]:
    """Builds the manifest dict for an encoded table (no I/O)."""
    block = block or block_rows_setting()
    rid_values = value_strings(table, table.row_id)
    rid_whole, rid_blocks = fingerprint_values(rid_values, block)
    columns: Dict[str, Any] = {}
    for c in table.columns:
        vals = value_strings(table, c.name)
        whole, blocks = fingerprint_values(vals, block)
        columns[c.name] = {
            "kind": c.kind,
            "value_sha1": whole,
            "block_sha1": blocks,
            "histogram": value_histogram(table, c.name),
        }
    manifest = {
        "version": MANIFEST_VERSION,
        "row_id": {"name": table.row_id, "kind": table.row_id_kind,
                   "value_sha1": rid_whole, "block_sha1": rid_blocks},
        "n_rows": int(table.n_rows),
        "block_rows": int(block),
        "columns": columns,
        "options_digest": options_digest,
        "mode": mode,
        "merged": False,
    }
    manifest["snapshot_id"] = fingerprint_digest(manifest)[:16]
    return manifest


def merge_manifests(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Merges two ROW-SHARDED manifests of one logical table (multi-host:
    each process snapshots its shard, ranks merge like run reports). Block
    fingerprint lists concatenate in argument order and histograms sum; the
    whole-column fingerprints combine as a hash chain, so a merged manifest
    supports block-level diffing and drift gating but not the whole-column
    short-circuit (``merged`` is set and the planner knows)."""
    if a.get("version") != b.get("version") \
            or a.get("block_rows") != b.get("block_rows") \
            or a["row_id"]["name"] != b["row_id"]["name"] \
            or set(a["columns"]) != set(b["columns"]):
        raise ValueError("manifests are not shards of one table "
                         "(version/block_rows/row_id/columns differ)")
    out: Dict[str, Any] = {
        "version": a["version"],
        "row_id": {
            "name": a["row_id"]["name"], "kind": a["row_id"]["kind"],
            "value_sha1": _sha1(a["row_id"]["value_sha1"]
                                + b["row_id"]["value_sha1"]),
            "block_sha1": list(a["row_id"]["block_sha1"])
            + list(b["row_id"]["block_sha1"]),
        },
        "n_rows": int(a["n_rows"]) + int(b["n_rows"]),
        "block_rows": a["block_rows"],
        "columns": {},
        "options_digest": a.get("options_digest", ""),
        "mode": a.get("mode", "repair_candidates"),
        "merged": True,
    }
    for name, ca in a["columns"].items():
        cb = b["columns"][name]
        hist = {"values": dict(ca["histogram"]["values"]),
                "other": int(ca["histogram"]["other"])
                + int(cb["histogram"]["other"]),
                "null": int(ca["histogram"]["null"])
                + int(cb["histogram"]["null"])}
        for v, n in cb["histogram"]["values"].items():
            hist["values"][v] = hist["values"].get(v, 0) + int(n)
        out["columns"][name] = {
            "kind": ca["kind"],
            "value_sha1": _sha1(ca["value_sha1"] + cb["value_sha1"]),
            "block_sha1": list(ca["block_sha1"]) + list(cb["block_sha1"]),
            "histogram": hist,
        }
    out["snapshot_id"] = fingerprint_digest(out)[:16]
    return out


# -- persistence --------------------------------------------------------------
#
# All snapshot I/O rides the durable-store seam (parallel/store.py):
# envelope-framed crash-consistent writes at sites ``store.manifest`` /
# ``store.snapshot_state``, with corrupt/truncated files quarantined as
# misses (the caller falls back to a full run, which repopulates).

#: archived chain manifests: ``manifest.<snapshot_id>.json``
_CHAIN_RE = re.compile(r"^manifest\.([0-9a-f]{16})\.json$")

#: default chain length retained at write time (DELPHI_SNAPSHOT_CHAIN_KEEP)
_DEFAULT_CHAIN_KEEP = 4


def chain_keep_setting() -> int:
    """``DELPHI_SNAPSHOT_CHAIN_KEEP``: how many superseded manifests the
    delta chain retains after each snapshot write (default 4). The quota
    GC sweep and fsck compact harder — down to the single live base — so
    delta serving stays O(1) on disk regardless of run count."""
    env = os.environ.get("DELPHI_SNAPSHOT_CHAIN_KEEP")
    try:
        return max(0, int(env)) if env and env.strip() else \
            _DEFAULT_CHAIN_KEEP
    except ValueError:
        return _DEFAULT_CHAIN_KEEP


def chain_files(directory: str) -> List[str]:
    """Archived chain manifests, oldest first (by mtime, name-tiebroken)."""
    try:
        names = [n for n in os.listdir(directory) if _CHAIN_RE.match(n)]
    except OSError:
        return []
    paths = [os.path.join(directory, n) for n in names]

    def key(p: str):
        try:
            return (os.path.getmtime(p), p)
        except OSError:
            return (0.0, p)
    return sorted(paths, key=key)


def compact_chain(directory: str, keep: Optional[int] = None) -> int:
    """Folds a snapshot's manifest chain down to ``keep`` archived entries
    (default: the env setting) plus the live base ``manifest.json``.
    Returns the number of chain files removed."""
    keep = chain_keep_setting() if keep is None else max(0, int(keep))
    files = chain_files(directory)
    removed = 0
    for path in files[:max(0, len(files) - keep)]:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    if removed:
        counter_inc("store.chain_compacted", removed)
        _logger.info(f"Compacted snapshot manifest chain in {directory}: "
                     f"removed {removed} superseded manifests "
                     f"(keeping {keep})")
    return removed


def write_snapshot(directory: str, manifest: Dict[str, Any],
                   state: Dict[str, Any]) -> None:
    """Persists a snapshot crash-consistently: the state pickle lands
    before the manifest, so a reader never sees a manifest pointing at a
    half-written state (a kill between the two leaves the PREVIOUS
    snapshot's manifest paired with the new state — detected by the
    fingerprint diff, which falls back to a full run). A superseded
    manifest is archived into the delta chain
    (``manifest.<snapshot_id>.json``) and the chain is compacted to
    ``DELPHI_SNAPSHOT_CHAIN_KEEP`` entries."""
    os.makedirs(directory, exist_ok=True)
    dstore.write_pickle(os.path.join(directory, STATE_FILE), state,
                        schema="snapshot_state",
                        site="store.snapshot_state", root=directory)
    live = os.path.join(directory, MANIFEST_FILE)
    prior = load_manifest(directory)
    if prior is not None and prior.get("snapshot_id") \
            and prior.get("snapshot_id") != manifest.get("snapshot_id"):
        archived = os.path.join(
            directory, f"manifest.{prior['snapshot_id']}.json")
        try:
            dstore.replace_file(live, archived)
            manifest = dict(manifest)
            manifest["parent_snapshot_id"] = prior["snapshot_id"]
        except OSError as e:
            _logger.warning(f"could not archive superseded manifest "
                            f"{live}: {e}")
    dstore.write_json(live, manifest, schema="snapshot_manifest",
                      site="store.manifest", root=directory, indent=1)
    compact_chain(directory)
    _logger.info(f"Snapshot {manifest.get('snapshot_id')} written to "
                 f"{directory} ({manifest.get('n_rows')} rows)")


def load_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """Loads a manifest, or None when missing/corrupt/unknown-version (the
    caller falls back to a full run either way). A corrupt file is
    quarantined by the store seam, never silently loaded."""
    path = os.path.join(directory, MANIFEST_FILE)
    manifest, status = dstore.read_json(
        path, schema="snapshot_manifest", site="store.manifest",
        root=directory)
    if status in ("missing", "corrupt"):
        return None
    if not isinstance(manifest, dict) \
            or manifest.get("version") != MANIFEST_VERSION:
        _logger.warning(f"Ignoring snapshot manifest {path}: "
                        "unknown version")
        return None
    return manifest


def load_state(directory: str) -> Optional[Dict[str, Any]]:
    """Loads the state pickle (prior frame / models / ledger entries), or
    None when missing or unreadable (corrupt pickles are quarantined)."""
    state, status = dstore.read_pickle(
        os.path.join(directory, STATE_FILE), schema="snapshot_state",
        site="store.snapshot_state", root=directory)
    if status in ("missing", "corrupt"):
        return None
    return state if isinstance(state, dict) else None
