"""Delta planner: diff an incoming table against a snapshot manifest.

The planner is pure — it looks at the table and the manifest and produces
a :class:`DeltaPlan`; no I/O, no counters, no phase execution. The plan
classifies

* **columns** as clean (every overlap block fingerprint matches) or dirty,
* **rows** as unchanged, updated (inside a differing fingerprint block —
  block granularity, so a one-cell edit replans at most ``block_rows``
  rows per differing block) or appended (past the snapshot's row count),

then expands the dirty row set through the constraint dependency graph
(:mod:`~delphi_tpu_torch.incremental.depgraph`) so every row whose
denial-constraint neighborhood touched a dirty row is re-examined, and
gates per-attribute model reuse on a PSI drift check between the
snapshot's value histograms and the incoming table's.

Anything that breaks the delta contract (schema change, shrunk table,
re-keyed row ids, different option set) surfaces as ``fallback_reason``
and the executor runs the full pipeline instead — incremental mode never
errors where a full run would succeed.
"""

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from delphi_tpu_torch.constraints import Predicate
from delphi_tpu_torch.incremental.depgraph import expand_dirty_rows
from delphi_tpu_torch.incremental.manifest import (
    fingerprint_values, value_histogram, value_strings,
)
from delphi_tpu_torch.observability.drift import population_stability_index
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.table import EncodedTable

__all__ = ["DeltaPlan", "plan_delta", "drift_max_setting"]

# PSI above this between the snapshot histogram and the incoming table's
# marks the attribute drifted (0.1 is the folklore "moderate shift" knee;
# see delphi_tpu_torch/observability/drift.py)
_DEFAULT_DRIFT_MAX = 0.1


def drift_max_setting() -> float:
    """``DELPHI_INCREMENTAL_DRIFT_MAX`` env over the
    ``repair.incremental.drift_max`` session conf (default 0.1)."""
    env = os.environ.get("DELPHI_INCREMENTAL_DRIFT_MAX")
    if env:
        return float(env)
    conf = get_session().conf.get("repair.incremental.drift_max")
    return float(conf) if conf else _DEFAULT_DRIFT_MAX


@dataclass
class DeltaPlan:
    """What the executor runs: either a usable delta (``fallback_reason``
    is None) or a fall-back-to-full-run verdict."""
    fallback_reason: Optional[str] = None
    clean_columns: List[str] = field(default_factory=list)
    dirty_columns: List[str] = field(default_factory=list)
    rows_unchanged: int = 0
    updated_rows: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    appended_rows: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    expanded_rows: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    planned_rows: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    reusable_attrs: List[str] = field(default_factory=list)
    drifted_attrs: List[str] = field(default_factory=list)
    drift_psi: Dict[str, float] = field(default_factory=dict)

    @property
    def usable(self) -> bool:
        return self.fallback_reason is None

    def summary(self) -> Dict[str, Any]:
        """The run-report / recorder face of the plan."""
        return {
            "fallback_reason": self.fallback_reason,
            "columns_clean": len(self.clean_columns),
            "columns_dirty": len(self.dirty_columns),
            "rows_unchanged": int(self.rows_unchanged),
            "rows_updated": int(len(self.updated_rows)),
            "rows_appended": int(len(self.appended_rows)),
            "rows_expanded": int(len(self.expanded_rows)),
            "rows_planned": int(len(self.planned_rows)),
            "attrs_reusable": list(self.reusable_attrs),
            "attrs_drifted": list(self.drifted_attrs),
            "drift_psi": {k: round(v, 6)
                          for k, v in sorted(self.drift_psi.items())},
        }


def _aligned_hist_counts(cur: Dict[str, Any], base: Dict[str, Any]):
    """Aligns two value_histogram() dicts into parallel count vectors over
    the union of their value keys plus the __other__ / __null__ buckets."""
    keys = sorted(set(cur.get("values", {})) | set(base.get("values", {})))
    c = [float(cur.get("values", {}).get(k, 0)) for k in keys]
    b = [float(base.get("values", {}).get(k, 0)) for k in keys]
    c += [float(cur.get("other", 0)), float(cur.get("null", 0))]
    b += [float(base.get("other", 0)), float(base.get("null", 0))]
    return c, b


def plan_delta(table: EncodedTable, manifest: Optional[Dict[str, Any]],
               constraints: Sequence[Sequence[Predicate]] = (),
               options_digest: str = "",
               drift_max: Optional[float] = None) -> DeltaPlan:
    """Diffs ``table`` against ``manifest`` into a :class:`DeltaPlan`.

    Block fingerprints are recomputed with the MANIFEST's ``block_rows``
    (not the current setting), so a snapshot written under one chunk size
    diffs correctly after the knob changes.
    """
    if manifest is None:
        return DeltaPlan(fallback_reason="no_manifest")
    if manifest["row_id"]["name"] != table.row_id \
            or manifest["row_id"]["kind"] != table.row_id_kind:
        return DeltaPlan(fallback_reason="row_id_mismatch")
    if manifest.get("options_digest", "") != options_digest:
        return DeltaPlan(fallback_reason="options_changed")
    if set(manifest["columns"]) != set(table.column_names):
        return DeltaPlan(fallback_reason="schema_changed")
    n, n0 = table.n_rows, int(manifest["n_rows"])
    if n < n0:
        return DeltaPlan(fallback_reason="rows_removed")
    block = int(manifest["block_rows"])

    # the overlap's row ids must be byte-identical: the splice keys prior
    # per-cell decisions by row id, so a re-keyed table is a new table
    rid_vals = value_strings(table, table.row_id)[:n0]
    _, rid_blocks = fingerprint_values(rid_vals, block)
    if rid_blocks != list(manifest["row_id"]["block_sha1"]):
        return DeltaPlan(fallback_reason="row_ids_changed")

    drift_max = drift_max_setting() if drift_max is None else float(drift_max)
    plan = DeltaPlan()
    updated_mask = np.zeros(n0, dtype=bool)
    for name in table.column_names:
        entry = manifest["columns"][name]
        vals = value_strings(table, name)
        _, blocks = fingerprint_values(vals[:n0], block)
        base_blocks = list(entry["block_sha1"])
        diff = [i for i, (x, y) in enumerate(zip(blocks, base_blocks))
                if x != y]
        if diff:
            plan.dirty_columns.append(name)
            for i in diff:
                updated_mask[i * block:min((i + 1) * block, n0)] = True
        else:
            plan.clean_columns.append(name)
        # drift gate: snapshot histogram vs the incoming table's
        psi = population_stability_index(
            *_aligned_hist_counts(value_histogram(table, name),
                                  entry["histogram"]))
        plan.drift_psi[name] = psi
        if psi > drift_max:
            plan.drifted_attrs.append(name)
        elif not diff:
            plan.reusable_attrs.append(name)

    plan.updated_rows = np.nonzero(updated_mask)[0].astype(np.int64)
    plan.appended_rows = np.arange(n0, n, dtype=np.int64)
    plan.rows_unchanged = int(n0 - len(plan.updated_rows))
    dirty = np.concatenate([plan.updated_rows, plan.appended_rows])
    plan.planned_rows = expand_dirty_rows(table, constraints, dirty)
    plan.expanded_rows = np.setdiff1d(plan.planned_rows, dirty,
                                      assume_unique=False)
    return plan
