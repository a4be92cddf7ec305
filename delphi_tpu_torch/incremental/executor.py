"""Delta executor: thread a :class:`~delphi_tpu_torch.incremental.planner.
DeltaPlan` through the existing pipeline phases.

The executor owns the incremental run's lifecycle:

1. resolve the snapshot directory and load the prior manifest + state,
2. plan the delta (:func:`~delphi_tpu_torch.incremental.planner.plan_delta`),
3. run the UNMODIFIED pipeline (``RepairModel._run``) on the planned row
   subset only — detection, attr stats (K1 and K2 on the card), domain
   analysis and training all see a table holding just those rows
   (``EncodedTable.take_rows``), with frozen per-attribute models
   pre-seeded (on the run's device) for every attribute the drift gate
   cleared, so those targets skip training,
4. splice the subset's repair candidates into the prior frame (prior rows
   keep their decisions, planned rows get fresh ones) in the exact
   row-major order a from-scratch run emits, and splice the provenance
   ledger the same way (``splice: reused`` / ``recomputed`` per cell),
5. write the updated snapshot for the next delta, every model tensor on
   the CPU, so the snapshot loads on a machine without a card.

The spans ``incremental.load``, ``incremental.plan``,
``incremental.manifest`` and ``incremental.snapshot_write`` time the
plane's own work in ``utils.phase_walls``.

Anything that breaks the delta contract falls back to a full run with a
one-time warning and an ``incremental.fallback`` counter — incremental
mode never errors where a full run would succeed. The full run then
populates a fresh snapshot, so the NEXT invocation rides the delta.
"""

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.device import get_device
from delphi_tpu_torch.incremental import manifest as mf
from delphi_tpu_torch.incremental.planner import DeltaPlan, plan_delta
from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.parallel.resilience import fingerprint_digest
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.table import EncodedTable
from delphi_tpu_torch.utils import counter_inc, phase_span, setup_logger

_logger = setup_logger()

_TRUTHY = frozenset({"1", "true", "yes", "on"})

# one warning per (directory, reason) per process
_warned: set = set()

# option keys that must NOT enter the snapshot's options digest: they
# configure the snapshot machinery itself (or point at relocatable paths),
# so flipping them cannot invalidate prior repair decisions
_DIGEST_EXCLUDED_OPTS = frozenset({
    "model.checkpoint_path", "repair.snapshot.dir", "repair.incremental"})


def incremental_requested(model: Any) -> bool:
    """Whether this run should try the delta path: the model option
    ``repair.incremental`` (Python truthiness of its string) wins, then
    ``DELPHI_INCREMENTAL``, then the session conf (1/true/yes/on)."""
    if model._opt_incremental.key in model.opts:
        return bool(model._get_option_value(*model._opt_incremental))
    env = os.environ.get("DELPHI_INCREMENTAL")
    if env is not None:
        return env.strip().lower() in _TRUTHY
    conf = get_session().conf.get("repair.incremental")
    if conf is not None:
        return str(conf).strip().lower() in _TRUTHY
    return False


def snapshot_dir_for(model: Any) -> Optional[str]:
    """The snapshot directory, same precedence as
    :func:`incremental_requested`: model option ``repair.snapshot.dir``,
    then ``DELPHI_SNAPSHOT_DIR``, then the session conf."""
    if model._opt_snapshot_dir.key in model.opts:
        v = str(model._get_option_value(*model._opt_snapshot_dir)).strip()
        return v or None
    env = os.environ.get("DELPHI_SNAPSHOT_DIR")
    if env is not None and env.strip():
        return env.strip()
    conf = get_session().conf.get("repair.snapshot.dir")
    return str(conf).strip() if conf and str(conf).strip() else None


def options_digest(model: Any) -> str:
    """Identity of everything that shapes repair decisions BESIDES the
    table content: expert options, targets, detectors, setter knobs. A
    snapshot written under different options must not feed a delta run.
    Equal to the JAX package's digest for the same setup."""
    return fingerprint_digest({
        "version": 1,
        "opts": {k: v for k, v in sorted(model.opts.items())
                 if k not in _DIGEST_EXCLUDED_OPTS},
        "row_id": model.row_id,
        "targets": sorted(model.targets),
        "detectors": sorted(str(d) for d in model.error_detectors),
        "discrete_thres": int(model.discrete_thres),
        "repair_by_rules": bool(model.repair_by_rules),
        "rebalancing": bool(model.training_data_rebalancing_enabled),
    })


def _parsed_constraints(model: Any, table: EncodedTable,
                        input_name: str) -> List[Sequence[Any]]:
    """Every detector's denial-constraint predicate lists, for dirty-set
    expansion. Detectors without constraints contribute nothing (their
    checks are row-local, so no expansion is needed)."""
    from delphi_tpu_torch.errors import ConstraintErrorDetector
    preds: List[Sequence[Any]] = []
    for d in model.error_detectors:
        if isinstance(d, ConstraintErrorDetector):
            preds.extend(d.parsed_constraints(table, input_name).predicates)
    return preds


def _warn_once(directory: str, reason: str) -> None:
    counter_inc("incremental.fallback")
    key = (directory, reason)
    if key not in _warned:
        _warned.add(key)
        _logger.warning(
            f"Incremental repair requested but falling back to a full run "
            f"({reason}; snapshot dir: {directory or '<unset>'}). The full "
            f"run repopulates the snapshot, so the next run rides the "
            f"delta. This warning is emitted once per process.")


def _move_tensors(obj: Any, device: torch.device, seen: set) -> Any:
    """``obj`` with every tensor reachable through dicts, lists, tuples and
    this package's objects moved to ``device`` (containers and objects are
    updated in place; a tuple is rebuilt only when it held a tensor)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if id(obj) in seen:
        return obj
    seen.add(id(obj))
    if isinstance(obj, dict):
        for k, v in obj.items():
            obj[k] = _move_tensors(v, device, seen)
    elif isinstance(obj, list):
        obj[:] = [_move_tensors(v, device, seen) for v in obj]
    elif isinstance(obj, tuple):
        moved = tuple(_move_tensors(v, device, seen) for v in obj)
        if any(a is not b for a, b in zip(moved, obj)):
            return type(obj)(moved)
    elif type(obj).__module__.startswith("delphi_tpu_torch") \
            and hasattr(obj, "__dict__"):
        for k, v in vars(obj).items():
            setattr(obj, k, _move_tensors(v, device, seen))
    return obj


def models_to(models: Dict[str, Any], device: Any) -> Dict[str, Any]:
    """Per-attribute ``(model, features, transformers)`` entries with their
    tensors on ``device``."""
    seen: set = set()
    return {y: _move_tensors(m, torch.device(device), seen)
            for y, m in models.items()}


def _empty_candidates(model: Any) -> pd.DataFrame:
    return pd.DataFrame(
        columns=[model.row_id, "attribute", "current_value", "repaired"])


def _splice_frames(model: Any, table: EncodedTable,
                   prior: Optional[pd.DataFrame], fresh: pd.DataFrame,
                   planned_rids: set, rid_strs: List[str]) -> pd.DataFrame:
    """Prior rows outside the plan + fresh rows, in the row-major order
    (global row position, then attribute column rank) a from-scratch run's
    ``_extract_repair_candidates`` emits — so a clean-append delta frame is
    bit-identical to the full run's."""
    cols = [model.row_id, "attribute", "current_value", "repaired"]
    if prior is None or not len(prior):
        prior = _empty_candidates(model)
    if "repaired" not in fresh.columns:
        # the subset was already clean: _run's early return carries no
        # repaired column, and there is nothing to splice from it
        fresh = _empty_candidates(model)
    keep = ~prior[model.row_id].astype(str).isin(planned_rids)
    # empty parts stay out of the concat: an empty frame's object columns
    # would turn the other part's string columns into object ones, and
    # the spliced frame would no longer equal a from-scratch run's (the
    # JAX package keeps them, so its streamed frame can differ in dtype)
    parts = [p for p in (prior[keep][cols], fresh[cols]) if len(p)]
    if not parts:
        return _empty_candidates(model)
    combined = pd.concat(parts, ignore_index=True)
    pos_of = {rid: i for i, rid in enumerate(rid_strs)}
    gpos = combined[model.row_id].astype(str).map(pos_of).fillna(-1)
    rank_of = {name: i for i, name in enumerate(table.column_names)}
    ranks = combined["attribute"].map(rank_of).fillna(-1).astype(np.int64)
    order = np.lexsort((ranks.to_numpy(),
                        gpos.to_numpy(dtype=np.int64)))
    return combined.iloc[order].reset_index(drop=True)


def _save_snapshot(model: Any, table: EncodedTable, directory: str,
                   digest: str, frame: pd.DataFrame,
                   models: Optional[Any],
                   ledger_entries: Optional[List[Dict[str, Any]]]
                   ) -> Optional[str]:
    """Returns the written snapshot id — the chain head a streaming
    client's next delta must cite as its parent — or None when
    persistence failed (best-effort, never fails the run). The stored
    models hold no CUDA tensor."""
    try:
        with phase_span("incremental.manifest"):
            manifest = mf.build_manifest(table, options_digest=digest)
        state = {
            "frame": frame,
            "models": models_to(dict(models), "cpu") if models else {},
            "ledger_entries": ledger_entries,
        }
        with phase_span("incremental.snapshot_write"):
            mf.write_snapshot(directory, manifest, state)
        counter_inc("incremental.snapshots_written")
        return manifest.get("snapshot_id")
    except Exception as e:
        # snapshot persistence must never fail the run that produced it
        _logger.warning(f"Failed to write snapshot to {directory}: {e}")
        return None


def run_incremental(model: Any, table: EncodedTable, input_name: str,
                    continuous_columns: List[str],
                    run_flags: Tuple[bool, ...]) \
        -> Tuple[pd.DataFrame, float, Dict[str, Any]]:
    """The incremental entry point ``RepairModel.run`` dispatches to.
    Returns ``(frame, elapsed_s, summary)`` where ``_run`` returns
    ``(frame, elapsed_s)``; the summary is kept on the model as
    ``_last_incremental``."""
    started = time.monotonic()
    directory = snapshot_dir_for(model) or ""
    digest = options_digest(model)

    def fallback(reason: str) -> Tuple[pd.DataFrame, float, Dict[str, Any]]:
        _warn_once(directory, reason)
        df, elapsed = model._run(table, input_name, continuous_columns,
                                 *run_flags)
        plain_mode = not any(run_flags)
        snapshot_id = None
        if directory and plain_mode \
                and not getattr(table, "process_local", False):
            led = active_ledger()
            snapshot_id = _save_snapshot(
                model, table, directory, digest, df,
                getattr(model, "_last_models", None),
                led.entries() if led is not None else None)
        summary = {"mode": "full", "fallback_reason": reason,
                   "snapshot_dir": directory or None,
                   "snapshot_id": snapshot_id}
        return df, elapsed, summary

    if not directory:
        return fallback("no_snapshot_dir")
    # the delta path covers the plain repair-candidates mode only: the
    # other run modes (PMF/score/ML/detect-only/full-frame) don't produce
    # the row-spliceable candidates frame the snapshot stores
    if any(run_flags):
        return fallback("unsupported_run_mode")
    if model.repair_by_rules or model.repair_validation_enabled \
            or model.error_cells is not None:
        return fallback("unsupported_options")
    # the port's tables are never process-local shards (queue 1 item 9)
    if getattr(table, "process_local", False):
        return fallback("process_local_table")

    rid_strs = mf.value_strings(table, table.row_id)
    if len(set(rid_strs)) != table.n_rows:
        # the splice keys prior decisions by row id — duplicates would
        # silently cross-wire rows
        return fallback("row_id_not_unique")

    with phase_span("incremental.load"):
        manifest = mf.load_manifest(directory)
        state = mf.load_state(directory) if manifest is not None else None
    if manifest is not None and state is None:
        return fallback("snapshot_state_missing")
    if state is not None and not isinstance(state.get("frame"),
                                            pd.DataFrame):
        return fallback("snapshot_state_invalid")

    try:
        constraints = _parsed_constraints(model, table, input_name)
    except Exception as e:
        _logger.warning(f"Constraint parsing failed during delta "
                        f"planning: {e}")
        return fallback("constraint_parse_failed")

    with phase_span("incremental.plan"):
        plan = plan_delta(table, manifest, constraints,
                          options_digest=digest)
    if not plan.usable:
        return fallback(plan.fallback_reason or "unusable_plan")

    prior_frame: pd.DataFrame = state["frame"]
    prior_models: Dict[str, Any] = state.get("models") or {}
    prior_entries = state.get("ledger_entries") or []
    planned = plan.planned_rows
    planned_rids = {rid_strs[int(p)] for p in planned}
    frozen = models_to({y: m for y, m in prior_models.items()
                        if y in plan.reusable_attrs}, get_device())

    summary = plan.summary()
    summary.update({"mode": "delta", "snapshot_dir": directory,
                    "base_snapshot": manifest.get("snapshot_id")})

    if not len(planned):
        # nothing changed: the prior frame IS the answer
        df = prior_frame.copy().reset_index(drop=True)
        led = active_ledger()
        reused, recomputed = (len(prior_entries), 0)
        if led is not None:
            reused, recomputed = led.splice_prior_entries(prior_entries)
        _count(plan, models_reused=0, models_retrained=0,
               cells_reused=reused, cells_recomputed=recomputed)
        summary.update({"models_reused": 0, "models_retrained": 0,
                        "cells_spliced_reused": reused,
                        "cells_recomputed": recomputed,
                        # snapshot untouched: the prior head stays the
                        # chain head a streaming client must cite
                        "snapshot_id": manifest.get("snapshot_id")})
        return df, time.monotonic() - started, summary

    sub = table.take_rows(planned)
    model._incremental_frozen_models = frozen
    try:
        fresh_df, _ = model._run(sub, input_name, continuous_columns,
                                 *run_flags)
    finally:
        model._incremental_frozen_models = None

    sub_models = dict(getattr(model, "_last_models", None) or [])
    models_reused = sorted(set(frozen) & set(sub_models))
    models_retrained = sorted(set(sub_models) - set(frozen))

    df = _splice_frames(model, table, prior_frame, fresh_df,
                        planned_rids, rid_strs)

    led = active_ledger()
    reusable_entries = [e for e in prior_entries
                        if str(e.get("row_id")) not in planned_rids]
    reused, recomputed = (len(reusable_entries), 0)
    if led is not None:
        reused, recomputed = led.splice_prior_entries(reusable_entries)
    merged_entries = led.entries() if led is not None \
        else reusable_entries

    # next delta's baseline: spliced frame, frozen+retrained models,
    # spliced ledger — over the CURRENT table's manifest
    merged_models = dict(prior_models)
    merged_models.update(sub_models)
    snapshot_id = _save_snapshot(model, table, directory, digest, df,
                                 merged_models, merged_entries)

    _count(plan, models_reused=len(models_reused),
           models_retrained=len(models_retrained),
           cells_reused=reused, cells_recomputed=recomputed)
    summary.update({"snapshot_id": snapshot_id,
                    "models_reused": len(models_reused),
                    "models_retrained": len(models_retrained),
                    "models_reused_attrs": models_reused,
                    "cells_spliced_reused": reused,
                    "cells_recomputed": recomputed})
    elapsed = time.monotonic() - started
    _logger.info(
        f"Incremental repair: {len(planned)}/{table.n_rows} rows "
        f"replanned ({len(plan.updated_rows)} updated, "
        f"{len(plan.appended_rows)} appended, {len(plan.expanded_rows)} "
        f"pulled in by constraints), {len(models_reused)} models reused, "
        f"{len(models_retrained)} retrained, {reused} cells spliced from "
        f"the prior run in {elapsed:.3f}s")
    return df, elapsed, summary


def _count(plan: DeltaPlan, models_reused: int, models_retrained: int,
           cells_reused: int, cells_recomputed: int) -> None:
    counter_inc("incremental.runs")
    counter_inc("incremental.columns_reused", len(plan.clean_columns))
    counter_inc("incremental.columns_dirty", len(plan.dirty_columns))
    counter_inc("incremental.rows_unchanged", int(plan.rows_unchanged))
    counter_inc("incremental.rows_updated", int(len(plan.updated_rows)))
    counter_inc("incremental.rows_appended", int(len(plan.appended_rows)))
    counter_inc("incremental.rows_replanned", int(len(plan.planned_rows)))
    counter_inc("incremental.models_reused", models_reused)
    counter_inc("incremental.models_retrained", models_retrained)
    counter_inc("incremental.cells_spliced_reused", cells_reused)
    counter_inc("incremental.cells_recomputed", cells_recomputed)
