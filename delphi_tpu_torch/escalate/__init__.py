"""Escalation tier: confidence-routed second-pass repair.

The port of the JAX package's ``escalate`` package. The provenance ledger
names exactly which cells the statistical models are unsure about; this
subsystem routes ONLY those cells — under a strict per-run budget — through
three tiers, walked in order:

* **Tier A, learned patterns** (:mod:`~delphi_tpu_torch.escalate.patterns`)
  — per-attribute token-structure patterns induced from clean cells,
  applied through the restricted-grammar salvage; fixes syntactic breaks.
* **Tier B, joint inference** (:mod:`~delphi_tpu_torch.escalate.joint` over
  K8, :mod:`delphi_tpu_torch.ops.joint`) — message passing on a factor
  graph from the co-occurrence statistics, one device call per
  domain-size band; fixes semantically wrong values via correlated context.
* **Tier C, external adapter** (:mod:`~delphi_tpu_torch.escalate.adapter`)
  — an external repairer behind an explicit allow flag
  (``DELPHI_ESCALATE_ADAPTER``) and a call budget; HARD OFF by default.

Every escalated decision lands in the provenance ledger with its tier and
reason, and the ``escalation.*`` counters land in ``utils.counters``.
Enable with ``DELPHI_ESCALATE`` / the ``repair.escalate`` option or session
conf.
"""

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from delphi_tpu_torch.escalate.adapter import (  # noqa: F401
    MockAdapter, RepairAdapter, adapter_allowed, adapter_call_limit,
    resolve_adapter,
)
from delphi_tpu_torch.escalate.patterns import induce_for_attributes
from delphi_tpu_torch.escalate.router import (Budget, RoutedCell,
                                              select_candidates)
from delphi_tpu_torch.observability import provenance as _prov
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.utils import counter_inc, phase_span, setup_logger

_logger = setup_logger()

_TRUTHY = frozenset({"1", "true", "yes", "on"})

TIER_PATTERN = "pattern"
TIER_JOINT = "joint"
TIER_ADAPTER = "adapter"

#: cap on the cell lists embedded in the summary
_SUMMARY_CELL_CAP = 1024

DEFAULT_BUDGET = 256
DEFAULT_ITERS = 8


# -- configuration (option wins -> env -> session conf) ----------------------

def escalation_requested(model: Any) -> bool:
    if model._opt_escalate.key in model.opts:
        # parse the raw spelling rather than legacy string truthiness:
        # an explicit "repair.escalate=false" must mean OFF
        raw = str(model.opts[model._opt_escalate.key])
        return raw.strip().lower() in _TRUTHY
    env = os.environ.get("DELPHI_ESCALATE")
    if env is not None:
        return env.strip().lower() in _TRUTHY
    conf = get_session().conf.get("repair.escalate")
    if conf is not None:
        return str(conf).strip().lower() in _TRUTHY
    return False


def _conf_knob(model: Any, opt: Any, env_name: str, conf_key: str,
               cast: Any, default: Any) -> Any:
    if opt.key in model.opts:
        return cast(model._get_option_value(*opt))
    env = os.environ.get(env_name)
    if env is not None:
        try:
            return cast(env)
        except ValueError:
            return default
    conf = get_session().conf.get(conf_key)
    if conf is not None:
        try:
            return cast(conf)
        except ValueError:
            return default
    return default


def conf_threshold(model: Any) -> float:
    return float(_conf_knob(model, model._opt_escalate_conf,
                            "DELPHI_ESCALATE_CONF", "repair.escalate.conf",
                            float, _prov.LOW_CONFIDENCE))


def cell_budget(model: Any) -> int:
    return max(0, int(_conf_knob(
        model, model._opt_escalate_budget, "DELPHI_ESCALATE_BUDGET",
        "repair.escalate.budget", int, DEFAULT_BUDGET)))


def joint_iters(model: Any) -> int:
    return max(1, int(_conf_knob(
        model, model._opt_escalate_iters, "DELPHI_ESCALATE_ITERS",
        "repair.escalate.iters", int, DEFAULT_ITERS)))


# -- orchestration ---------------------------------------------------------

def _clean_values(masked: Any, attrs: List[str]) \
        -> Tuple[Dict[str, List[str]], Dict[str, List[Tuple[str, int]]]]:
    """Per-attribute clean spellings (for pattern induction) and
    ``(value, count)`` candidates sorted most-frequent-first (for the
    adapter tier) from the masked table's surviving cells."""
    values: Dict[str, List[str]] = {}
    candidates: Dict[str, List[Tuple[str, int]]] = {}
    for attr in attrs:
        col = masked.column(attr)
        codes = col.codes[col.codes >= 0]
        values[attr] = [str(v) for v in col.vocab[codes[:4096]]]
        counts = np.bincount(codes, minlength=col.domain_size)
        cand = [(str(col.vocab[i]), int(counts[i]))
                for i in np.nonzero(counts)[0]]
        cand.sort(key=lambda vc: (-vc[1], vc[0]))
        candidates[attr] = cand[:32]
    return values, candidates


def maybe_escalate(model: Any, masked: Any, error_cells_df: Any,
                   error_row_pos: np.ndarray, repaired_rows_df: Any,
                   target_columns: List[str],
                   continuous_columns: List[str]) -> Dict[str, Any]:
    """Runs the escalation pass in place over ``repaired_rows_df`` (the
    single-shot repaired block, rows aligned with ``error_row_pos``) and
    returns its summary. The caller guarantees an active provenance ledger
    — routing IS a ledger read. A failing tier raises, except an external
    adapter, whose failing batch is logged and skipped."""
    from delphi_tpu_torch.errors import ROW_IDX

    led = _prov.active_ledger()
    summary: Dict[str, Any] = {
        "requested": True,
        "conf_threshold": conf_threshold(model),
        "routed": 0,
        "escalated": 0,
        "budget": {"limit": cell_budget(model), "spent": 0,
                   "exhausted": False},
        "tiers": {
            TIER_PATTERN: {"attempts": 0, "repairs": 0},
            TIER_JOINT: {"attempts": 0, "repairs": 0},
            TIER_ADAPTER: {"allowed": adapter_allowed(model),
                           "calls": 0, "attempts": 0, "repairs": 0},
        },
        "routed_cells": [],
        "escalated_cells": [],
    }
    if led is None:
        summary["skipped"] = "no_ledger"
        return summary

    discrete_targets = [a for a in target_columns
                        if a not in set(continuous_columns)]
    rid_np = error_cells_df[model._row_id].to_numpy(dtype=object)
    attrs_np = error_cells_df["attribute"].to_numpy(dtype=object)
    rows_np = error_cells_df[ROW_IDX].to_numpy().astype(np.int64)
    curs_np = error_cells_df["current_value"].to_numpy(dtype=object)
    cell_index = {(str(r), str(a)): (int(p), c)
                  for r, a, p, c in zip(rid_np, attrs_np, rows_np, curs_np)}

    with phase_span("escalation.route"):
        cands = select_candidates(led.entries(), cell_index,
                                  summary["conf_threshold"], discrete_targets)
        summary["routed"] = len(cands)
        summary["routed_cells"] = [[c.row_id, c.attribute]
                                   for c in cands[:_SUMMARY_CELL_CAP]]
        counter_inc("escalation.routed", len(cands))
        for c in cands:
            led.record_escalation_routed(c.row_id, c.attribute,
                                         c.route_reason)
    if not cands:
        return summary

    budget = Budget(summary["budget"]["limit"])
    col_pos = {a: i for i, a in enumerate(repaired_rows_df.columns)}
    resolved: Dict[Tuple[str, str], str] = {}

    def _apply(cell: RoutedCell, tier: str, reason: str, value: str,
               confidence: Optional[float] = None) -> None:
        local = int(np.searchsorted(error_row_pos, cell.row_pos))
        repaired_rows_df.iat[local, col_pos[cell.attribute]] = value
        led.record_escalation(cell.row_id, cell.attribute, tier, reason,
                              value, confidence)
        resolved[cell.key] = value
        summary["tiers"][tier]["repairs"] += 1
        summary["escalated"] += 1
        if len(summary["escalated_cells"]) < _SUMMARY_CELL_CAP:
            summary["escalated_cells"].append(
                [cell.row_id, cell.attribute, tier, value])
        counter_inc(f"escalation.{tier}.repairs")

    # -- tier A: learned pattern repair (syntactic breaks) -----------------
    with phase_span("escalation.pattern"):
        routed_attrs = sorted({c.attribute for c in cands})
        clean_vals, clean_cands = _clean_values(masked, routed_attrs)
        repairers = induce_for_attributes(clean_vals)
        counter_inc("escalation.pattern.induced", len(repairers))
        for cell in cands:
            rep = repairers.get(cell.attribute)
            if rep is None or cell.current_value is None:
                continue
            if not budget.take():
                break
            summary["tiers"][TIER_PATTERN]["attempts"] += 1
            counter_inc("escalation.pattern.attempts")
            fixed = rep.repair(cell.current_value)
            if fixed is not None:
                _apply(cell, TIER_PATTERN, _prov.REASON_ESCALATED_PATTERN,
                       fixed)

    # -- tier B: joint inference (semantic errors via correlated context) --
    if not budget.exhausted:
        from delphi_tpu_torch.escalate.joint import run_joint_tier
        with phase_span("escalation.joint"):
            joint_cells: List[RoutedCell] = []
            for cell in cands:
                if cell.key in resolved:
                    continue
                if not budget.take():
                    break
                joint_cells.append(cell)
            summary["tiers"][TIER_JOINT]["attempts"] = len(joint_cells)
            for p in run_joint_tier(masked, joint_cells,
                                    summary["conf_threshold"],
                                    joint_iters(model)):
                _apply(p.cell, TIER_JOINT, _prov.REASON_ESCALATED_JOINT,
                       p.value, p.belief)

    # -- tier C: external adapter (explicitly enabled only) ----------------
    ext = resolve_adapter(model) if not budget.exhausted \
        and summary["tiers"][TIER_ADAPTER]["allowed"] else None
    if ext is not None:
        with phase_span("escalation.adapter"):
            call_limit = adapter_call_limit()
            decoded: Dict[int, Dict[str, Any]] = {}
            batch: List[Tuple[RoutedCell, Dict[str, Any]]] = []
            for cell in cands:
                if cell.key in resolved:
                    continue
                if not budget.take():
                    break
                batch.append((cell, {
                    "row_id": cell.row_id,
                    "attribute": cell.attribute,
                    "current_value": cell.current_value,
                    "row": decoded.setdefault(cell.row_pos, {
                        c.name: (str(c.vocab[c.codes[cell.row_pos]])
                                 if c.codes[cell.row_pos] >= 0 else None)
                        for c in masked.columns}),
                    "candidates": clean_cands.get(cell.attribute, []),
                }))
            # one repair() call per attribute batch, call-budget capped
            by_attr: Dict[str, List[Tuple[RoutedCell, Dict[str, Any]]]] = {}
            for cell, req in batch:
                by_attr.setdefault(cell.attribute, []).append((cell, req))
            for attr in sorted(by_attr):
                if summary["tiers"][TIER_ADAPTER]["calls"] >= call_limit:
                    counter_inc("escalation.adapter.call_budget_exhausted")
                    break
                group = by_attr[attr]
                summary["tiers"][TIER_ADAPTER]["calls"] += 1
                summary["tiers"][TIER_ADAPTER]["attempts"] += len(group)
                counter_inc("escalation.adapter.calls")
                try:
                    proposals = ext.repair([req for _, req in group])
                except Exception as e:
                    _logger.warning(
                        f"escalation adapter failed on '{attr}': {e}")
                    continue
                for (cell, _), value in zip(group, proposals or []):
                    if value is not None and str(value) != cell.current_value:
                        _apply(cell, TIER_ADAPTER,
                               _prov.REASON_ESCALATED_ADAPTER, str(value))

    if budget.exhausted:
        counter_inc("escalation.budget_exhausted")
    summary["budget"]["spent"] = budget.spent
    summary["budget"]["exhausted"] = budget.exhausted
    counter_inc("escalation.escalated", summary["escalated"])
    return summary
