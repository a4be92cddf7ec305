"""Confidence router: selects escalation candidates from the live ledger.

The provenance plane already names exactly which cells the statistical
models are unsure about; the router turns that signal into a deterministic,
budget-capped work list:

* cells whose recorded top-posterior ``confidence`` is below the threshold
  (``DELPHI_ESCALATE_CONF``, default the scorecards' low-confidence line),
* cells the one-tuple DC minimizer kept under its distinct
  ``confidence_unavailable_keep_all`` fallback (it could not score the
  row's options, so nothing vouches for them), and
* cells with no usable confidence at all (point predictions / rule paths
  never record one) that some phase decided on.

Candidates sort most-uncertain-first (missing confidence before low
confidence, then by ``(confidence, attribute, row_id)``) so a budget always
spends itself on the cells the pipeline knows least about, and two runs of
the same table route identically.
"""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

from delphi_tpu_torch.observability import provenance as _prov


@dataclass
class RoutedCell:
    """One escalation candidate, carrying everything the tiers need."""

    row_id: str
    attribute: str
    row_pos: int                 # global row position in the input table
    current_value: Optional[str]
    confidence: Optional[float]
    route_reason: str            # why the router selected it

    @property
    def key(self) -> Tuple[str, str]:
        return (self.row_id, self.attribute)


ROUTE_LOW_CONFIDENCE = "low_confidence"
ROUTE_CONFIDENCE_UNAVAILABLE = "confidence_unavailable"
ROUTE_DC_KEEP_ALL = "dc_keep_all"


class Budget:
    """Strict per-run escalation budget, charged once per cell x tier
    attempt. ``take()`` answers "may I attempt one more cell?" and flips
    ``exhausted`` the first time the answer is no — the orchestrator then
    stops routing mid-tier, keeping every decision already made."""

    def __init__(self, limit: int) -> None:
        self.limit = max(0, int(limit))
        self.spent = 0
        self.exhausted = False

    def take(self, n: int = 1) -> bool:
        if self.spent + n > self.limit:
            self.exhausted = True
            return False
        self.spent += n
        return True

    def remaining(self) -> int:
        return max(0, self.limit - self.spent)


def _sort_key(cell: RoutedCell) -> Tuple[int, float, str, str]:
    # missing confidence first (the pipeline knows NOTHING about these),
    # then ascending confidence; attribute/row_id break ties so the order
    # is total and reproducible
    missing = 0 if cell.confidence is None else 1
    conf = -1.0 if cell.confidence is None else float(cell.confidence)
    return (missing, conf, cell.attribute, cell.row_id)


def select_candidates(entries: Iterable[Dict[str, Any]],
                      cell_index: Dict[Tuple[str, str], Tuple[int, Any]],
                      conf_threshold: float,
                      target_attrs: Iterable[str]) -> List[RoutedCell]:
    """Routes ledger ``entries`` against the run's error cells.

    ``cell_index`` maps ``(row_id, attribute)`` to ``(row_pos,
    current_value)`` for every error cell the repair phase actually saw —
    ledger entries outside it (non-targeted attributes, weak-label-demoted
    cells) never route. Returns the full sorted candidate list; the
    orchestrator applies the budget while walking tiers."""
    targets = set(target_attrs)
    out: List[RoutedCell] = []
    for e in entries:
        attr = str(e.get("attribute"))
        if attr not in targets:
            continue
        rid = str(e.get("row_id"))
        at = cell_index.get((rid, attr))
        if at is None:
            continue
        reason = e.get("decision_reason")
        if reason == _prov.REASON_WEAK_LABEL_CLEAN:
            continue  # domain analysis demoted the cell to clean
        conf = e.get("confidence")
        if conf is not None:
            try:
                conf = float(conf)
            except (TypeError, ValueError):
                conf = None
        if reason == _prov.REASON_CONFIDENCE_UNAVAILABLE:
            route = ROUTE_DC_KEEP_ALL
        elif conf is None:
            route = ROUTE_CONFIDENCE_UNAVAILABLE
        elif conf < conf_threshold:
            route = ROUTE_LOW_CONFIDENCE
        else:
            continue
        row_pos, current = at
        out.append(RoutedCell(
            row_id=rid, attribute=attr, row_pos=int(row_pos),
            current_value=None if current is None else str(current),
            confidence=conf, route_reason=route))
    out.sort(key=_sort_key)
    return out
