"""Per-cell repair provenance ledger + per-attribute quality scorecards.

The port of the JAX package's ``observability/provenance.py``. It answers
"why did this cell change?" without rerunning anything: when
``DELPHI_PROVENANCE_PATH`` (or the ``repair.provenance.path`` session
config) is set, every flagged cell accumulates one ledger entry across the
pipeline phases —

* the detector(s) that flagged it (``errors.py`` / ``ops/detect.py``,
  including the per-constraint label for denial constraints),
* the candidate domain size the naive-Bayes scoring considered
  (``ops/domain.py``),
* the model's top-k posterior with probabilities (the ``prob_top_k`` PMF
  path and the plain prediction path both hook in),
* the final decision (``repaired`` / ``kept`` / ``below_threshold``) and a
  ``decision_reason`` — including the one-tuple-DC minimization's
  "confidence unavailable -> keep all repairs" fallback, recorded as the
  distinct :data:`REASON_CONFIDENCE_UNAVAILABLE`.

Instrumentation sites read one module-level pointer (:func:`active_ledger`)
and skip entirely when it is ``None`` — a disabled run pays a single
pointer check per hook. ``RepairModel.run()`` opens a :class:`LedgerHolder`
(:func:`maybe_start`) and finalizes it when the run ends, whether it
succeeds or fails: the JSONL file is written through the durable store
(unless the path is ``:memory:``) and the entries aggregate into
per-attribute **quality scorecards** (repair rate, confidence histogram,
low-confidence fraction, domain-size distribution, repaired-value counts).
The run report these embed in is not ported yet (queue 1 item 10 of
``ROADMAP.md``).
"""

import contextlib
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

MEMORY_PATH = ":memory:"

DECISION_REPAIRED = "repaired"
DECISION_KEPT = "kept"
DECISION_BELOW_THRESHOLD = "below_threshold"

REASON_MODEL_REPAIR = "model_repair"
REASON_MAXIMAL_LIKELIHOOD = "maximal_likelihood"
REASON_RULE_REGEX = "rule_regex"
# user-supplied RegexStructureRepair rules record under their own label so
# they stay distinguishable from the escalation plane's INDUCED patterns
REASON_RULE_REGEX_STRUCTURE = "rule_regex_structure"
REASON_RULE_NEAREST_VALUE = "rule_nearest_value"
REASON_PREDICTION_MATCHES_CURRENT = "prediction_matches_current"
REASON_WEAK_LABEL_CLEAN = "weak_label_clean"
REASON_NOT_TARGETED = "attribute_not_targeted"
REASON_NO_PREDICTION = "no_prediction"
REASON_DC_MINIMIZED = "dc_minimized_revert"
REASON_CONFIDENCE_UNAVAILABLE = "confidence_unavailable_keep_all"
REASON_VALIDATION_VIOLATION = "validation_violation"
REASON_BELOW_SCORE_THRESHOLD = "below_score_threshold"
REASON_NO_REPAIR_ATTEMPTED = "no_repair_attempted"
# escalation-tier decisions (delphi_tpu/escalate): one reason per tier so
# an audit can separate induced-pattern, joint-inference, and external-
# adapter repairs from the statistical pipeline's
REASON_ESCALATED_PATTERN = "escalated_pattern"
REASON_ESCALATED_JOINT = "escalated_joint"
REASON_ESCALATED_ADAPTER = "escalated_adapter"

# Reasons a later, more generic decision pass (candidate extraction) must
# not overwrite: they carry WHY the generic outcome happened.
_STICKY_REASONS = frozenset({
    REASON_DC_MINIMIZED, REASON_CONFIDENCE_UNAVAILABLE,
    REASON_RULE_REGEX, REASON_RULE_REGEX_STRUCTURE,
    REASON_RULE_NEAREST_VALUE,
    REASON_ESCALATED_PATTERN, REASON_ESCALATED_JOINT,
    REASON_ESCALATED_ADAPTER,
})

CONFIDENCE_BINS = 20
LOW_CONFIDENCE = 0.5  # top-posterior threshold for "low confidence" repairs
_VALUE_CAP = 50       # distinct repaired values kept per attribute scorecard
OTHER_VALUES = "__other__"


def provenance_path() -> Optional[str]:
    """The configured ledger destination (``:memory:`` keeps it in-process
    only), or ``None`` when provenance is disabled. ``DELPHI_PROVENANCE_PATH``
    wins over the ``repair.provenance.path`` session config — the same
    precedence as every other observability toggle."""
    path = os.environ.get("DELPHI_PROVENANCE_PATH")
    if path:
        return path
    from delphi_tpu_torch.session import get_session

    return get_session().conf.get("repair.provenance.path") or None


def provenance_configured() -> bool:
    return provenance_path() is not None


def _top_k() -> int:
    """Posterior entries kept per cell (``DELPHI_PROVENANCE_TOP_K``)."""
    try:
        return max(1, int(os.environ.get("DELPHI_PROVENANCE_TOP_K", "5")))
    except ValueError:
        return 5


def _is_null(v: Any) -> bool:
    if v is None:
        return True
    try:
        import math

        return isinstance(v, float) and math.isnan(v)
    except Exception:
        return False


def _spell(v: Any) -> Optional[str]:
    return None if _is_null(v) else str(v)


def _tolist(values: Any) -> List[Any]:
    """The values as a Python list, in one conversion where numpy's
    ``tolist`` keeps each value's spelling (objects, strings, booleans,
    integers, float64); other dtypes keep their numpy scalars, since a
    float32's or a datetime's Python value prints differently."""
    if isinstance(values, np.ndarray) and (
            values.dtype.kind in "biuOUS"
            or values.dtype == np.float64):
        return values.tolist()
    return list(values)


def _strings(values: Any) -> List[str]:
    return [str(v) for v in _tolist(values)]


def _ints(values: Any) -> List[int]:
    return [int(v) for v in _tolist(values)]


class ProvenanceLedger:
    """Accumulates one record per flagged cell, keyed by
    ``(str(row_id), attribute)``. Hooks are vectorized — one call per
    detector frame / attribute chunk, not per cell — and thread-safe (the
    batched trainer and the live ``/report`` endpoint may touch it off the
    main thread)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.top_k = _top_k()
        self.model_scores: Dict[str, float] = {}
        self._cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # row position -> row id spelling, filled during detection (phase 1
        # frames carry both); lets position-keyed phases (domain scoring)
        # land on the same entries as id-keyed phases (repair decisions).
        self._rid_of: Dict[int, str] = {}
        self._notes: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._written = False

    def __len__(self) -> int:
        return len(self._cells)

    def record_note(self, kind: str, detail: str) -> None:
        """Run-level annotation (not keyed to a cell): the resilience plane
        stamps one per degradation that changed a decision path — shrink /
        evict / CPU fallback — so an audited re-run can see that this run's
        dispatch diverged from the fault-free plan and why."""
        with self._lock:
            self._notes.append({"note": kind, "detail": detail,
                                "seq": len(self._notes)})

    def notes(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(n) for n in self._notes]

    def _entry(self, rid: str, attr: str) -> Dict[str, Any]:
        key = (rid, attr)
        e = self._cells.get(key)
        if e is None:
            e = self._cells[key] = {"row_id": rid, "attribute": attr,
                                    "detectors": []}
        return e

    # -- phase 1: detection ------------------------------------------------

    def record_detection(self, detector: str, rows: Sequence[int],
                         attrs: Any, row_ids: Sequence[Any]) -> None:
        """One call per detector result frame. ``attrs`` is either an array
        aligned with ``rows`` or a single attribute name."""
        rids = _strings(row_ids)
        attr_l = [attrs] * len(rids) if isinstance(attrs, str) \
            else _strings(attrs)
        with self._lock:
            for r, rid_s, attr in zip(_ints(rows), rids, attr_l):
                self._rid_of[r] = rid_s
                e = self._entry(rid_s, attr)
                if detector not in e["detectors"]:
                    e["detectors"].append(detector)

    def record_current_values(self, row_ids: Sequence[Any], attrs: Sequence[Any],
                              currents: Sequence[Any]) -> None:
        with self._lock:
            for rid, a, c in zip(_strings(row_ids), _strings(attrs),
                                 _tolist(currents)):
                self._entry(rid, a)["current_value"] = _spell(c)

    # -- phase 1b: domain analysis ----------------------------------------

    def record_domain_sizes(self, rows: Sequence[int], attr: str,
                            sizes: Sequence[int]) -> None:
        """Candidate domain size per cell, keyed by row POSITION (domain
        scoring never sees row ids; detection filled the translation)."""
        with self._lock:
            a = str(attr)
            for r, s in zip(_ints(rows), _ints(sizes)):
                rid = self._rid_of.get(r)
                if rid is not None:
                    self._entry(rid, a)["domain_size"] = s

    def record_weak_label_demotions(self, row_ids: Sequence[Any],
                                    attrs: Sequence[Any]) -> None:
        with self._lock:
            for rid, a in zip(_strings(row_ids), _strings(attrs)):
                e = self._entry(rid, a)
                e["decision"] = DECISION_KEPT
                e["decision_reason"] = REASON_WEAK_LABEL_CLEAN

    # -- phase 2: training -------------------------------------------------

    def record_model_score(self, attr: str, score: Any) -> None:
        try:
            s = float(score)
        except (TypeError, ValueError):
            return
        if s == s and s not in (float("inf"), float("-inf")):
            with self._lock:
                self.model_scores[str(attr)] = s

    # -- phase 3: repair ---------------------------------------------------

    def record_posterior(self, attr: str, row_ids: Sequence[Any],
                         classes: Sequence[str], probs: Any,
                         domain_size: Optional[int] = None) -> None:
        """Top-k posterior per cell from one ``predict_proba`` launch:
        ``probs`` is an (n, k) matrix aligned with ``row_ids``; ``classes``
        the shared class list. ``domain_size`` (the model's class count)
        fills in where domain scoring didn't run for the cell or kept no
        candidates (the model then considered its full class list)."""
        P = np.asarray(probs, dtype=np.float64)
        if P.ndim != 2 or len(P) != len(row_ids):
            return
        kk = min(self.top_k, P.shape[1])
        order = np.argsort(-P, axis=1, kind="stable")[:, :kk]
        top = np.take_along_axis(P, order, axis=1).tolist()
        names = [str(c) for c in classes]
        a = str(attr)
        with self._lock:
            for rid, js, ps in zip(_strings(row_ids), order.tolist(), top):
                e = self._entry(rid, a)
                e["top_k"] = [{"value": names[j], "prob": round(p, 6)}
                              for j, p in zip(js, ps)]
                e["confidence"] = ps[0] if kk else None
                if domain_size is not None and not e.get("domain_size"):
                    e["domain_size"] = int(domain_size)

    def record_point_predictions(self, attr: str, row_ids: Sequence[Any],
                                 values: Sequence[Any],
                                 domain_size: Optional[int] = None) -> None:
        """Degenerate posterior for models without ``predict_proba``
        (regressors, FD rules, constant fallbacks): top-1, no probability."""
        a = str(attr)
        with self._lock:
            for rid, v in zip(row_ids, values):
                e = self._entry(str(rid), a)
                e["top_k"] = [{"value": _spell(v), "prob": None}]
                if domain_size is not None and not e.get("domain_size"):
                    e["domain_size"] = int(domain_size)

    def record_pmf_topk(self, attr: str, row_ids: Sequence[Any],
                        pmf_lists: Iterable[List[Dict[str, Any]]]) -> None:
        """Cost-weighted top-k from the ``prob_top_k`` PMF path — overwrites
        the raw posterior with what the candidate selection actually used."""
        a = str(attr)
        with self._lock:
            for rid, pmf in zip(row_ids, pmf_lists):
                if not pmf:
                    continue
                e = self._entry(str(rid), a)
                e["top_k"] = [{"value": _spell(p.get("class")),
                               "prob": round(float(p.get("prob", 0.0)), 6)}
                              for p in pmf[:self.top_k]]
                e["confidence"] = float(pmf[0].get("prob", 0.0))

    def record_decisions(self, row_ids: Sequence[Any], attrs: Any,
                         decision: str, reason: str,
                         repaired: Optional[Sequence[Any]] = None,
                         sticky_aware: bool = False) -> None:
        """Final (or provisional) decision for many cells. With
        ``sticky_aware`` the decision/repaired value still update, but a
        reason in :data:`_STICKY_REASONS` recorded by an earlier, more
        specific pass is preserved."""
        rids = _strings(row_ids)
        attr_l = [attrs] * len(rids) if isinstance(attrs, str) \
            else _strings(attrs)
        reps = [None] * len(rids) if repaired is None else _tolist(repaired)
        with self._lock:
            for rid, attr, rep in zip(rids, attr_l, reps):
                e = self._entry(rid, attr)
                e["decision"] = decision
                if not (sticky_aware
                        and e.get("decision_reason") in _STICKY_REASONS):
                    e["decision_reason"] = reason
                if repaired is not None:
                    e["repaired"] = _spell(rep)

    def record_decision(self, row_id: Any, attr: str, decision: str,
                        reason: str, repaired: Any = None) -> None:
        with self._lock:
            e = self._entry(str(row_id), str(attr))
            e["decision"] = decision
            e["decision_reason"] = reason
            if repaired is not None:
                e["repaired"] = _spell(repaired)

    # -- phase 3b: escalation ----------------------------------------------

    def record_escalation_routed(self, row_id: Any, attr: str,
                                 route_reason: str) -> None:
        """Marks a cell the escalation router selected (whether or not any
        tier ends up repairing it) — the scorecards' routed counts come
        from these marks."""
        with self._lock:
            e = self._entry(str(row_id), str(attr))
            e["escalation_routed"] = route_reason

    def record_escalation(self, row_id: Any, attr: str, tier: str,
                          reason: str, repaired: Any,
                          confidence: Any = None) -> None:
        """Final decision from an escalation tier: repaired, with the tier
        stamped on the entry. The reason is sticky — the extraction pass's
        generic ``model_repair`` must not overwrite it."""
        with self._lock:
            e = self._entry(str(row_id), str(attr))
            e["decision"] = DECISION_REPAIRED
            e["decision_reason"] = reason
            e["repaired"] = _spell(repaired)
            e["escalation_tier"] = str(tier)
            if confidence is not None:
                try:
                    e["escalation_confidence"] = round(float(confidence), 6)
                except (TypeError, ValueError):
                    pass

    def clear_decision(self, row_id: Any, attr: str) -> None:
        """Undo a provisional decision (the DC fixpoint pass restoring a
        reverted repair) so the extraction pass re-derives it."""
        with self._lock:
            e = self._cells.get((str(row_id), str(attr)))
            if e is not None:
                e.pop("decision", None)
                e.pop("decision_reason", None)

    # -- incremental splice ------------------------------------------------

    def splice_prior_entries(self, prior_entries: Sequence[Dict[str, Any]],
                             recomputed_reason: str = "row_replanned",
                             reused_reason: str = "outside_delta") \
            -> Tuple[int, int]:
        """Splices a prior run's ledger entries under this (delta) run's.

        Every cell THIS run touched keeps its fresh entry, stamped
        ``splice: recomputed``; a prior entry whose cell this run did not
        touch is inserted verbatim, stamped ``splice: reused``. The caller
        pre-filters ``prior_entries`` to rows outside the delta plan — a
        replanned row's prior cells must NOT come back, since the re-run is
        their truth now (including "clean now, so no entry at all").
        Returns ``(reused, recomputed)`` counts."""
        with self._lock:
            for e in self._cells.values():
                e["splice"] = "recomputed"
                e["splice_reason"] = recomputed_reason
            reused = 0
            for p in prior_entries or []:
                key = (str(p.get("row_id")), str(p.get("attribute")))
                if key in self._cells:
                    continue
                e = dict(p)
                e["splice"] = "reused"
                e["splice_reason"] = reused_reason
                self._cells[key] = e
                reused += 1
            recomputed = len(self._cells) - reused
        return reused, recomputed

    # -- finalize ----------------------------------------------------------

    def entries(self) -> List[Dict[str, Any]]:
        """Ledger rows in insertion order, defaults filled: every entry has
        a decision/decision_reason (cells no phase decided on — e.g. a
        detect-only run — report ``kept``/``no_repair_attempted``)."""
        with self._lock:
            rows = [dict(e) for e in self._cells.values()]
        for e in rows:
            e.setdefault("decision", DECISION_KEPT)
            e.setdefault("decision_reason", REASON_NO_REPAIR_ATTEMPTED)
        return rows

    def write(self) -> None:
        """One-shot crash-consistent JSONL dump through the durable-store
        seam (site ``store.provenance``): an envelope header line (``#``
        prefixed, so line-oriented consumers skip it) followed by one JSON
        line per cell, then the run-level notes (resilience degradations)
        in the same stream, distinguished by the "note" key. ``:memory:``
        skips the file entirely."""
        if self.path == MEMORY_PATH or self._written:
            return
        self._written = True
        from delphi_tpu_torch.parallel import store as dstore
        try:
            rows = self.entries() + self.notes()
            dstore.write_jsonl(os.path.abspath(self.path), rows,
                               schema="provenance", site="store.provenance")
            _logger.info(f"Provenance ledger written to {self.path} "
                         f"({len(self._cells)} cells)")
        except Exception as e:
            _logger.warning(f"failed to write provenance ledger: {e}")

    def scorecards(self) -> Dict[str, Dict[str, Any]]:
        return build_scorecards(self.entries(), self.model_scores)


# -- scorecards ------------------------------------------------------------


def _empty_card() -> Dict[str, Any]:
    return {
        "cells_flagged": 0,
        "cells_repaired": 0,
        "detectors": {},
        "decisions": {},
        "confidence": {"count": 0, "sum": 0.0, "min": None, "max": None,
                       "bins": [0] * CONFIDENCE_BINS},
        "domain_size": {"count": 0, "sum": 0, "min": None, "max": None,
                        "hist": {}},
        "repaired_values": {},
        "escalation": {"routed": 0, "routed_reasons": {}, "repairs": {}},
    }


def _size_bucket(size: int) -> str:
    """Power-of-two domain-size buckets: "0", "1", "2-3", "4-7", ..."""
    if size <= 0:
        return "0"
    lo = 1 << (int(size).bit_length() - 1)
    hi = lo * 2 - 1
    return str(lo) if hi == lo else f"{lo}-{hi}"


def _observe(stats: Dict[str, Any], value: float) -> None:
    stats["count"] += 1
    stats["sum"] += value
    stats["min"] = value if stats["min"] is None else min(stats["min"], value)
    stats["max"] = value if stats["max"] is None else max(stats["max"], value)


def build_scorecards(entries: Iterable[Dict[str, Any]],
                     model_scores: Optional[Dict[str, float]] = None) \
        -> Dict[str, Dict[str, Any]]:
    """Aggregates ledger entries into per-attribute quality scorecards.
    Every non-derived field merges exactly across hosts (sums, mins/maxes,
    histogram-bin sums) — see :func:`merge_scorecards`."""
    cards: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        card = cards.setdefault(e["attribute"], _empty_card())
        card["cells_flagged"] += 1
        for d in e.get("detectors") or ["unknown"]:
            card["detectors"][d] = card["detectors"].get(d, 0) + 1
        reason = e.get("decision_reason") or REASON_NO_REPAIR_ATTEMPTED
        card["decisions"][reason] = card["decisions"].get(reason, 0) + 1
        if e.get("decision") == DECISION_REPAIRED:
            card["cells_repaired"] += 1
            v = _spell(e.get("repaired"))
            if v is not None:
                rv = card["repaired_values"]
                rv[v] = rv.get(v, 0) + 1
        conf = e.get("confidence")
        if conf is not None and conf == conf:
            c = min(max(float(conf), 0.0), 1.0)
            _observe(card["confidence"], c)
            bins = card["confidence"]["bins"]
            bins[min(int(c * CONFIDENCE_BINS), CONFIDENCE_BINS - 1)] += 1
        ds = e.get("domain_size")
        if ds is not None:
            _observe(card["domain_size"], int(ds))
            hist = card["domain_size"]["hist"]
            b = _size_bucket(int(ds))
            hist[b] = hist.get(b, 0) + 1
        route = e.get("escalation_routed")
        if route:
            esc = card["escalation"]
            esc["routed"] += 1
            esc["routed_reasons"][route] = \
                esc["routed_reasons"].get(route, 0) + 1
        tier = e.get("escalation_tier")
        if tier:
            reps = card["escalation"]["repairs"]
            reps[tier] = reps.get(tier, 0) + 1
    for attr, card in cards.items():
        if model_scores and attr in model_scores:
            card["model_cv_score"] = round(model_scores[attr], 6)
        _cap_values(card)
        _derive(card)
    return cards


def _cap_values(card: Dict[str, Any]) -> None:
    rv = card["repaired_values"]
    if len(rv) <= _VALUE_CAP:
        return
    top = sorted(rv.items(), key=lambda kv: (-kv[1], kv[0]))
    kept = dict(top[:_VALUE_CAP])
    kept[OTHER_VALUES] = kept.get(OTHER_VALUES, 0) \
        + sum(n for _, n in top[_VALUE_CAP:])
    card["repaired_values"] = kept


def _derive(card: Dict[str, Any]) -> None:
    """(Re)computes the derived fields from the mergeable raw ones."""
    flagged = card["cells_flagged"]
    card["repair_rate"] = round(card["cells_repaired"] / flagged, 6) \
        if flagged else 0.0
    conf = card["confidence"]
    n = conf["count"]
    conf["mean"] = round(conf["sum"] / n, 6) if n else None
    low_bins = int(LOW_CONFIDENCE * CONFIDENCE_BINS)
    conf["low_confidence_fraction"] = \
        round(sum(conf["bins"][:low_bins]) / n, 6) if n else None
    ds = card["domain_size"]
    ds["mean"] = round(ds["sum"] / ds["count"], 6) if ds["count"] else None


def merge_scorecards(cards_list: Sequence[Optional[Dict[str, Any]]]) \
        -> Dict[str, Dict[str, Any]]:
    """Cluster-wide scorecard merge: counters sum, mins/maxes combine,
    histogram bins add, derived fields recompute from the merged raws."""
    merged: Dict[str, Dict[str, Any]] = {}
    for cards in cards_list:
        for attr, card in (cards or {}).items():
            m = merged.setdefault(attr, _empty_card())
            m["cells_flagged"] += card.get("cells_flagged", 0)
            m["cells_repaired"] += card.get("cells_repaired", 0)
            for field in ("detectors", "decisions", "repaired_values"):
                for k, v in card.get(field, {}).items():
                    m[field][k] = m[field].get(k, 0) + v
            for field in ("confidence", "domain_size"):
                src, dst = card.get(field, {}), m[field]
                dst["count"] += src.get("count", 0)
                dst["sum"] += src.get("sum", 0)
                for agg, op in (("min", min), ("max", max)):
                    v = src.get(agg)
                    if v is not None:
                        dst[agg] = v if dst[agg] is None else op(dst[agg], v)
            for i, v in enumerate(card.get("confidence", {}).get("bins", [])):
                if i < CONFIDENCE_BINS:
                    m["confidence"]["bins"][i] += v
            for b, v in card.get("domain_size", {}).get("hist", {}).items():
                m["domain_size"]["hist"][b] = \
                    m["domain_size"]["hist"].get(b, 0) + v
            esc_src = card.get("escalation", {})
            esc_dst = m["escalation"]
            esc_dst["routed"] += esc_src.get("routed", 0)
            for field in ("routed_reasons", "repairs"):
                for k, v in esc_src.get(field, {}).items():
                    esc_dst[field][k] = esc_dst[field].get(k, 0) + v
            if "model_cv_score" in card and "model_cv_score" not in m:
                m["model_cv_score"] = card["model_cv_score"]
    for card in merged.values():
        _cap_values(card)
        _derive(card)
    return merged


def scorecard_summary(scorecards: Optional[Dict[str, Dict[str, Any]]]) \
        -> Optional[Dict[str, Dict[str, Any]]]:
    """Compact per-attribute view for bench entries and CLI output."""
    if not scorecards:
        return None
    return {attr: {
        "cells_flagged": card.get("cells_flagged", 0),
        "repair_rate": card.get("repair_rate", 0.0),
        "low_confidence_fraction":
            card.get("confidence", {}).get("low_confidence_fraction"),
        "mean_confidence": card.get("confidence", {}).get("mean"),
    } for attr, card in sorted(scorecards.items())}


# -- run lifecycle ---------------------------------------------------------

class LedgerHolder:
    """What a run keeps of its ledger: the ledger itself and, once
    finalized, its scorecards (the JAX package keeps both on its run
    recorder, which the port does not have yet)."""

    def __init__(self, ledger: ProvenanceLedger) -> None:
        self.provenance: Optional[ProvenanceLedger] = ledger
        self.scorecards: Optional[Dict[str, Dict[str, Any]]] = None


# The process-wide active ledger. Written only by maybe_start/finalize;
# instrumentation reads it with a single attribute load.
_ledger: Optional[ProvenanceLedger] = None

# Per-thread ledgers: a run that needs a ledger of its own (escalation
# without a configured path) routes its writes into a scoped one, so
# concurrent runs' cells never interleave. _scoped_count gates the
# thread-local lookup so the disabled path stays a global read + one int
# compare.
_scoped_tls = threading.local()
_scoped_count = 0
_scoped_lock = threading.Lock()


def active_ledger() -> Optional[ProvenanceLedger]:
    if _scoped_count:
        led = getattr(_scoped_tls, "ledger", None)
        if led is not None:
            return led
    return _ledger


@contextlib.contextmanager
def scoped_ledger(ledger: Optional[ProvenanceLedger]):
    """Routes this thread's provenance writes into ``ledger`` (a no-op
    context when None); the process-global ledger, if any, is shadowed for
    the duration."""
    global _scoped_count
    if ledger is None:
        yield None
        return
    prev = getattr(_scoped_tls, "ledger", None)
    _scoped_tls.ledger = ledger
    with _scoped_lock:
        _scoped_count += 1
    try:
        yield ledger
    finally:
        _scoped_tls.ledger = prev
        with _scoped_lock:
            _scoped_count -= 1


def maybe_start() -> Optional[LedgerHolder]:
    """Opens a fresh ledger when provenance is configured and returns its
    holder. A nested run keeps the outer run's ledger and gets ``None``, so
    only the outer run finalizes."""
    global _ledger
    if _ledger is not None:
        return None
    path = provenance_path()
    if not path:
        return None
    _ledger = ProvenanceLedger(path)
    _logger.info(f"Provenance ledger active (path={path})")
    return LedgerHolder(_ledger)


def finalize(holder: Optional[LedgerHolder]) -> None:
    """Freezes the scorecards onto the holder, writes the ledger file and
    closes the ledger. Idempotent."""
    global _ledger
    led = getattr(holder, "provenance", None)
    if led is None:
        return
    if holder.scorecards is None:
        holder.scorecards = led.scorecards()
    led.write()
    if _ledger is led:
        _ledger = None
