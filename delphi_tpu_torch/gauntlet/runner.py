"""Drives gauntlet scenarios through the port's repair pipeline and
assembles the versioned ``gauntlet`` report section (the JAX package's
``delphi_tpu/gauntlet/runner.py``, rewired onto the port's ``delphi``,
detectors, observability and session).

Each scenario runs under its own run recorder with an in-memory
provenance ledger, so the per-attribute scorecards and escalation
summary land in the per-scenario result exactly as they do for a
production run — the gauntlet measures the pipeline the users get, not
a test double. That in-memory ledger makes each scenario a ledger run, so
on the card its domain analysis launches K5's integer mode (beside K1 and
K2 in the attr stats). The per-scenario result carries:

* cell-level precision/recall/F1 against the injected ground truth,
* the full per-attribute scorecards (drift-gate input) + their summary,
* the escalation summary when the escalation tier ran,
* the BoostClean downstream triple (dirty/repaired/clean + gap closed),
* the ``train.*`` counters (``train.regressors`` pins the regression
  branch for the numeric scenario).

``repairs_enabled=False`` is the deliberate degradation used by the gate
self-test: detection and scoring still run, but no repairs are applied —
every scenario's F1 collapses, which the per-scenario drift gate
(:func:`delphi_tpu_torch.observability.drift.evaluate_gauntlet`) must catch.

Env knobs (mirrored by the CLI's ``--gauntlet-*`` flags):
``DELPHI_GAUNTLET_ROWS``, ``DELPHI_GAUNTLET_SEED``,
``DELPHI_GAUNTLET_SCENARIOS`` (comma-separated registry names).
"""

import os
import time
from typing import Any, Dict, List, Optional

from delphi_tpu_torch.gauntlet.scenarios import (SCENARIOS, ScenarioData,
                                                 generate_scenario,
                                                 scenario_names)
from delphi_tpu_torch.gauntlet.score import (apply_repairs, downstream_score,
                                             score_cells)
from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

#: version of the run report's ``gauntlet`` section (bump on shape change)
GAUNTLET_REPORT_VERSION = 1

DEFAULT_ROWS = 2_000


def _detectors(data: ScenarioData) -> List[Any]:
    from delphi_tpu_torch.errors import (ConstraintErrorDetector,
                                         GaussianOutlierErrorDetector,
                                         NullErrorDetector,
                                         RegExErrorDetector)
    dets: List[Any] = [NullErrorDetector()]
    for attr, pattern in data.regexes:
        dets.append(RegExErrorDetector(attr, pattern))
    if data.constraints:
        dets.append(ConstraintErrorDetector(constraints=data.constraints))
    if data.outlier_detection:
        dets.append(GaussianOutlierErrorDetector())
    return dets


def run_scenario(data: ScenarioData, seed: int = 0,
                 repairs_enabled: bool = True) -> Dict[str, Any]:
    """Runs one materialized scenario end-to-end and scores it."""
    from delphi_tpu_torch import delphi
    from delphi_tpu_torch import observability as obs
    from delphi_tpu_torch.session import get_session

    saved_prov = os.environ.get("DELPHI_PROVENANCE_PATH")
    os.environ.setdefault("DELPHI_PROVENANCE_PATH", ":memory:")
    name = f"gauntlet_{data.name}"
    repair_frame = None
    scorecards = None
    escalation = None
    counters: Dict[str, int] = {}
    error: Optional[str] = None
    t0 = time.time()
    try:
        if repairs_enabled:
            get_session().register(name, data.dirty.copy())
            rec = obs.start_recording(f"gauntlet.{data.name}")
            try:
                repair_frame = delphi.repair \
                    .setTableName(name) \
                    .setRowId(data.row_id) \
                    .setErrorDetectors(_detectors(data)) \
                    .setTargets(list(data.targets)) \
                    .run()
            finally:
                obs.stop_recording(rec)
                get_session().drop(name)
            if rec is not None:
                scorecards = getattr(rec, "scorecards", None)
                escalation = getattr(rec, "escalation", None)
                counters = {
                    k: int(v) for k, v in
                    rec.registry.snapshot()["counters"].items()
                    if k.startswith(("train.", "escalation.", "repair."))}
    except Exception as e:            # a broken scenario must not hide the rest
        error = f"{type(e).__name__}: {e}"
        _logger.warning(f"gauntlet scenario {data.name} failed: {error}")
    finally:
        if saved_prov is None:
            os.environ.pop("DELPHI_PROVENANCE_PATH", None)
        else:
            os.environ["DELPHI_PROVENANCE_PATH"] = saved_prov
    elapsed = time.time() - t0

    from delphi_tpu_torch.observability import scorecard_summary
    repaired = apply_repairs(data.dirty, repair_frame, data.row_id)
    result = {
        "rows": int(len(data.clean)),
        "attributes": int(len(data.clean.columns) - 1),
        "targets": list(data.targets),
        "repairs_enabled": bool(repairs_enabled),
        "repair": score_cells(repair_frame, data.truth),
        "scorecards": scorecards,
        "scorecard_summary": scorecard_summary(scorecards),
        "escalation": escalation,
        "counters": counters,
        "downstream": downstream_score(data, repaired, seed=seed),
        "elapsed_s": round(elapsed, 3),
    }
    if error:
        result["error"] = error
    return result


def run_gauntlet(names: Optional[List[str]] = None,
                 rows: Optional[int] = None,
                 seed: Optional[int] = None,
                 repairs_enabled: bool = True,
                 heartbeat=None) -> Dict[str, Any]:
    """Runs the named scenarios (default: the full registry) and returns
    the versioned gauntlet report section."""
    if names is None:
        env_names = os.environ.get("DELPHI_GAUNTLET_SCENARIOS", "")
        names = [n.strip() for n in env_names.split(",") if n.strip()] \
            or scenario_names()
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise KeyError(f"unknown gauntlet scenarios: {unknown} "
                       f"(registry: {scenario_names()})")
    if rows is None:
        rows = int(os.environ.get("DELPHI_GAUNTLET_ROWS", DEFAULT_ROWS))
    if seed is None:
        seed = int(os.environ.get("DELPHI_GAUNTLET_SEED", "0"))

    scenarios: Dict[str, Any] = {}
    for n in names:
        if heartbeat:
            heartbeat(f"gauntlet scenario {n} ({rows} rows)")
        data = generate_scenario(n, rows, seed)
        scenarios[n] = run_scenario(data, seed=seed,
                                    repairs_enabled=repairs_enabled)

    f1s = [s["repair"]["f1"] for s in scenarios.values()]
    gaps = [s["downstream"]["gap_closed"] for s in scenarios.values()
            if s["downstream"]["gap_closed"] is not None]
    return {
        "version": GAUNTLET_REPORT_VERSION,
        "seed": int(seed),
        "rows": int(rows),
        "repairs_enabled": bool(repairs_enabled),
        "scenarios": scenarios,
        "mean_f1": round(sum(f1s) / len(f1s), 4) if f1s else 0.0,
        "mean_gap_closed":
            round(sum(gaps) / len(gaps), 4) if gaps else None,
    }


def emit_gauntlet_metrics(registry: Any, report: Dict[str, Any]) -> None:
    """Lands a gauntlet report's aggregates as ``gauntlet.*`` counters and
    gauges on a metrics registry (the live ``/metrics`` plane pre-seeds
    the same names so dashboards see zeros before the first run)."""
    scenarios = report.get("scenarios", {})
    registry.inc("gauntlet.scenarios", len(scenarios))
    for s in scenarios.values():
        registry.inc("gauntlet.cells_injected",
                     s["repair"]["injected"])
        registry.inc("gauntlet.repairs", s["repair"]["repairs"])
        registry.inc("gauntlet.repairs_correct",
                     s["repair"]["correct"])
        if s.get("error"):
            registry.inc("gauntlet.scenario_errors")
    registry.set_gauge("gauntlet.mean_f1", report.get("mean_f1") or 0.0)
    if report.get("mean_gap_closed") is not None:
        registry.set_gauge("gauntlet.mean_gap_closed",
                           report["mean_gap_closed"])
    for name, s in scenarios.items():
        registry.set_gauge(f"gauntlet.{name}.f1", s["repair"]["f1"])
        gap = s["downstream"].get("gap_closed")
        if gap is not None:
            registry.set_gauge(f"gauntlet.{name}.gap_closed", gap)
