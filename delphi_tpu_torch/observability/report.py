"""Structured run report: versioned JSON emitted at the end of
``RepairModel.run()`` (and by ``bench.py``) when ``DELPHI_METRICS_PATH`` /
``repair.metrics.path`` is set.

Schema (version 8; version 1-7 reports still load, see
:func:`load_run_report`)::

    {
      "schema_version": 8,
      "kind": "delphi_tpu.run_report",
      "created_at": "<ISO-8601 UTC>",
      "status": "ok" | "error" | "running",  # "running" from /report only
      "error": "<message>",                  # only when status == "error"
      "run":   {...},                        # caller-supplied run facts
      "env":   {backend, devices, versions},
      "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
      "spans": {name, start_s, wall_s, [device_s], children: [...]},
      "device_time": {trace_dir, device_busy_s, per_phase: {},
                      complete: bool,                     # the port's
                      top_kernels: [{name, total_s}],     # the port's
                      per_phase_kernels: {}} | null,      # the port's
      "per_process": null | {                # multi-host runs only
        "<rank>": {"process_index": 0,
                   "metrics": {...},         # that rank's own registry
                   "spans": {...},           # process-tagged span tree
                   "scorecards": {...}}      # that rank's own scorecards
      },
      "scorecards": null | {                 # v3+: provenance enabled only
        "<attribute>": {cells_flagged, cells_repaired, repair_rate,
                        detectors: {}, decisions: {},
                        confidence: {count, sum, min, max, mean, bins: [],
                                     low_confidence_fraction},
                        domain_size: {count, sum, min, max, mean, hist: {}},
                        repaired_values: {},
                        escalation: {routed, routed_reasons: {},
                                     repairs: {}},  # v5+
                        [model_cv_score]}
      },
      "drift": null | {...},                 # v3+: --baseline-report runs
      "incremental": null | {...},           # v4+: incremental (delta) runs
      "escalation": null | {                 # v5+: escalation-tier runs
        "requested": true, "conf_threshold": 0.5,
        "routed": 0, "escalated": 0,
        "budget": {limit, spent, exhausted},
        "tiers": {"pattern": {attempts, repairs},
                  "joint": {attempts, repairs},
                  "adapter": {allowed, calls, attempts, repairs}},
        "routed_cells": [[row_id, attribute], ...],       # capped
        "escalated_cells": [[row_id, attribute, tier, value], ...]
      },
      "trace": null | {dir, sample, [trace_id]},   # v8+: trace plane armed
      "launch_costs": null | {                     # v8+: launch ledger
        "fingerprints": {"<fp>": {"<phase>": {"<bucket>": {
            count, wall_s, device_s, useful_units, padded_units,
            signature}}}},
        "buckets": 0, "wall_s": 0.0, "device_s": 0.0
      },
      "slo": null | {                              # v9+: sustained-load SLOs
        "requests": {sent, answered, ok, failed, shed, gave_up, retries},
        "consistent": true,            # sent == answered + shed + gave_up
        "qps": 0.0, "shed_rate": 0.0,
        "latency": {count, mean, p50, p90, p99},
        "warm_hit_ratio": null | 0.0,
        "per_worker": {"<wid>": {requests, share}},
        "per_segment": {"<segment>": {...same shape...}},
        "segments": [{name, duration_s, rate_rps}, ...],
        "recovery": {fail_over, steady_p99_s, ..., violations},
        "autoscale": {"events": [{action, reason, worker, at_s}, ...]},
        "kill": null | {worker, at_segment}
      }
    }

On a multi-host cluster every rank's registry state and span tree travel
through ``parallel.distributed.allgather_pickled`` at ``stop_recording``;
the report's top-level ``metrics`` then hold the cluster-wide merge
(counters summed, gauges maxed, histogram reservoirs combined) while
``per_process`` preserves each rank's own view.

Device-time attribution joins the ``torch.profiler`` records of
``delphi_tpu_torch/utils/profiling.py`` against the ``record_function``
ranges that ``phase_span`` opens: the host ranges (named after the span)
define per-phase time windows, and the kernel, memcpy and memset intervals
on the card overlapping those windows are credited to the phase. The
schema, its version and its kind are the JAX package's, so either
package's loader reads the other's reports; ``env`` names torch, CUDA and
the card where the JAX package names its jax backend.
"""

import json
import os
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Optional, Tuple

from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

REPORT_SCHEMA_VERSION = 9
SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9)
REPORT_KIND = "delphi_tpu.run_report"

def attribute_device_time(events: Optional[List[Any]],
                          span_names: Iterable[str]) \
        -> Optional[Dict[str, Any]]:
    """Joins a profile's normalized records
    (:func:`delphi_tpu_torch.utils.profiling.profiler_events`) against
    span names.

    Returns ``{"device_busy_s": float, "per_phase": {name: seconds},
    "complete": bool, "top_kernels": [...], "per_phase_kernels": {name:
    [...]}}`` (``complete`` False when the profile's primer kept no record,
    :func:`delphi_tpu_torch.utils.profiling.drop_primer`; the kernels by
    device seconds, overall and inside each span's ranges), or
    ``None`` when the profile holds no device records (a run on the CPU)
    or no range of the spans."""
    from delphi_tpu_torch.utils import profiling

    if not events:
        return None
    device = profiling.device_intervals(events)
    windows = profiling.annotation_windows(events, span_names)
    if not device or not windows:
        return None
    per_phase = {name: round(profiling.overlap_ns(device, iv) / 1e9, 6)
                 for name, iv in sorted(windows.items())}
    busy_s, top = profiling.busy_and_top_kernels(events)
    return {"device_busy_s": round(busy_s, 6), "per_phase": per_phase,
            "complete": bool(getattr(events, "complete", True)),
            "top_kernels": _named(top),
            "per_phase_kernels": {
                name: _named(kernels) for name, kernels in
                profiling.phase_kernels(events, windows).items()}}


def _named(kernels: List[Tuple[str, float]]) -> List[Dict[str, Any]]:
    return [{"name": n[:120], "total_s": round(t, 6)} for n, t in kernels]


def _peak_rss_gb() -> Optional[float]:
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM:"):
                    return round(int(ln.split()[1]) / 1024 / 1024, 3)
    except Exception:
        pass
    return None


def _env_info() -> Dict[str, Any]:
    import platform

    info: Dict[str, Any] = {
        "python_version": platform.python_version(),
        "platform": platform.platform(),
    }
    try:
        import torch

        from delphi_tpu_torch import device as _device
        from delphi_tpu_torch.parallel import distributed

        dev = _device.get_device()
        info.update({
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "backend": dev.type,
            "device_count": torch.cuda.device_count()
            if torch.cuda.is_available() else 0,
            "device_kind": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else None,
            "process_index": distributed.process_index(),
            "process_count": distributed.process_count(),
        })
    except Exception as e:
        info["torch_error"] = f"{type(e).__name__}: {e}"
    return info


def _record_memory_gauges(registry: Any) -> None:
    """Peak RSS + the card's memory gauges, sampled at report time."""
    rss = _peak_rss_gb()
    if rss is not None:
        registry.set_gauge("system.peak_rss_gb", rss)
    try:
        import torch

        if torch.cuda.is_initialized():
            registry.set_gauge("device.bytes_in_use",
                               torch.cuda.memory_allocated())
            registry.set_gauge("device.peak_bytes_in_use",
                               torch.cuda.max_memory_allocated())
    except Exception:
        pass


def gather_per_process(recorder: Any) -> None:
    """Multi-host report aggregation (collective — every rank calls this at
    ``stop_recording``): all-gathers each rank's raw registry state and span
    tree and stores the rank-ordered payload list on
    ``recorder.per_process``. Single-process runs are a no-op.

    BOUNDED: a membership heartbeat runs first, then the gather itself
    goes through the ``report.gather`` guarded-collective site — a dead
    or wedged peer degrades this rank to its own per-rank report, flagged
    ``aggregation_incomplete`` in the report's ``dist`` section, instead
    of hanging at shutdown and losing the report entirely."""
    from delphi_tpu_torch.parallel import distributed

    if distributed.process_count() == 1:
        return
    from delphi_tpu_torch.observability.provenance import scorecards_for
    from delphi_tpu_torch.parallel import dist_resilience

    dist_resilience.ensure_membership()
    payload = {
        "process_index": distributed.process_index(),
        "metrics": recorder.registry.export_state(),
        "spans": recorder.root.to_dict(),
        "scorecards": scorecards_for(recorder),
    }
    if dist_resilience.single_host_latched():
        # peers are gone (heartbeat or an earlier collective degraded):
        # this rank's own payload is the whole report
        dist_resilience.mark_aggregation_incomplete()
        recorder.per_process = [payload]
    else:
        recorder.per_process = distributed.allgather_pickled(
            payload, site="report.gather")
        if dist_resilience.single_host_latched():
            # the gather itself timed out and fell back to [payload]
            dist_resilience.mark_aggregation_incomplete()
    recorder.dist = dist_resilience.report_section()


def _tag_process(span_dict: Dict[str, Any], rank: int) -> None:
    span_dict["process"] = rank
    for child in span_dict.get("children", []):
        _tag_process(child, rank)


def _per_process_section(gathered: List[Dict[str, Any]]) \
        -> Tuple[Dict[str, Any], Dict[str, Any], Optional[Dict[str, Any]]]:
    """(per_process section, merged cluster-wide metrics, merged cluster-wide
    scorecards) from the gathered rank payloads. Ranks are keyed by gather
    order — ``allgather_pickled`` returns payloads in process order on every
    rank."""
    from delphi_tpu_torch.observability.provenance import merge_scorecards
    from delphi_tpu_torch.observability.registry import (
        merge_state_snapshots, state_snapshot)

    import copy

    section: Dict[str, Any] = {}
    states = []
    cards = []
    for rank, payload in enumerate(gathered):
        # deep-copied before tagging: the tag mutates in place, and gathered
        # payloads may alias (this rank's own payload, or test fakes that
        # return the same object per rank)
        spans = copy.deepcopy(payload["spans"])
        _tag_process(spans, rank)
        section[str(rank)] = {
            "process_index": rank,
            "metrics": state_snapshot(payload["metrics"]),
            "spans": spans,
            "scorecards": payload.get("scorecards"),
        }
        states.append(payload["metrics"])
        cards.append(payload.get("scorecards"))
    merged_cards = merge_scorecards(cards) if any(cards) else None
    return section, merge_state_snapshots(states), merged_cards


def build_run_report(recorder: Any,
                     run: Optional[Dict[str, Any]] = None,
                     status: str = "ok",
                     error: Optional[str] = None) -> Dict[str, Any]:
    """Assembles the versioned report dict from a finished recorder."""
    _record_memory_gauges(recorder.registry)

    root = recorder.root
    device_time = None
    if recorder.trace_dir:
        names = {s.name for s in root.walk() if s is not root}
        device_time = attribute_device_time(
            getattr(recorder, "device_events", None), names)
        if device_time is not None:
            device_time["trace_dir"] = recorder.trace_dir
            per_phase = device_time["per_phase"]
            # Annotate span nodes in place; a name repeated across the tree
            # (e.g. chunked repair passes) only gets the per-phase total in
            # `device_time`, since windows for same-named spans are merged.
            counts: Dict[str, int] = {}
            for s in root.walk():
                counts[s.name] = counts.get(s.name, 0) + 1
            for s in root.walk():
                if counts.get(s.name) == 1 and s.name in per_phase:
                    s.device_s = per_phase[s.name]

    from delphi_tpu_torch.observability.provenance import scorecards_for

    per_process = None
    gathered = getattr(recorder, "per_process", None)
    if gathered and len(gathered) > 1:
        per_process, metrics, scorecards = _per_process_section(gathered)
    else:
        metrics = recorder.registry.snapshot()
        scorecards = scorecards_for(recorder)

    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "kind": REPORT_KIND,
        "created_at": datetime.fromtimestamp(
            recorder.started_at, tz=timezone.utc).isoformat(),
        "status": status,
        **({"error": error} if error else {}),
        "run": run or {},
        "env": _env_info(),
        "metrics": metrics,
        "spans": root.to_dict(),
        "device_time": device_time,
        "per_process": per_process,
        "scorecards": scorecards,
        "drift": getattr(recorder, "drift", None),
        "incremental": getattr(recorder, "incremental", None),
        "escalation": getattr(recorder, "escalation", None),
        "dist": getattr(recorder, "dist", None),
        "gauntlet": getattr(recorder, "gauntlet", None),
        "trace": _trace_section(recorder),
        "launch_costs": _launch_costs_section(recorder),
        "slo": getattr(recorder, "slo", None),
    }


def _trace_section(recorder: Any) -> Optional[Dict[str, Any]]:
    """v8 ``trace`` section: the distributed-trace identity of this run
    (stamped by ``trace.finalize_run`` at stop_recording; recomputed here
    for callers that build a report mid-run, e.g. GET /report)."""
    info = getattr(recorder, "trace_info", None)
    if info is not None:
        return info
    from delphi_tpu_torch.observability import trace as _trace
    return _trace.run_trace_info()


def _launch_costs_section(recorder: Any) -> Optional[Dict[str, Any]]:
    """v8 ``launch_costs`` section: per-bucket launch-cost aggregates
    (wall + profiler-attributed device seconds) from the launch ledger."""
    costs = getattr(recorder, "launch_costs", None)
    if costs is not None:
        return costs
    from delphi_tpu_torch.observability import trace as _trace
    return _trace.ledger_summary()


def write_run_report(report: Dict[str, Any], path: str) -> None:
    """Crash-consistent write through the durable-store seam (site
    ``store.report``): envelope-framed (crc32 + length), same-directory
    temp file, fsync, ``os.replace``, directory fsync — a run killed
    mid-write (or a mid-write crash on a non-serializable report) never
    leaves a truncated JSON for ``load_run_report`` to silently discard,
    and any pre-existing report at ``path`` survives intact."""
    from delphi_tpu_torch.parallel import store as dstore
    dstore.write_json(os.path.abspath(path), report, schema="run_report",
                      site="store.report", indent=2, sort_keys=False)
    _logger.info(f"Run report written to {path}")


def upgrade_run_report(report: Dict[str, Any]) -> Dict[str, Any]:
    """In-memory v1..v8 -> v9 upgrade: each version only adds keys
    (v2 added ``per_process``, v3 added ``scorecards`` and ``drift``, v4
    added ``incremental``, v5 added ``escalation``, v6 added ``dist`` —
    the distributed-resilience section, v7 added ``gauntlet`` — the
    scenario-gauntlet quality section, v8 added ``trace`` and
    ``launch_costs`` — the distributed-trace identity and per-launch
    device-cost ledger, v9 added ``slo`` — the sustained-load SLO
    ledger), so an older report becomes a valid v9 one by defaulting
    them. Consumers can rely on the v9 shape regardless of the file's
    age."""
    version = report.get("schema_version")
    if version == REPORT_SCHEMA_VERSION:
        return report
    report = dict(report)
    report.setdefault("per_process", None)   # v1 -> v2
    report.setdefault("scorecards", None)    # v2 -> v3
    report.setdefault("drift", None)         # v2 -> v3
    report.setdefault("incremental", None)   # v3 -> v4
    report.setdefault("escalation", None)    # v4 -> v5
    report.setdefault("dist", None)          # v5 -> v6
    report.setdefault("gauntlet", None)      # v6 -> v7
    report.setdefault("trace", None)         # v7 -> v8
    report.setdefault("launch_costs", None)  # v7 -> v8
    report.setdefault("slo", None)           # v8 -> v9
    report["schema_version"] = REPORT_SCHEMA_VERSION
    report["schema_version_loaded_from"] = version
    return report


def load_run_report(path: str) -> Optional[Dict[str, Any]]:
    """Loads and (when needed) upgrades a run report; ``None`` for missing
    or unreadable files and for schema versions this build doesn't know.
    Validated through the store seam: a truncated/corrupt report is
    quarantined and reads as missing; a pre-seam raw-JSON report (e.g. an
    old ``--baseline-report``) loads through the legacy path."""
    from delphi_tpu_torch.parallel import store as dstore
    report, status = dstore.read_json(path, schema="run_report",
                                      site="store.report")
    if report is None:
        _logger.warning(f"cannot load run report {path} ({status})")
        return None
    if not isinstance(report, dict):
        _logger.warning(f"cannot load run report {path}: not a JSON object")
        return None
    version = report.get("schema_version")
    if version not in SUPPORTED_SCHEMA_VERSIONS:
        _logger.warning(
            f"run report {path} has unsupported schema version {version} "
            f"(supported: {SUPPORTED_SCHEMA_VERSIONS})")
        return None
    return upgrade_run_report(report)


def bench_entry(metric: str, value: Any, unit: str,
                extra: Optional[Dict[str, Any]] = None,
                run_report: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One BENCH_r*.json result line, produced by the framework so bench
    entries and run reports share a schema version."""
    entry: Dict[str, Any] = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "kind": "delphi_tpu.bench_entry",
        "metric": metric,
        "value": value,
        "unit": unit,
    }
    if extra:
        entry.update(extra)
    if run_report is not None:
        entry["run_report"] = run_report
    return entry
