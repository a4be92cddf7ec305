"""Observability of the port, the JAX package's ``observability``:

* :mod:`.registry` — the run-scoped metrics registry (counters / gauges /
  histograms) that ``delphi_tpu_torch.utils.counter_inc`` & co. feed while
  a run recorder is active.
* :mod:`.spans` — the hierarchical span tree recorded by ``phase_span``
  plus the run-scoped :class:`RunRecorder` and its JSONL event stream
  (``DELPHI_METRICS_EVENTS`` / ``repair.metrics.events``).
* :mod:`.report` — the versioned run-report JSON written at the end of
  ``RepairModel.run()`` when ``DELPHI_METRICS_PATH`` or the
  ``repair.metrics.path`` session config is set, including per-phase
  device time from a ``torch.profiler`` profile (``DELPHI_PROFILE_DIR`` /
  ``repair.profile.dir``) and a ``per_process`` section on multi-process
  runs.
* :mod:`.live` — the live telemetry plane: an HTTP server with
  ``/metrics`` (Prometheus text), ``/healthz`` and ``/report`` (the
  in-flight report), a stall watchdog and a resource sampler, started with
  the run recorder when ``DELPHI_METRICS_PORT`` /
  ``repair.metrics.port`` or ``DELPHI_STALL_TIMEOUT_S`` is set.
* :mod:`.trace` — request traces (``DELPHI_TRACE_DIR``,
  ``DELPHI_TRACE_SAMPLE``) and the launch-cost ledger behind
  ``--plan-report`` and ``DELPHI_PLAN_COST``.
* :mod:`.provenance` — the per-cell repair provenance ledger
  (``DELPHI_PROVENANCE_PATH`` / ``repair.provenance.path``) and its
  per-attribute quality scorecards.
* :mod:`.drift` — the cross-run drift gate over scorecards, gauntlet and
  SLO sections (``main.py --baseline-report``).
* :mod:`.diff` — the ``report-diff`` CLI
  (``python -m delphi_tpu_torch.observability.diff``).

* :mod:`.serve` — the serving plane: ``RepairServer``, a persistent
  repair service (``POST /repair``) with admission control, per-request
  deadlines and fault isolation, and graceful drain (``main.py --serve``).
* :mod:`.fleet` — the elastic fleet: ``FleetRouter`` spawns N serving
  workers behind a rendezvous-hashing router with liveness-routed
  failover, and ``FleetAutoscaler`` scales them from queue pressure
  (``main.py --fleet N [--autoscale]``).
* :mod:`.load` — the sustained-load harness: a seeded open-loop arrival
  schedule over gauntlet-generated tables, bounded retries, and the run
  report's ``slo`` section (``DELPHI_LOAD_*``).
"""

import os
from typing import Optional

from delphi_tpu_torch.observability.live import (  # noqa: F401
    LivePlane, live_configured, metrics_port,
)
from delphi_tpu_torch.observability.provenance import (  # noqa: F401
    ProvenanceLedger, active_ledger, merge_scorecards, provenance_configured,
    provenance_path, scorecard_summary,
)
from delphi_tpu_torch.observability.registry import (  # noqa: F401
    MetricsRegistry, gauge_max,
)
from delphi_tpu_torch.observability.report import (  # noqa: F401
    REPORT_KIND, REPORT_SCHEMA_VERSION, SUPPORTED_SCHEMA_VERSIONS,
    attribute_device_time, bench_entry, build_run_report, load_run_report,
    upgrade_run_report, write_run_report,
)
from delphi_tpu_torch.observability.spans import (  # noqa: F401
    RunRecorder, Span, current_recorder, start_recording, stop_recording,
)
from delphi_tpu_torch.utils import (  # noqa: F401
    counter_inc, gauge_set, histogram_observe,
)

# Values accepted as "on" by every boolean observability toggle
# (DELPHI_METRICS_EVENTS, repair.metrics.events, DELPHI_PHASE_HEARTBEAT,
# ...). One parser so env and session-conf spellings can't drift apart.
_TRUTHY = frozenset({"1", "true", "yes", "on"})


def _flag_enabled(value: Optional[str]) -> bool:
    """True when ``value`` spells an enabled flag: 1/true/yes/on, any case."""
    return value is not None and str(value).strip().lower() in _TRUTHY


def metrics_path() -> Optional[str]:
    """The configured run-report destination, or ``None`` when the run report
    is disabled (`DELPHI_METRICS_PATH` env wins over the
    ``repair.metrics.path`` session config)."""
    path = os.environ.get("DELPHI_METRICS_PATH")
    if path:
        return path
    from delphi_tpu_torch.session import get_session

    return get_session().conf.get("repair.metrics.path") or None


def events_path_for(path: Optional[str]) -> Optional[str]:
    """JSONL event-stream destination next to the report, enabled by
    ``DELPHI_METRICS_EVENTS`` or ``repair.metrics.events`` (1/true/yes)."""
    if not path:
        return None
    if _flag_enabled(os.environ.get("DELPHI_METRICS_EVENTS")):
        return path + ".events.jsonl"
    from delphi_tpu_torch.session import get_session

    if _flag_enabled(get_session().conf.get("repair.metrics.events")):
        return path + ".events.jsonl"
    return None
