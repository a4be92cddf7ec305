"""Observability of the port. So far the per-cell provenance ledger
(:mod:`.provenance`: ``DELPHI_PROVENANCE_PATH`` /
``repair.provenance.path``) with its per-attribute quality scorecards,
the population stability index of :mod:`.drift` that the incremental
plane gates on, and the launch-cost ledgers' report of :mod:`.trace`
(``--plan-report``). The run report, live telemetry, the cross-run drift gate
and traces are queue 1 item 10 of ``ROADMAP.md``; ``RepairModel.run()``
raises for their settings."""

from delphi_tpu_torch.observability.provenance import (  # noqa: F401
    ProvenanceLedger, active_ledger, provenance_configured,
    scorecard_summary,
)
