"""Observability of the port. So far only the per-cell provenance ledger
(:mod:`.provenance`: ``DELPHI_PROVENANCE_PATH`` /
``repair.provenance.path``) and its per-attribute quality scorecards. The
run report, live telemetry, drift gate and traces are queue 1 item 10 of
``ROADMAP.md``; ``RepairModel.run()`` raises for their settings."""

from delphi_tpu_torch.observability.provenance import (  # noqa: F401
    ProvenanceLedger, active_ledger, provenance_configured,
    scorecard_summary,
)
