"""Scenario gauntlet of the port: generated workloads, error injectors,
and downstream-accuracy scoring (the JAX package's ``delphi_tpu.gauntlet``;
docs/source/gauntlet.rst).

Every quality number before this subsystem was flights @ 2376 rows — one
dataset, one error mix. The gauntlet stresses what the pipeline actually
claims to handle with **zero external testdata**:

* :mod:`delphi_tpu_torch.gauntlet.scenarios` — a registry of
  deterministic, seeded scenario generators (planted functional
  dependencies, numeric regression signal, missing-value-heavy, wide 50+
  column, correlated multi-attribute corruption), each with a scale
  series (2k → 100k+ rows) and a clean/dirty/ground-truth-cells triple.
* :mod:`delphi_tpu_torch.gauntlet.inject` — composable seeded error
  injectors (nulls, typos/transpositions, numeric outliers, value swaps,
  FD-violating correlated corruption) that record the exact injected
  cell set, so precision/recall are computed against known truth.
* :mod:`delphi_tpu_torch.gauntlet.score` +
  :mod:`delphi_tpu_torch.gauntlet.runner` — per-scenario cell-level
  P/R/F1, scorecard + escalation summaries from the provenance ledger,
  and a BoostClean-style downstream metric (train a small model on dirty
  vs repaired vs clean, report the accuracy gap closed), emitted as the
  run report's versioned ``gauntlet`` section.
* :mod:`delphi_tpu_torch.gauntlet.lookalikes` — seeded lookalikes for the
  reference testdata tree (adult/hospital/iris/flights + constraint
  files), where it is absent.

Entry point: ``python -m delphi_tpu_torch.main --gauntlet`` (with
``--baseline-report`` + ``--drift-fail-over`` for CI gating). Each
scenario's repair run launches the port's hand kernels: K1, K2 and K5's
integer mode (the runner's in-memory provenance ledger makes it a ledger
run).
"""

from delphi_tpu_torch.gauntlet.inject import (FDViolationInjector,
                                              NullInjector, OutlierInjector,
                                              SwapInjector, TypoInjector,
                                              inject)
from delphi_tpu_torch.gauntlet.scenarios import (SCENARIOS, Scenario,
                                                 generate_scenario,
                                                 scenario_names)

__all__ = [
    "FDViolationInjector", "NullInjector", "OutlierInjector",
    "SwapInjector", "TypoInjector", "inject",
    "SCENARIOS", "Scenario", "generate_scenario", "scenario_names",
]
