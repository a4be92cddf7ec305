"""Deterministic seeded scenario generators for the gauntlet.

Each scenario is a recipe for a *family* of tables: a seeded clean-table
generator, an injector stack (:mod:`delphi_tpu_torch.gauntlet.inject`), a
detector/constraint spec for the repair run, and a downstream-learning
task (label column + classification/regression) for the BoostClean-style
accuracy triple. :func:`generate_scenario` materializes one member as a
:class:`ScenarioData` — clean frame, dirty frame, and the ground-truth
map of every injected cell — at any row count in the scenario's scale
series (2k → 100k+; smokes use smaller cuts of the same recipe).

None of this touches external testdata: every value is derived from the
row index and a ``numpy.random.RandomState`` stream, so the same
``(name, rows, seed)`` triple is byte-identical everywhere.

The registry covers the claims the pipeline makes beyond flights:

* ``fd_categorical`` — categorical attributes governed by planted
  functional dependencies (city → state → region), corrupted by typos,
  nulls, and FD-violating rewrites; constraints ride along as DC text.
* ``numeric_regression`` — numeric columns carrying a ground-truth
  linear signal, corrupted by large outliers and nulls; exercises the
  regression branch of model training (pinned by tests).
* ``missing_heavy`` — a mostly-categorical table where 20%+ of cells in
  the target attributes are blanked; repair = imputation at scale.
* ``wide`` — 50+ columns in correlated groups; stresses per-attribute
  model fan-out and launch planning.
* ``correlated_multi`` — multi-attribute corruption correlated across
  columns of the same row (the escalation joint tier's home turf).
"""

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from delphi_tpu_torch.gauntlet.inject import (Cell, FDViolationInjector,
                                              Injector, NullInjector,
                                              OutlierInjector, SwapInjector,
                                              TypoInjector, inject)

#: default scale series every scenario supports (rows)
SCALES = (2_000, 20_000, 100_000)


@dataclass
class ScenarioData:
    """One materialized scenario instance."""
    name: str
    clean: pd.DataFrame
    dirty: pd.DataFrame
    truth: Dict[Cell, Any]          # (tid, attribute) -> clean value
    row_id: str
    label: str                      # downstream target column
    task: str                       # "classification" | "regression"
    constraints: Optional[str]      # DC text for ConstraintErrorDetector
    regexes: List[Tuple[str, str]]  # (attr, pattern) for RegExErrorDetector
    targets: List[str]              # repair target attributes
    outlier_detection: bool = False


@dataclass
class Scenario:
    """A registered scenario recipe."""
    name: str
    description: str
    build_clean: Callable[[int, np.random.RandomState], pd.DataFrame]
    injectors: Callable[[], List[Injector]]
    label: str
    task: str
    constraints: Optional[str] = None
    regexes: List[Tuple[str, str]] = field(default_factory=list)
    targets: Optional[List[str]] = None
    outlier_detection: bool = False
    scales: Tuple[int, ...] = SCALES

    def generate(self, rows: int, seed: int = 0) -> ScenarioData:
        rng = np.random.RandomState(seed * 7919 + len(self.name))
        clean = self.build_clean(rows, rng)
        assert "tid" in clean.columns
        dirty, truth = inject(clean, self.injectors(), seed, row_id="tid")
        targets = self.targets or [
            c for c in clean.columns if c != "tid"]
        return ScenarioData(
            name=self.name, clean=clean, dirty=dirty, truth=truth,
            row_id="tid", label=self.label, task=self.task,
            constraints=self.constraints, regexes=list(self.regexes),
            targets=targets, outlier_detection=self.outlier_detection)


def _tids(n: int) -> List[str]:
    return [str(i) for i in range(n)]


# ---------------------------------------------------------------------------
# clean-table generators (all vectorized; 100k+ rows stay cheap)
# ---------------------------------------------------------------------------

def _fd_categorical_clean(n: int, rng: np.random.RandomState) -> pd.DataFrame:
    """city -> state -> region FD chain + an independent channel column.
    The region label is a pure function of city/state, so a downstream
    classifier on clean data is near-perfect and every corrupted feature
    cell costs it accuracy."""
    city = rng.randint(0, 24, size=n)
    state = city % 12
    region = state % 4
    channel = rng.randint(0, 3, size=n)
    return pd.DataFrame({
        "tid": _tids(n),
        "city": [f"city_{i:02d}" for i in city],
        "state": [f"state_{i:02d}" for i in state],
        "region": [f"region_{i}" for i in region],
        "channel": [f"ch_{i}" for i in channel],
    })


def _numeric_regression_clean(n: int,
                              rng: np.random.RandomState) -> pd.DataFrame:
    """Numeric features + a target carrying a real linear signal with a
    categorical group offset; all float columns have (essentially) all-
    distinct values, so the discrete-threshold check routes them to the
    continuous/regression path."""
    x0 = rng.uniform(-2.0, 2.0, size=n)
    x1 = rng.uniform(0.0, 4.0, size=n)
    x2 = rng.uniform(-1.0, 1.0, size=n)
    g = rng.randint(0, 6, size=n)
    noise = rng.normal(0.0, 0.25, size=n)
    y = 3.0 * x0 - 2.0 * x1 + 1.5 * g + noise
    return pd.DataFrame({
        "tid": _tids(n),
        "x0": np.round(x0, 6),
        "x1": np.round(x1, 6),
        "x2": np.round(x2, 6),
        "group": [f"g{i}" for i in g],
        "y": np.round(y, 6),
    })


def _missing_heavy_clean(n: int, rng: np.random.RandomState) -> pd.DataFrame:
    """Strongly cross-correlated categoricals, so heavy missingness stays
    imputable: tier/band/grade are functions of a latent level."""
    level = rng.randint(0, 10, size=n)
    seg = rng.randint(0, 4, size=n)
    return pd.DataFrame({
        "tid": _tids(n),
        "level": [f"lv{i}" for i in level],
        "tier": [f"t{i // 2}" for i in level],
        "band": [f"b{i % 5}" for i in level],
        "grade": [f"gr{(i + s) % 6}" for i, s in zip(level, seg)],
        "segment": [f"s{i}" for i in seg],
    })


def _wide_clean(n: int, rng: np.random.RandomState) -> pd.DataFrame:
    """56 attribute columns in 8 correlated groups of 7: every column in
    group g is a distinct renaming of that group's latent factor, so each
    has clean FD structure to learn while the table stresses per-attribute
    model fan-out."""
    data: Dict[str, Any] = {"tid": _tids(n)}
    for g in range(8):
        latent = rng.randint(0, 5, size=n)
        for j in range(7):
            data[f"a{g}_{j}"] = [f"g{g}c{j}v{(v + j) % 5}" for v in latent]
    return pd.DataFrame(data)


def _correlated_multi_clean(n: int,
                            rng: np.random.RandomState) -> pd.DataFrame:
    """One key column jointly determines three dependents — corruption
    correlated across a row's dependents is exactly what single-attribute
    repair misreads and the escalation joint tier untangles."""
    k = rng.randint(0, 9, size=n)
    return pd.DataFrame({
        "tid": _tids(n),
        "key": [f"k{i}" for i in k],
        "d0": [f"u{i % 3}" for i in k],
        "d1": [f"v{(i * 2) % 9}" for i in k],
        "d2": [f"{100 + i}-{20 + (i * 3) % 10}" for i in k],
    })


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def _register(s: Scenario) -> Scenario:
    SCENARIOS[s.name] = s
    return s


_register(Scenario(
    name="fd_categorical",
    description="planted city->state->region FDs; typos + nulls + "
                "FD-violating rewrites; DC constraints ride along",
    build_clean=_fd_categorical_clean,
    injectors=lambda: [
        TypoInjector(["state"], rate=0.02),
        NullInjector(["state", "region"], rate=0.03),
        FDViolationInjector("city", ["state", "region"], rate=0.02),
    ],
    label="region", task="classification",
    constraints="city->state;state->region",
    regexes=[("state", "^state_[0-9]{2}$")],
    targets=["state", "region"],
))

_register(Scenario(
    name="numeric_regression",
    description="numeric features + linear-signal target; large outliers "
                "+ nulls; exercises the regression training branch",
    build_clean=_numeric_regression_clean,
    injectors=lambda: [
        OutlierInjector(["y", "x0"], rate=0.03),
        NullInjector(["x1", "y"], rate=0.03),
    ],
    label="y", task="regression",
    targets=["x0", "x1", "y"],
    outlier_detection=True,
))

_register(Scenario(
    name="missing_heavy",
    description="20%+ of target cells blanked across correlated "
                "categoricals; repair = imputation at scale",
    build_clean=_missing_heavy_clean,
    injectors=lambda: [
        NullInjector(["tier", "band", "grade"], rate=0.22),
    ],
    label="segment", task="classification",
    targets=["tier", "band", "grade"],
))

_register(Scenario(
    name="wide",
    description="56 columns in 8 correlated groups; stresses per-attribute "
                "model fan-out and launch planning",
    build_clean=_wide_clean,
    injectors=lambda: [
        NullInjector([f"a{g}_0" for g in range(8)], rate=0.04),
        TypoInjector(["a0_1", "a4_1"], rate=0.03),
        SwapInjector(["a2_2"], rate=0.04),
    ],
    label="a7_0", task="classification",
    targets=[f"a{g}_0" for g in range(8)] + ["a0_1", "a4_1", "a2_2"],
    scales=(2_000, 10_000, 50_000),
))

_register(Scenario(
    name="correlated_multi",
    description="corruption correlated across a row's dependent columns "
                "(escalation joint tier's home turf)",
    build_clean=_correlated_multi_clean,
    injectors=lambda: [
        FDViolationInjector("key", ["d0", "d1", "d2"], rate=0.04),
        NullInjector(["d1", "d2"], rate=0.03),
    ],
    label="d0", task="classification",
    constraints="key->d0;key->d1;key->d2",
    regexes=[("d2", "^[0-9]{3}-[0-9]{2}$")],
    targets=["d0", "d1", "d2"],
))


def scenario_names() -> List[str]:
    return sorted(SCENARIOS)


def generate_scenario(name: str, rows: int, seed: int = 0) -> ScenarioData:
    """Materializes one scenario instance; raises ``KeyError`` for an
    unknown name (``scenario_names()`` lists the registry)."""
    return SCENARIOS[name].generate(rows, seed)
