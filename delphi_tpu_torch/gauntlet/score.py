"""Per-scenario scoring: cell-level P/R/F1 and the BoostClean-style
downstream-accuracy triple.

Cell scoring is the flights metric generalized to numeric repairs:
precision over every repair the pipeline emitted, recall over the
injected ground-truth set, with numeric values matched under a small
tolerance (a regression model that lands within noise of the clean value
has repaired the cell; demanding bit-equality of floats would score the
regression path as permanently broken).

Downstream scoring follows BoostClean (PAPERS.md): train the same small
model three times — on the dirty, repaired, and clean versions of the
train split — evaluate each against the *clean* test split, and report
the fraction of the dirty→clean accuracy gap the repair closed
(``gap_closed = (repaired - dirty) / (clean - dirty)``). The model is a
fixed-seed sklearn decision tree (classification accuracy / regression
R²), so the triple is deterministic for a deterministic scenario.
"""

import math
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from delphi_tpu_torch.gauntlet.scenarios import ScenarioData

#: numeric match tolerances: relative OR absolute (scenario noise scale)
REL_TOL = 0.2
ABS_TOL = 0.5

#: deterministic downstream split: rows with (pos % 10) >= 7 are test
TEST_MOD = 10
TEST_CUT = 7


def _as_float(v: Any) -> Optional[float]:
    try:
        f = float(v)
        return f if math.isfinite(f) else None
    except (TypeError, ValueError):
        return None


def values_match(pred: Any, true: Any) -> bool:
    """Repair correctness for one cell: exact string equality, except when
    both sides are numeric — then within ``REL_TOL`` relative or
    ``ABS_TOL`` absolute error."""
    if pd.isna(pred) or pd.isna(true):
        return False
    pf, tf = _as_float(pred), _as_float(true)
    if pf is not None and tf is not None:
        return abs(pf - tf) <= max(REL_TOL * abs(tf), ABS_TOL)
    return str(pred) == str(true)


def score_cells(repair_frame: Optional[pd.DataFrame],
                truth: Dict[Any, Any]) -> Dict[str, Any]:
    """Cell-level precision/recall/F1 of a repair-candidates frame
    (tid/attribute/repaired) against the injected ground truth."""
    by_cell: Dict[Any, Any] = {}
    if repair_frame is not None and len(repair_frame):
        by_cell = {(str(r), str(a)): v for r, a, v in
                   zip(repair_frame["tid"], repair_frame["attribute"],
                       repair_frame["repaired"])}
    correct = sum(1 for k, v in by_cell.items()
                  if k in truth and values_match(v, truth[k]))
    p = correct / len(by_cell) if by_cell else 0.0
    r = correct / len(truth) if truth else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return {
        "injected": len(truth), "repairs": len(by_cell),
        "correct": correct, "precision": round(p, 4),
        "recall": round(r, 4), "f1": round(f1, 4),
    }


def apply_repairs(dirty: pd.DataFrame, repair_frame: Optional[pd.DataFrame],
                  row_id: str = "tid") -> pd.DataFrame:
    """Splices a repair-candidates frame back into the dirty table (the
    ``repair_data`` view, done host-side so scoring never depends on the
    pipeline's own writeback path)."""
    out = dirty.copy()
    if repair_frame is None or not len(repair_frame):
        return out
    pos = {t: i for i, t in enumerate(out[row_id].astype(str))}
    # {column: {position: value}}, the last repair of a cell winning, then
    # one assignment per column (the JAX package writes cell by cell, and
    # each write of an Arrow-backed string column copies the column)
    writes: Dict[str, Dict[int, Any]] = {}
    for r, a, v in zip(repair_frame["tid"], repair_frame["attribute"],
                       repair_frame["repaired"]):
        i = pos.get(str(r))
        if i is None or a not in out.columns:
            continue
        if pd.api.types.is_numeric_dtype(out[a]):
            v = _as_float(v)
            if v is None:
                continue
        writes.setdefault(a, {})[i] = v
    for a, cells in writes.items():
        out.iloc[list(cells), out.columns.get_loc(a)] = list(cells.values())
    return out


def _encode_features(frames: Dict[str, pd.DataFrame], feature_cols,
                     numeric_cols) -> Dict[str, np.ndarray]:
    """One consistent encoding across the dirty/repaired/clean variants:
    shared category codes for object columns (so 'the same value' gets the
    same code everywhere), sentinel-filled numerics (trees split around
    it)."""
    encoded: Dict[str, np.ndarray] = {}
    vocab: Dict[str, Dict[str, int]] = {}
    for c in feature_cols:
        if c in numeric_cols:
            continue
        values = sorted({str(v) for f in frames.values()
                         for v in f[c].dropna()})
        vocab[c] = {v: i for i, v in enumerate(values)}
    for tag, f in frames.items():
        cols = []
        for c in feature_cols:
            if c in numeric_cols:
                cols.append(pd.to_numeric(f[c], errors="coerce")
                            .fillna(-1e9).to_numpy(dtype=np.float64))
            else:
                cols.append(f[c].map(
                    lambda v: vocab[c].get(str(v), -1) if pd.notna(v)
                    else -1).to_numpy(dtype=np.float64))
        encoded[tag] = np.column_stack(cols)
    return encoded


def downstream_score(data: ScenarioData, repaired: pd.DataFrame,
                     seed: int = 0) -> Dict[str, Any]:
    """The dirty-vs-repaired-vs-clean downstream triple for one scenario.

    Train on each variant's train split, evaluate on the clean test split
    (corrupted labels poison training — that cost is part of the metric —
    but evaluation must be against truth). Rows whose label is null in a
    variant are dropped from that variant's train split only.
    """
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    label = data.label
    n = len(data.clean)
    is_test = np.array([(i % TEST_MOD) >= TEST_CUT for i in range(n)])
    feature_cols = [c for c in data.clean.columns
                    if c not in (data.row_id, label)]
    numeric_cols = {c for c in feature_cols
                    if pd.api.types.is_numeric_dtype(data.clean[c])}
    frames = {"dirty": data.dirty, "repaired": repaired, "clean": data.clean}
    X = _encode_features(frames, feature_cols, numeric_cols)

    regression = data.task == "regression"
    if regression:
        y = {t: pd.to_numeric(f[label], errors="coerce").to_numpy()
             for t, f in frames.items()}
    else:
        labels = sorted({str(v) for f in frames.values()
                         for v in f[label].dropna()})
        lmap = {v: i for i, v in enumerate(labels)}
        y = {t: f[label].map(lambda v: lmap.get(str(v), -1)
                             if pd.notna(v) else -1).to_numpy()
             for t, f in frames.items()}

    X_test = X["clean"][is_test]
    y_test = y["clean"][is_test]
    scores: Dict[str, float] = {}
    for tag in ("dirty", "repaired", "clean"):
        Xt, yt = X[tag][~is_test], y[tag][~is_test]
        keep = np.isfinite(yt) if regression else (yt >= 0)
        Xt, yt = Xt[keep], yt[keep]
        if regression:
            model = DecisionTreeRegressor(max_depth=8, random_state=seed)
        else:
            model = DecisionTreeClassifier(max_depth=8, random_state=seed)
        model.fit(Xt, yt)
        scores[tag] = round(float(model.score(X_test, y_test)), 4)

    denom = scores["clean"] - scores["dirty"]
    gap_closed = None
    if abs(denom) > 1e-9:
        gap_closed = round(
            max(-2.0, min(2.0, (scores["repaired"] - scores["dirty"])
                          / denom)), 4)
    return {
        "task": data.task,
        "metric": "r2" if regression else "accuracy",
        "dirty": scores["dirty"], "repaired": scores["repaired"],
        "clean": scores["clean"], "gap_closed": gap_closed,
        "train_rows": int((~is_test).sum()), "test_rows": int(is_test.sum()),
    }
