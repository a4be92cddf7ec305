"""Feature encoding for repair models.

A host-only copy of the JAX package's encoders: :class:`OrdinalEncoder`
feeds the GBDT heads (discrete values -> ordinal codes, continuous kept
raw); :class:`FeatureEncoder` one-hot encodes discrete features (with an
unknown/NULL slot) and standardizes continuous ones for the linear heads.
"""

from typing import Dict, List, Sequence

import numpy as np
import pandas as pd


def _vocab_codes(series: pd.Series, vocab: Dict[str, int],
                 default: int) -> np.ndarray:
    """``vocab.get(str(v), default)`` per cell (NULL -> default), computed
    over the DISTINCT raw values: one C-speed factorize pass plus a
    vocab-sized Python loop instead of a per-row lambda. Distinct raw
    values sharing a string form hit the same vocab entry, exactly like
    the per-row ``str(v)`` lookup (with -0.0 folded into +0.0 so the probe
    string matches the encode-side normalization in table.py)."""
    from delphi_tpu_torch.table import normalize_neg_zero
    try:
        codes, uniques = pd.factorize(normalize_neg_zero(series.to_numpy()),
                                      use_na_sentinel=True)
    except TypeError:
        # unhashable cell values (e.g. ad-hoc object columns) — per-row path
        return series.map(
            lambda v: vocab.get(str(v), default) if pd.notna(v) else default
        ).to_numpy(dtype=np.int64)
    if len(uniques) == 0:  # all-NULL column
        return np.full(len(codes), default, dtype=np.int64)
    lut = np.fromiter((vocab.get(str(v), default) for v in uniques),
                      dtype=np.int64, count=len(uniques))
    return np.where(codes >= 0,
                    lut[np.maximum(codes, 0)],
                    np.int64(default))


def f1_macro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 over the classes present in ``y_true``: the CV
    scorer for classifier selection (``gbdt._f1_from_confusion`` computes
    the same from a confusion matrix)."""
    classes = np.unique(y_true)
    f1s = []
    for c in classes:
        tp = float(((y_pred == c) & (y_true == c)).sum())
        fp = float(((y_pred == c) & (y_true != c)).sum())
        fn = float(((y_pred != c) & (y_true == c)).sum())
        p = tp / (tp + fp) if tp + fp > 0 else 0.0
        r = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1s.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def balanced_class_weights(counts: np.ndarray, n: int,
                           damped: bool = True) -> np.ndarray:
    """Balanced class weights, optionally square-root-damped.

    The reference trains LightGBM with sklearn-style ``class_weight=
    'balanced'`` (``n / (k * count)``, train.py:105). On dirty tables that
    scheme gives one-row noise classes (undetected typos like 'yex'/'ax' in
    hospital) weights hundreds of times larger than the majority class, so
    repair-time predictions on masked rows collapse into typo leaves. With
    ``damped=True`` (the GBDT head) the sqrt keeps the minority-vs-majority
    ordering but compresses the ratio quadratically — minority recall stays,
    typo classes stop winning. The logistic head uses ``damped=False`` (the
    reference's exact scheme): its huge-cardinality targets depend on strong
    minority upweighting (flights repair F1 drops measurably without it)."""
    k = len(counts)
    raw = n / (k * np.maximum(counts.astype(np.float64), 1.0))
    return np.sqrt(raw) if damped else raw


class OneHotDesign:
    """Compact factorization of :class:`FeatureEncoder`'s dense design
    matrix. The dense matrix is block-sparse — one 1.0 per discrete-feature
    block — so ``X @ W`` is really an embedding gather: storing the per-block
    LOCAL hot index (``cat_idx``) plus the dense continuous columns lets the
    logistic head train with O(n * F * k) gathers instead of O(n * D * k)
    matmul FLOPs (D is the summed vocab width, often hundreds of times F).
    ``layout`` records each feature's dense column span so the dense matrix
    (or dense-equivalent weights) can always be reconstructed."""

    def __init__(self, cat_idx: np.ndarray, cont: np.ndarray,
                 cat_sizes: List[int], layout: List[tuple],
                 width: int) -> None:
        self.cat_idx = cat_idx      # int32 [n, Fc], local index per block
        self.cont = cont            # float32 [n, Fd]
        self.cat_sizes = cat_sizes  # [Fc] block widths (vocab + unknown slot)
        self.layout = layout        # [("cat"|"cont", dense_start, slot)]
        self.width = width          # dense column count

    @property
    def shape(self):
        return (self.cat_idx.shape[0], self.width)

    def __len__(self) -> int:
        return self.cat_idx.shape[0]

    def dense(self) -> np.ndarray:
        n = len(self)
        out = np.zeros((n, self.width), dtype=np.float32)
        rows = np.arange(n)
        for kind, start, slot in self.layout:
            if kind == "cat":
                out[rows, start + self.cat_idx[:, slot]] = 1.0
            else:
                out[:, start] = self.cont[:, slot]
        return out


class FeatureEncoder:
    """fit/transform over pandas feature frames -> float32 [n, D]."""

    def __init__(self, features: Sequence[str], continuous: Sequence[str],
                 max_onehot: int = 256) -> None:
        self.features = list(features)
        self.continuous = [c for c in continuous if c in self.features]
        self.max_onehot = max_onehot
        self._vocab: Dict[str, Dict[str, int]] = {}
        self._mean: Dict[str, float] = {}
        self._std: Dict[str, float] = {}
        self.n_dims = 0
        self._fitted = False

    def fit(self, X: pd.DataFrame) -> "FeatureEncoder":
        self.n_dims = 0
        for f in self.features:
            if f in self.continuous:
                v = pd.to_numeric(X[f], errors="coerce").to_numpy(dtype=np.float64)
                mean = float(np.nanmean(v)) if np.isfinite(v).any() else 0.0
                std = float(np.nanstd(v))
                self._mean[f] = mean
                self._std[f] = std if std > 0 else 1.0
                self.n_dims += 1
            else:
                values = X[f].dropna().astype(str)
                counts = values.value_counts()
                vocab = {v: i for i, v in enumerate(counts.index[: self.max_onehot])}
                self._vocab[f] = vocab
                self.n_dims += len(vocab) + 1  # +1 unknown/NULL slot
        self._fitted = True
        return self

    def transform(self, X: pd.DataFrame) -> np.ndarray:
        assert self._fitted, "fit() must be called before transform()"
        n = len(X)
        out = np.zeros((n, self.n_dims), dtype=np.float32)
        d = 0
        for f in self.features:
            if f in self.continuous:
                v = pd.to_numeric(X[f], errors="coerce").to_numpy(dtype=np.float64)
                v = (v - self._mean[f]) / self._std[f]
                out[:, d] = np.where(np.isnan(v), 0.0, v).astype(np.float32)
                d += 1
            else:
                vocab = self._vocab[f]
                width = len(vocab) + 1
                idx = _vocab_codes(X[f], vocab, len(vocab))
                out[np.arange(n), d + idx] = 1.0
                d += width
        return out

    def fit_transform(self, X: pd.DataFrame) -> np.ndarray:
        return self.fit(X).transform(X)

    def transform_compact(self, X: pd.DataFrame) -> OneHotDesign:
        """Same encoding as :meth:`transform` in the factored
        :class:`OneHotDesign` form (``design.dense()`` reproduces
        ``transform(X)`` exactly)."""
        assert self._fitted, "fit() must be called before transform_compact()"
        n = len(X)
        cat_cols, cat_sizes, cont_cols, layout = [], [], [], []
        d = 0
        for f in self.features:
            if f in self.continuous:
                v = pd.to_numeric(X[f], errors="coerce").to_numpy(dtype=np.float64)
                v = (v - self._mean[f]) / self._std[f]
                layout.append(("cont", d, len(cont_cols)))
                cont_cols.append(np.where(np.isnan(v), 0.0, v).astype(np.float32))
                d += 1
            else:
                vocab = self._vocab[f]
                width = len(vocab) + 1
                layout.append(("cat", d, len(cat_cols)))
                cat_cols.append(_vocab_codes(X[f], vocab, len(vocab))
                                .astype(np.int32))
                cat_sizes.append(width)
                d += width
        cat_idx = np.stack(cat_cols, axis=1) if cat_cols \
            else np.zeros((n, 0), np.int32)
        cont = np.stack(cont_cols, axis=1) if cont_cols \
            else np.zeros((n, 0), np.float32)
        return OneHotDesign(cat_idx, cont, cat_sizes, layout, self.n_dims)

    def fit_transform_compact(self, X: pd.DataFrame) -> OneHotDesign:
        return self.fit(X).transform_compact(X)


class OrdinalEncoder:
    """Discrete values -> ordinal codes (unknown/NULL -> -1), continuous kept
    raw. The bin-friendly layout used by the GBDT models."""

    def __init__(self, features: Sequence[str], continuous: Sequence[str]) -> None:
        self.features = list(features)
        self.continuous = [c for c in continuous if c in self.features]
        self._vocab: Dict[str, Dict[str, int]] = {}
        self._fitted = False

    def fit(self, X: pd.DataFrame) -> "OrdinalEncoder":
        for f in self.features:
            if f not in self.continuous:
                values = X[f].dropna().astype(str).unique()
                self._vocab[f] = {v: i for i, v in enumerate(values)}
        self._fitted = True
        return self

    def transform(self, X: pd.DataFrame) -> np.ndarray:
        assert self._fitted
        cols = []
        for f in self.features:
            if f in self.continuous:
                cols.append(pd.to_numeric(X[f], errors="coerce")
                            .to_numpy(dtype=np.float64))
            else:
                vocab = self._vocab[f]
                codes = _vocab_codes(X[f], vocab, -1).astype(np.float64)
                codes[codes < 0] = np.nan
                cols.append(codes)
        return np.stack(cols, axis=1) if cols else np.zeros((len(X), 0))

    def fit_transform(self, X: pd.DataFrame) -> np.ndarray:
        return self.fit(X).transform(X)
