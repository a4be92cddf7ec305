"""Composable seeded error injectors for the scenario gauntlet (the JAX
package's ``delphi_tpu/gauntlet/inject.py``; numpy, pandas and zlib only).

Each injector corrupts a deterministic subset of cells in a clean table
and reports **exactly** which cells it touched, so scenario scoring can
compute precision/recall against known truth instead of eyeballing
output. Three invariants hold by construction (pinned by
``tests/test_gauntlet.py`` and ``tests/test_torch_gauntlet.py``):

* **Determinism** — the same ``(clean, injectors, seed)`` triple yields a
  byte-identical dirty table and injected-cell set on every run and every
  platform. All randomness flows through ``numpy.random.RandomState``
  (MT19937 — stable across numpy versions and OSes), with per-injector
  streams derived from ``crc32(name) ^ seed`` so appending an injector
  never perturbs the ones before it.
* **No double corruption** — a shared ``taken`` set makes every cell the
  property of at most one injector; a cell corrupted twice would make the
  "injected set" lie about what the detector is being graded on.
* **Injected ⊆ truth** — :func:`inject` returns the dirty frame together
  with a ``{(tid, attribute): clean_value}`` map covering every corrupted
  cell (a value swap corrupts *two* cells; both are recorded).

Injectors mutate positionally (``DataFrame.iloc``) and identify cells by
``(row_id value, column name)`` in the returned truth map, matching the
repair-candidate frame the pipeline emits.
"""

import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

Cell = Tuple[str, str]


def _stream(seed: int, name: str) -> np.random.RandomState:
    """Independent, platform-stable random stream per (seed, injector)."""
    return np.random.RandomState(
        (int(seed) * 1000003 + zlib.crc32(name.encode())) % (2 ** 31 - 1))


def _eligible_rows(df: pd.DataFrame, column: str,
                   taken: set, row_id: str) -> List[int]:
    """Positional indices whose (row, column) cell is non-null and not yet
    owned by another injector, in frame order (deterministic)."""
    tids = df[row_id].astype(str).tolist()
    mask = df[column].notna().to_numpy()
    return [i for i in range(len(df))
            if mask[i] and (tids[i], column) not in taken]


def _write(dirty: pd.DataFrame, column: str, cells: Dict[int, Any]) -> None:
    """Writes ``{position: value}`` into one column of ``dirty`` in one
    assignment (the JAX package writes cell by cell, and each write of an
    Arrow-backed string column copies the column)."""
    if cells:
        dirty.iloc[list(cells), dirty.columns.get_loc(column)] = \
            list(cells.values())


class Injector:
    """Base class: picks ``rate`` of the eligible cells per column and
    rewrites each through :meth:`corrupt`."""

    name = "base"

    def __init__(self, columns: Sequence[str], rate: float = 0.05):
        self.columns = list(columns)
        self.rate = float(rate)

    def corrupt(self, value: Any, column: str, df: pd.DataFrame,
                rng: np.random.RandomState) -> Any:
        raise NotImplementedError

    def apply(self, dirty: pd.DataFrame, clean: pd.DataFrame,
              rng: np.random.RandomState, taken: set,
              row_id: str) -> Dict[Cell, Any]:
        injected: Dict[Cell, Any] = {}
        tids = clean[row_id].astype(str).tolist()
        for column in self.columns:
            rows = _eligible_rows(dirty, column, taken, row_id)
            if not rows:
                continue
            k = max(1, int(round(self.rate * len(rows))))
            picked = sorted(rng.choice(len(rows), size=min(k, len(rows)),
                                       replace=False).tolist())
            values = clean[column].to_numpy()
            writes: Dict[int, Any] = {}
            for p in picked:
                i = rows[p]
                old = values[i]
                new = self.corrupt(old, column, clean, rng)
                if new is old or (pd.notna(new) and new == old):
                    continue
                cell = (tids[i], column)
                writes[i] = new
                taken.add(cell)
                injected[cell] = old
            _write(dirty, column, writes)
        return injected


class NullInjector(Injector):
    """Blanks cells (None for object columns, NaN for numeric)."""

    name = "null"

    def corrupt(self, value, column, df, rng):
        return np.nan if pd.api.types.is_numeric_dtype(df[column]) else None


class TypoInjector(Injector):
    """String typos: adjacent-character transposition, character drop, or
    character substitution — the OCR/keyboard error family."""

    name = "typo"

    _SUBS = "xqzjk7"

    def corrupt(self, value, column, df, rng):
        s = str(value)
        if len(s) < 2:
            return s + self._SUBS[rng.randint(len(self._SUBS))]
        kind = rng.randint(3)
        i = rng.randint(len(s) - 1)
        if kind == 0:                                   # transposition
            out = s[:i] + s[i + 1] + s[i] + s[i + 2:]
            if out != s:
                return out
            kind = 1
        if kind == 1:                                   # drop
            return s[:i] + s[i + 1:]
        sub = self._SUBS[rng.randint(len(self._SUBS))]  # substitution
        while sub == s[i]:
            sub = self._SUBS[rng.randint(len(self._SUBS))]
        return s[:i] + sub + s[i + 1:]


class OutlierInjector(Injector):
    """Numeric outliers: scale the value far outside the column's range
    (sign flips included), the BoostClean numeric-corruption family."""

    name = "outlier"

    _FACTORS = (13.0, -11.0, 47.0, 101.0)

    def corrupt(self, value, column, df, rng):
        base = float(value)
        factor = self._FACTORS[rng.randint(len(self._FACTORS))]
        shift = float(df[column].abs().max() or 1.0)
        return base * factor + shift * (3.0 if factor > 0 else -3.0)


class SwapInjector(Injector):
    """Swaps the values of two rows in the same column — both cells are
    wrong afterwards and both land in the injected set."""

    name = "swap"

    def apply(self, dirty, clean, rng, taken, row_id):
        injected: Dict[Cell, Any] = {}
        tids = clean[row_id].astype(str).tolist()
        for column in self.columns:
            rows = _eligible_rows(dirty, column, taken, row_id)
            if len(rows) < 2:
                continue
            pairs = max(1, int(round(self.rate * len(rows) / 2)))
            values = clean[column].to_numpy()
            writes: Dict[int, Any] = {}
            for _ in range(pairs):
                if len(rows) < 2:
                    break
                a_idx, b_idx = rng.choice(len(rows), size=2,
                                          replace=False).tolist()
                a, b = rows[a_idx], rows[b_idx]
                va, vb = values[a], values[b]
                # remove both from the candidate pool either way; identical
                # values would make the "corruption" a no-op lie
                rows.remove(a)
                rows.remove(b)
                if va == vb:
                    continue
                writes[a], writes[b] = vb, va
                for i, old in ((a, va), (b, vb)):
                    cell = (tids[i], column)
                    taken.add(cell)
                    injected[cell] = old
            _write(dirty, column, writes)
        return injected


class FDViolationInjector(Injector):
    """FD-violating correlated corruption: for a planted dependency
    ``lhs -> rhs_columns``, rewrite a row's rhs cells with the rhs values
    of a donor row whose lhs differs — every touched cell then disagrees
    with what the dependency demands, and the corruption is *correlated
    across attributes* (the escalation joint tier's home turf)."""

    name = "fd_violation"

    def __init__(self, lhs: str, rhs_columns: Sequence[str],
                 rate: float = 0.05):
        super().__init__(rhs_columns, rate)
        self.lhs = lhs

    def apply(self, dirty, clean, rng, taken, row_id):
        injected: Dict[Cell, Any] = {}
        tids = clean[row_id].astype(str).tolist()
        lhs_vals = clean[self.lhs].astype(str).to_numpy(dtype=object)
        # rows where EVERY rhs cell is still free — a half-corrupted row
        # would break the no-double-corruption invariant
        free = np.ones(len(clean), dtype=bool)
        for c in self.columns:
            free &= dirty[c].notna().to_numpy()
            free &= np.array([(t, c) not in taken for t in tids],
                             dtype=bool)
        rows = np.flatnonzero(free)
        if len(rows) < 2:
            return injected
        k = max(1, int(round(self.rate * len(rows))))
        picked = sorted(rng.choice(len(rows), size=min(k, len(rows)),
                                   replace=False).tolist())
        # the donors of a row are the free rows whose lhs differs, in frame
        # order: one array per lhs value (the JAX package rebuilds that
        # list for each picked row)
        row_lhs = lhs_vals[rows]
        donors_of: Dict[str, np.ndarray] = {}
        values = {c: clean[c].to_numpy() for c in self.columns}
        writes: Dict[str, Dict[int, Any]] = {c: {} for c in self.columns}
        for p in picked:
            i = int(rows[p])
            donors = donors_of.get(lhs_vals[i])
            if donors is None:
                donors = donors_of[lhs_vals[i]] = rows[row_lhs != lhs_vals[i]]
            if not len(donors):
                continue
            d = int(donors[rng.randint(len(donors))])
            for column in self.columns:
                old, new = values[column][i], values[column][d]
                if old == new:
                    continue
                cell = (tids[i], column)
                writes[column][i] = new
                taken.add(cell)
                injected[cell] = old
        for column in self.columns:
            _write(dirty, column, writes[column])
        return injected


def inject(clean: pd.DataFrame, injectors: Sequence[Injector], seed: int,
           row_id: str = "tid") -> Tuple[pd.DataFrame, Dict[Cell, Any]]:
    """Runs the injector stack over a copy of ``clean`` and returns
    ``(dirty, truth)`` where ``truth`` maps every injected ``(tid,
    attribute)`` cell to its clean value. Injector order matters (earlier
    injectors claim cells first); each injector draws from its own seeded
    stream so the composition is deterministic as a whole."""
    dirty = clean.copy()
    taken: set = set()
    truth: Dict[Cell, Any] = {}
    for idx, injector in enumerate(injectors):
        rng = _stream(seed + idx, injector.name)
        hits = injector.apply(dirty, clean, rng, taken, row_id)
        overlap = set(hits) & set(truth)
        if overlap:     # taken-set bug guard: never corrupt a cell twice
            raise AssertionError(f"cells corrupted twice: {sorted(overlap)}")
        truth.update(hits)
    return dirty, truth
