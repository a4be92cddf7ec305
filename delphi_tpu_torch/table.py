"""Core table layer: dictionary-encoded columnar tables.

A host-only copy of the JAX package's table layer (codes, vocabularies
and kinds must be identical across the two packages): every attribute is
dictionary-encoded into an ``int32`` code column (NULL = -1), which the
statistics kernels consume on the device.
"""

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import os

import numpy as np
import pandas as pd

from delphi_tpu_torch.session import AnalysisException
from delphi_tpu_torch.utils import setup_logger
from delphi_tpu_torch.utils.native import get_dict_encoder

_logger = setup_logger()

# Type kinds, mirroring the reference's whitelist (RepairBase.scala:41-44):
# integral+fractional are "continuous", strings are "discrete"; anything else
# is unsupported.
KIND_STRING = "string"
KIND_INTEGRAL = "integral"
KIND_FRACTIONAL = "fractional"

NULL_CODE = -1

def column_kind(series: pd.Series) -> str:
    dt = series.dtype
    if pd.api.types.is_bool_dtype(dt):
        raise AnalysisException(
            "Supported types are tinyint,smallint,int,bigint,float,double,string, but "
            "unsupported ones found: boolean")
    if pd.api.types.is_integer_dtype(dt):
        return KIND_INTEGRAL
    if pd.api.types.is_float_dtype(dt):
        return KIND_FRACTIONAL
    if pd.api.types.is_object_dtype(dt) or pd.api.types.is_string_dtype(dt):
        return KIND_STRING
    raise AnalysisException(
        "Supported types are tinyint,smallint,int,bigint,float,double,string, but "
        f"unsupported ones found: {dt}")


def normalize_neg_zero(values: np.ndarray) -> np.ndarray:
    """Folds -0.0 into +0.0 in float arrays. Hash-based paths (factorize,
    nunique) already treat the two as one value; normalizing before encoding
    pins the SPELLING to '0.0' regardless of which appeared first, instead of
    letting a leading -0.0 name the merged vocab entry '-0.0'."""
    if values.dtype.kind == "f":
        return np.where(values == 0.0, 0.0, values)
    return values


def _value_strings(series: pd.Series, kind: str) -> np.ndarray:
    """String representation of values, matching SQL CAST(x AS STRING).

    Formats via the DISTINCT values (factorize, then ``str()`` each unique)
    so the per-cell cost is a C-speed hash pass instead of a Python lambda
    per row — ``str(int)`` / ``str(float)`` are injective on the raw values
    (after -0.0 normalization, see ``normalize_neg_zero``), so
    first-appearance order and the produced strings are identical to the
    per-row path. Plain-string columns pass through with only NULL masking;
    object columns holding non-str values keep the exact per-row ``str()``
    semantics (distinct objects with equal string forms must still merge)."""
    if kind in (KIND_INTEGRAL, KIND_FRACTIONAL):
        codes, uniques = pd.factorize(normalize_neg_zero(series.to_numpy()),
                                      use_na_sentinel=True)
        cast = (lambda v: str(int(v))) if kind == KIND_INTEGRAL \
            else (lambda v: str(float(v)))
        lut = np.array([cast(v) for v in uniques], dtype=object)
        out = np.empty(len(codes), dtype=object)
        valid = codes >= 0
        out[valid] = lut[codes[valid]]
        out[~valid] = None
        return out
    if pd.api.types.infer_dtype(series, skipna=True) in ("string", "empty"):
        # to_numpy copies when it applies na_value, so the source series'
        # buffer is never mutated
        return series.to_numpy(dtype=object, na_value=None)
    return series.map(_cast_object_value).to_numpy(dtype=object)


def _cast_object_value(v: Any) -> Optional[str]:
    """SQL CAST(x AS STRING) for a boxed value in an object column: numerics
    widen through int/float (np.float32(0.1) spells as the double
    '0.10000000149011612', not '0.1'), matching what the value would have
    spelled in a properly typed column."""
    if pd.isna(v):
        return None
    if isinstance(v, (bool, np.bool_)):
        return str(int(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return str(float(v))
    return str(v)


@dataclass
class EncodedColumn:
    """One dictionary-encoded attribute.

    ``codes`` holds int32 dictionary codes (−1 for NULL) into ``vocab`` — the
    distinct value strings in first-appearance order. Numeric attributes also
    retain a float64 view (NaN for NULL) for regression / outlier kernels.
    """

    name: str
    kind: str
    codes: np.ndarray
    vocab: np.ndarray
    numeric: Optional[np.ndarray] = None

    @property
    def domain_size(self) -> int:
        """# of distinct non-NULL values (Catalyst column-stat distinctCount)."""
        return int(len(self.vocab))

    @property
    def is_numeric(self) -> bool:
        return self.kind in (KIND_INTEGRAL, KIND_FRACTIONAL)

    def null_mask(self) -> np.ndarray:
        return self.codes == NULL_CODE

    def decode(self, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Back to an object array of value strings (None for NULL).

        ``rows`` selects a positional subset (in the given order) without
        materializing the full column — the backbone of the phase-2/3
        "decode only what you train on / repair" path."""
        codes = self.codes if rows is None else self.codes[rows]
        out = np.empty(len(codes), dtype=object)
        valid = codes >= 0
        out[valid] = self.vocab[codes[valid]]
        out[~valid] = None
        return out


def encode_column(series: pd.Series, name: Optional[str] = None) -> EncodedColumn:
    """Dictionary-encodes one attribute.

    Numeric columns factorize the RAW values in one C hash pass and only
    format the (small) set of distinct values to strings — ``str(int)`` /
    ``str(float)`` are injective on the raw values, so codes and
    first-appearance order match encoding the formatted strings. String
    columns factorize their cast strings. The native C++ encoder is opt-in
    (``DELPHI_NATIVE_ENCODE=1``): its per-value ctypes marshalling costs
    more than pandas' vectorized hash table at millions of rows.
    """
    kind = column_kind(series)
    if kind in (KIND_INTEGRAL, KIND_FRACTIONAL):
        codes, raw_uniques = pd.factorize(normalize_neg_zero(series.to_numpy()),
                                          use_na_sentinel=True)
        cast = (lambda v: str(int(v))) if kind == KIND_INTEGRAL \
            else (lambda v: str(float(v)))
        uniques: Any = np.array([cast(v) for v in raw_uniques], dtype=object)
    else:
        strings = _value_strings(series, kind)
        encoder = get_dict_encoder() \
            if os.environ.get("DELPHI_NATIVE_ENCODE") == "1" else None
        if encoder is not None:
            codes, uniques = encoder.encode(strings.tolist())
        else:
            codes, uniques = pd.factorize(strings, use_na_sentinel=True)
    col = EncodedColumn(
        name=name or str(series.name),
        kind=kind,
        codes=np.asarray(codes, dtype=np.int32),
        vocab=np.asarray(uniques, dtype=object),
    )
    if kind in (KIND_INTEGRAL, KIND_FRACTIONAL):
        col.numeric = normalize_neg_zero(
            pd.to_numeric(series, errors="coerce").to_numpy(dtype=np.float64))
    return col


@dataclass
class EncodedTable:
    """A row-id column plus dictionary-encoded attribute columns.

    Each column's int32 codes (NULL = -1) upload once to the device
    (:mod:`delphi_tpu_torch.ops.xfer`).
    """

    row_id: str
    row_id_values: np.ndarray
    row_id_kind: str
    columns: List[EncodedColumn] = field(default_factory=list)

    @property
    def n_rows(self) -> int:
        return int(len(self.row_id_values))

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> EncodedColumn:
        for c in self.columns:
            if c.name == name:
                return c
        raise AnalysisException(f"Column '{name}' not found")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def codes(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        cols = [self.column(n) for n in names] if names is not None else self.columns
        if not cols:
            return np.zeros((self.n_rows, 0), dtype=np.int32)
        return np.stack([c.codes for c in cols], axis=1)

    def domain_stats(self) -> Dict[str, int]:
        return {c.name: c.domain_size for c in self.columns}

    def continuous_columns(self) -> List[str]:
        return [c.name for c in self.columns if c.is_numeric]

    def value_string(self, name: str, row: int) -> Optional[str]:
        c = self.column(name)
        code = int(c.codes[row])
        return None if code == NULL_CODE else str(c.vocab[code])

    def row_index(self) -> Dict[object, int]:
        return {rid: i for i, rid in enumerate(self.row_id_values.tolist())}

    def to_pandas(self, rows: Optional[np.ndarray] = None,
                  columns: Optional[Sequence[str]] = None,
                  integral_as_float: Optional[Sequence[str]] = None) -> pd.DataFrame:
        """Decode to a pandas frame with original dtypes (numeric restored).

        ``rows`` (positional, order-preserving) and ``columns`` decode only a
        subset. Dtype restoration is decided on the FULL column — an integral
        column decodes to int64 only when the whole column is NaN-free — so a
        subset frame carries the same dtypes the full decode would, however
        the subset happens to look. ``integral_as_float``, when given (even
        empty), is the caller's COMPLETE float-forcing decision — integral
        columns named in it decode as float64, the rest as int64 with no
        per-call NaN re-scan. Callers that snapshot dtypes once and then
        decode many subsets (phase 2-3 training samples, chunked repair)
        compute it up front; passing None falls back to scanning each
        integral column for NaNs here."""
        data: Dict[str, object] = {
            self.row_id: self.row_id_values if rows is None
            else self.row_id_values[rows]}
        force_float = None if integral_as_float is None \
            else set(integral_as_float)
        cols = self.columns if columns is None \
            else [self.column(n) for n in columns]
        for c in cols:
            if c.is_numeric:
                assert c.numeric is not None
                numeric = c.numeric if rows is None else c.numeric[rows]
                as_int = c.kind == KIND_INTEGRAL and (
                    c.name not in force_float if force_float is not None
                    else not np.isnan(c.numeric).any())
                if as_int:
                    data[c.name] = numeric.astype(np.int64)
                else:
                    data[c.name] = numeric
            else:
                data[c.name] = c.decode(rows)
        return pd.DataFrame(data)

    def take_rows(self, positions: np.ndarray) -> "EncodedTable":
        """A positional row-subset copy (rows in the given order), the
        incremental plane's "re-run only the planned rows" table.

        Vocabularies carry over unchanged: a subset column may hold unused
        vocab entries, which consumers tolerate (class counts and domains
        come from the codes present). Each subset column is a new object,
        so the device codes cached on a parent column never serve it."""
        positions = np.asarray(positions, dtype=np.int64)
        new_columns = [
            replace(
                c,
                codes=np.ascontiguousarray(c.codes[positions]),
                numeric=np.ascontiguousarray(c.numeric[positions])
                if c.numeric is not None else None)
            for c in self.columns]
        return replace(self, row_id_values=self.row_id_values[positions],
                       columns=new_columns)

    def with_updates(self, cells: Sequence[Tuple[int, str, Any]]) -> "EncodedTable":
        """Returns a copy with (row_index, attribute, value) cells updated —
        the encoded-tensor equivalent of applying rule repairs with
        `repairAttrsFrom` (RepairMiscApi.scala:184-247): continuous columns
        cast the repaired string to float (integral: rounded), and novel
        values extend the column vocab."""
        by_attr: Dict[str, List[Tuple[int, Any]]] = {}
        for row, attr, value in cells:
            by_attr.setdefault(attr, []).append((row, value))
        new_columns = []
        for c in self.columns:
            if c.name not in by_attr:
                new_columns.append(c)
                continue
            updates = by_attr[c.name]
            codes = c.codes.copy()
            numeric = c.numeric.copy() if c.numeric is not None else None
            vocab_index = {v: i for i, v in enumerate(c.vocab.tolist())}
            vocab_list = c.vocab.tolist()
            for row, value in updates:
                if value is None or (not isinstance(value, (list, dict))
                                     and pd.isna(value)):
                    codes[row] = NULL_CODE
                    if numeric is not None:
                        numeric[row] = np.nan
                    continue
                if c.kind == KIND_INTEGRAL:
                    num = float(np.round(float(value)))
                    if num == 0.0:
                        num = 0.0  # fold -0.0 (round(-0.4)) into +0.0
                    s = str(int(num))
                elif c.kind == KIND_FRACTIONAL:
                    num = float(value)
                    if num == 0.0:
                        num = 0.0  # same -0.0 fold as normalize_neg_zero
                    s = str(num)
                else:
                    num = None
                    s = str(value)
                if s not in vocab_index:
                    vocab_index[s] = len(vocab_list)
                    vocab_list.append(s)
                codes[row] = vocab_index[s]
                if numeric is not None:
                    numeric[row] = num
            new_columns.append(replace(
                c, codes=codes, numeric=numeric,
                vocab=np.asarray(vocab_list, dtype=object)))
        return replace(self, columns=new_columns)

    def with_nulls_at_arrays(self, rows: np.ndarray,
                             attrs: np.ndarray) -> "EncodedTable":
        """`with_nulls_at` over aligned (row positions, attribute) arrays:
        cells group per attribute through one factorize pass instead of a
        Python loop building tuples — at the 1e8-row scale the masking
        input is tens of millions of cells."""
        attr_codes, attr_uniques = pd.factorize(np.asarray(attrs, dtype=object))
        rows = np.asarray(rows, dtype=np.int64)
        by_attr: Dict[str, np.ndarray] = {
            str(a): rows[attr_codes == ai]
            for ai, a in enumerate(attr_uniques)}
        new_columns = []
        for c in self.columns:
            idx = by_attr.get(c.name)
            if idx is not None and len(idx):
                codes = c.codes.copy()
                codes[idx] = NULL_CODE
                numeric = None
                if c.numeric is not None:
                    numeric = c.numeric.copy()
                    numeric[idx] = np.nan
                new_columns.append(replace(c, codes=codes, numeric=numeric))
            else:
                new_columns.append(c)
        return replace(self, columns=new_columns)


def encode_table(df: pd.DataFrame, row_id: str) -> EncodedTable:
    if row_id not in df.columns:
        raise AnalysisException(f"Column '{row_id}' does not exist")
    table = EncodedTable(
        row_id=row_id,
        row_id_values=df[row_id].to_numpy(),
        row_id_kind=column_kind(df[row_id]),
    )
    for name in df.columns:
        if name == row_id:
            continue
        table.columns.append(encode_column(df[name], name))
    return table


def check_input_table(df: pd.DataFrame, row_id: str, qualified_name: str = "input") \
        -> Tuple[EncodedTable, List[str]]:
    """Input validation, mirroring `RepairApi.checkInputTable`
    (RepairApi.scala:34-67): type whitelist, ≥3 columns, row-id uniqueness.
    Returns the encoded table and the list of continuous (numeric) attributes.
    """
    for name in df.columns:
        column_kind(df[name])  # raises AnalysisException on unsupported types

    if len(df.columns) < 3:
        raise AnalysisException(
            f"A least three columns (`{row_id}` columns + two more ones) "
            f"in table '{qualified_name}'")

    if row_id not in df.columns:
        raise AnalysisException(f"Column '{row_id}' does not exist in '{qualified_name}'.")

    n_rows = len(df)
    n_distinct = df[row_id].nunique(dropna=False)
    if n_distinct != n_rows:
        raise AnalysisException(
            f"Uniqueness does not hold in column '{row_id}' of table '{qualified_name}' "
            f"(# of distinct '{row_id}': {n_distinct}, # of rows: {n_rows})")

    table = encode_table(df, row_id)
    return table, table.continuous_columns()


def check_encoded_table(table: EncodedTable, row_id: str,
                        qualified_name: str = "input") \
        -> Tuple[EncodedTable, List[str]]:
    """`check_input_table` for a pre-encoded table (chunked ingestion): same
    validations, no re-encode — the type whitelist already held at encode
    time, so only shape and row-id checks remain."""
    if table.row_id != row_id:
        raise AnalysisException(
            f"Column '{row_id}' does not exist in '{qualified_name}'.")
    if len(table.columns) < 2:
        raise AnalysisException(
            f"A least three columns (`{row_id}` columns + two more ones) "
            f"in table '{qualified_name}'")
    n_rows = table.n_rows
    n_distinct = len(pd.unique(table.row_id_values))
    if n_distinct != n_rows:
        raise AnalysisException(
            f"Uniqueness does not hold in column '{row_id}' of table "
            f"'{qualified_name}' (# of distinct '{row_id}': {n_distinct}, "
            f"# of rows: {n_rows})")
    return table, table.continuous_columns()


@dataclass
class DiscretizedTable:
    """The discretized view used by the stats engine.

    Continuous attributes are equi-width binned into ``[0, discrete_threshold]``
    (the reference truncates `int((v - min) / (max - min) * threshold)` so the
    max value lands in bin == threshold — `RepairApi.scala:139`); discrete
    attributes with domain size in (1, threshold] are kept as-is; everything
    else is dropped (`RepairApi.scala:126-149`).

    ``domain_stats`` intentionally records the ORIGINAL distinct counts (not
    bin counts) to match `convertToDiscretizedTable` (RepairApi.scala:151-169),
    which feeds those into entropy corrections and domain thresholds.
    """

    base: EncodedTable
    table: EncodedTable
    domain_stats: Dict[str, int]

    @property
    def column_names(self) -> List[str]:
        return self.table.column_names


def discretize_table(table: EncodedTable, discrete_threshold: int) -> DiscretizedTable:
    assert 2 <= discrete_threshold < 65536, "discreteThreshold should be in [2, 65536)."

    out_columns: List[EncodedColumn] = []
    domain_stats: Dict[str, int] = {}
    for c in table.columns:
        domain_stats[c.name] = c.domain_size
        if c.is_numeric:
            assert c.numeric is not None
            valid = ~np.isnan(c.numeric)
            any_valid = bool(valid.any())
            vmin = float(np.nanmin(c.numeric)) if any_valid else np.inf
            vmax = float(np.nanmax(c.numeric)) if any_valid else -np.inf
            if not any_valid:
                _logger.warning(f"'{c.name}' dropped because it has no non-NULL value")
                continue
            width = vmax - vmin
            bins = np.full(table.n_rows, NULL_CODE, dtype=np.int64)
            if width > 0.0:
                scaled = (c.numeric[valid] - vmin) / width * discrete_threshold
                bins[valid] = scaled.astype(np.int64)
            else:
                bins[valid] = 0
            # Re-encode bins compactly: vocab entries are the bin values as
            # strings (what CAST(int AS STRING) would yield in the
            # reference); codes index the sorted present bins.
            present = np.unique(bins[bins >= 0])
            codes = np.where(bins >= 0, np.searchsorted(present, bins),
                             NULL_CODE).astype(np.int32)
            vocab = np.asarray([str(int(b)) for b in present], dtype=object)
            out_columns.append(EncodedColumn(name=c.name, kind=KIND_STRING,
                                             codes=codes, vocab=vocab))
        elif 1 < c.domain_size <= discrete_threshold:
            out_columns.append(c)
        else:
            _logger.warning(
                f"'{c.name}' dropped because of its unsuitable domain (size={c.domain_size})")

    discretized = EncodedTable(
        row_id=table.row_id,
        row_id_values=table.row_id_values,
        row_id_kind=table.row_id_kind,
        columns=out_columns,
    )
    return DiscretizedTable(base=table, table=discretized, domain_stats=domain_stats)
