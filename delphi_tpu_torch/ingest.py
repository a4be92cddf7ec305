"""Chunked CSV -> EncodedTable ingestion (the batch CLI's ``--chunksize``).

The session catalog holds pandas frames, which is fine up to millions of
rows; past that a full object-dtype frame is the memory wall.
`read_csv_encoded` streams the file in chunks and dictionary-encodes each
column incrementally: per chunk, values factorize against the growing
global vocabulary, so peak memory is one chunk of strings plus the int32
code columns. The codes and vocabularies equal those of encoding the whole
frame at once. Host-only code.
"""

from typing import Dict, Iterable, List, Optional

import numpy as np
import pandas as pd

from delphi_tpu_torch.session import AnalysisException
from delphi_tpu_torch.table import (
    EncodedColumn, EncodedTable, KIND_FRACTIONAL, KIND_INTEGRAL, KIND_STRING,
    column_kind, _value_strings)
from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()


class _IncrementalEncoder:
    """Dictionary encoder whose vocabulary grows across chunks."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.kind: Optional[str] = None
        self.vocab: Dict[str, int] = {}
        self.code_chunks: List[np.ndarray] = []
        self.numeric_chunks: List[np.ndarray] = []

    def add(self, series: pd.Series) -> None:
        # All-null chunks carry no dtype evidence (pandas infers float64):
        # they match whatever the column turns out to be.
        all_null = bool(series.isna().all())
        kind = None if all_null else column_kind(series)
        if kind is not None:
            if self.kind is None:
                self.kind = kind
            elif self.kind != kind:
                if {self.kind, kind} == {KIND_INTEGRAL, KIND_FRACTIONAL}:
                    # whole-file inference would have made this float64; the
                    # integral-formatted vocab entries already handed out
                    # ("1") must become their fractional spellings ("1.0")
                    # so earlier chunks' codes keep pointing at the value
                    # they encoded. Beyond 2^53 the float cast is lossy and
                    # distinct ints can respell identically — exactly the
                    # values float64 whole-file inference would merge — so
                    # colliding codes are remapped in the emitted chunks.
                    if self.kind == KIND_INTEGRAL:
                        new_vocab: Dict[str, int] = {}
                        remap_old = np.empty(len(self.vocab), np.int32)
                        for k, c in self.vocab.items():
                            nk = str(float(int(k)))
                            nc = new_vocab.setdefault(nk, len(new_vocab))
                            remap_old[c] = nc
                        if len(new_vocab) != len(self.vocab):
                            self.code_chunks = [
                                np.where(ch >= 0,
                                         remap_old[np.maximum(ch, 0)],
                                         ch).astype(np.int32)
                                for ch in self.code_chunks]
                        self.vocab = new_vocab
                    self.kind = KIND_FRACTIONAL
                else:
                    raise AnalysisException(
                        f"Column '{self.name}' changes dtype across chunks "
                        f"({self.kind} -> {kind}); read the CSV with "
                        "dtype=str (the default of read_csv_encoded) or a "
                        "uniform per-column dtype")
        # format with the RESOLVED kind, not the chunk's: an integral chunk
        # arriving after the column resolved fractional must spell 1 as "1.0"
        strings = _value_strings(series, self.kind or "string")
        # factorize the chunk locally, then remap chunk codes through the
        # global vocabulary — one dict lookup per DISTINCT chunk value
        local_codes, local_vocab = pd.factorize(strings, use_na_sentinel=True)
        if len(local_vocab) == 0:  # all-NULL chunk
            codes = np.full(len(strings), -1, dtype=np.int32)
        else:
            remap = np.empty(len(local_vocab), dtype=np.int32)
            for i, v in enumerate(local_vocab):
                code = self.vocab.get(v)
                if code is None:
                    code = len(self.vocab)
                    self.vocab[v] = code
                remap[i] = code
            codes = np.where(local_codes >= 0,
                             remap[np.maximum(local_codes, 0)],
                             np.int32(-1)).astype(np.int32)
        self.code_chunks.append(codes)
        # numeric view kept for numeric-typed and all-null chunks (NaN); once
        # the column resolves string the view is dead — stop converting
        # instead of accumulating float64 arrays finish() would discard. A
        # kind conflict raised above, so codes and numeric stay row-aligned.
        if self.kind == KIND_STRING:
            self.numeric_chunks = []
        elif kind in (KIND_INTEGRAL, KIND_FRACTIONAL) or kind is None:
            self.numeric_chunks.append(
                pd.to_numeric(series, errors="coerce").to_numpy(np.float64))
        else:
            self.numeric_chunks = []

    def finish(self) -> EncodedColumn:
        kind = self.kind or "string"  # an entirely-null column
        codes = np.concatenate(self.code_chunks) if self.code_chunks \
            else np.zeros(0, np.int32)
        numeric = None
        if kind in (KIND_INTEGRAL, KIND_FRACTIONAL):
            assert len(self.numeric_chunks) == len(self.code_chunks)
            numeric = np.concatenate(self.numeric_chunks)
        return EncodedColumn(
            name=self.name, kind=kind, codes=codes,
            vocab=np.array(list(self.vocab.keys()), dtype=object),
            numeric=numeric)


def encode_table_chunked(chunks: Iterable[pd.DataFrame],
                         row_id: str) -> EncodedTable:
    """Builds an EncodedTable from an iterable of pandas chunks without ever
    materializing the full object-dtype frame."""
    encoders: Dict[str, _IncrementalEncoder] = {}
    row_ids: List[np.ndarray] = []
    row_id_kind: Optional[str] = None
    order: List[str] = []
    for chunk in chunks:
        if row_id not in chunk.columns:
            raise AnalysisException(f"Column '{row_id}' does not exist")
        counter_inc("ingest.chunks")
        counter_inc("ingest.rows", len(chunk))
        row_ids.append(chunk[row_id].to_numpy())
        if row_id_kind is None:
            row_id_kind = column_kind(chunk[row_id])
            order = [c for c in chunk.columns if c != row_id]
        for name in order:
            encoders.setdefault(name, _IncrementalEncoder(name)) \
                .add(chunk[name])
    assert row_id_kind is not None, "no chunks provided"
    table = EncodedTable(
        row_id=row_id,
        row_id_values=np.concatenate(row_ids),
        row_id_kind=row_id_kind,
        columns=[encoders[name].finish() for name in order])
    _logger.info(
        f"Chunked ingestion: {table.n_rows} rows x "
        f"{len(table.columns)} columns encoded")
    return table


def read_csv_encoded(path: str, row_id: str,
                     chunksize: int = 1_000_000, **read_kwargs) -> EncodedTable:
    """Streams a CSV into an EncodedTable, `chunksize` rows at a time.

    Columns read as strings by default (chunk-local dtype inference would
    let the same column flip types between chunks); pass ``dtype`` to type
    numeric columns explicitly, exactly as the repair example workloads do
    for pandas reads."""
    read_kwargs.setdefault("dtype", str)
    reader = pd.read_csv(path, chunksize=chunksize, **read_kwargs)
    return encode_table_chunked(reader, row_id)
