"""ctypes bindings for the repo's native C++ helpers (see `native/`).

The shared library provides batch Levenshtein distance (cost-weighted
PMFs and nearest-value repairs), dictionary encoding (ingestion) and
hashed q-gram featurization (input splitting). It is loaded lazily from
``native/build``; when it has not been built, callers take their
pure-Python paths, whose output is identical. Host-only code.
"""

import ctypes
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

_LIB_NAMES = ("libdelphi_native.so",)


def _find_library() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name in _LIB_NAMES:
        for sub in ("native/build", "native"):
            path = os.path.join(here, sub, name)
            if os.path.exists(path):
                return path
    return None


@lru_cache(maxsize=None)
def _shared_lib() -> Optional[ctypes.CDLL]:
    path = _find_library()
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


# Each get_* accessor returns None when the library is missing or lacks
# the symbol, never raises, so callers fall back with a plain `get_*()`.

@lru_cache(maxsize=None)
def get_levenshtein() -> Optional["NativeLevenshtein"]:
    lib = _shared_lib()
    try:
        return NativeLevenshtein(lib) if lib is not None else None
    except AttributeError:
        return None


@lru_cache(maxsize=None)
def get_dict_encoder() -> Optional["NativeDictEncoder"]:
    lib = _shared_lib()
    try:
        return NativeDictEncoder(lib) if lib is not None else None
    except AttributeError:
        return None


@lru_cache(maxsize=None)
def get_qgram() -> Optional["NativeQGram"]:
    lib = _shared_lib()
    try:
        return NativeQGram(lib) if lib is not None else None
    except AttributeError:
        return None


def _u32(s: str) -> Tuple["ctypes.Array", int]:
    """str -> uint32 codepoint array (Python `str` semantics, not UTF-8
    bytes: 'café' has length 4)."""
    buf = s.encode("utf-32-le", "surrogatepass")
    n = len(buf) // 4
    return (ctypes.c_uint32 * max(n, 1)).from_buffer_copy(buf or b"\0\0\0\0"), n


class NativeLevenshtein:
    """Batch edit distances over Unicode codepoints via the C++ kernel."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        u32p = ctypes.POINTER(ctypes.c_uint32)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.delphi_levenshtein.restype = ctypes.c_int
        lib.delphi_levenshtein.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
        lib.delphi_levenshtein_batch.restype = None
        lib.delphi_levenshtein_batch.argtypes = [
            u32p, ctypes.c_int, u32p, intp, intp, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]

    def distance(self, x: str, y: str) -> int:
        xa, lx = _u32(x)
        ya, ly = _u32(y)
        return int(self._lib.delphi_levenshtein(xa, lx, ya, ly))

    def batch_distance(self, x: str, ys: Sequence[object]) -> List[Optional[float]]:
        n = len(ys)
        offs = (ctypes.c_int * n)()
        lens = (ctypes.c_int * n)()
        chunks = []
        pos = 0
        for i, y in enumerate(ys):
            if y:
                cp = str(y).encode("utf-32-le", "surrogatepass")
                offs[i] = pos
                lens[i] = len(cp) // 4
                chunks.append(cp)
                pos += lens[i]
            else:
                offs[i] = 0
                lens[i] = -1
        flat_buf = b"".join(chunks) or b"\0\0\0\0"
        flat = (ctypes.c_uint32 * max(pos, 1)).from_buffer_copy(flat_buf)
        xa, lx = _u32(x)
        out = (ctypes.c_double * n)()
        self._lib.delphi_levenshtein_batch(xa, lx, flat, offs, lens, n, out)
        return [float(out[i]) if lens[i] >= 0 else None for i in range(n)]


class NativeDictEncoder:
    """First-appearance-order dictionary encoding via the C++ hash table —
    bit-compatible with `pandas.factorize(use_na_sentinel=True)`."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.delphi_dict_encode.restype = ctypes.c_int
        lib.delphi_dict_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]

    def encode(self, values: Sequence[Optional[str]]) \
            -> Tuple[np.ndarray, np.ndarray]:
        """(codes int32[n] with NULL=-1, vocab object[n_distinct])."""
        n = len(values)
        if n == 0:
            return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=object)
        is_null = np.zeros(n, dtype=np.uint8)
        chunks: List[bytes] = []
        offsets = np.zeros(n + 1, dtype=np.int64)
        pos = 0
        for i, v in enumerate(values):
            if v is None or v is pd.NA or (isinstance(v, float) and v != v):
                is_null[i] = 1
            else:
                b = str(v).encode("utf-8", "surrogatepass")
                chunks.append(b)
                pos += len(b)
            offsets[i + 1] = pos
        flat = b"".join(chunks)
        codes = np.zeros(n, dtype=np.int32)
        first_idx = np.zeros(n, dtype=np.int64)
        n_distinct = self._lib.delphi_dict_encode(
            flat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            is_null.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            first_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if n_distinct < 0:
            raise RuntimeError("native dict encode failed")
        vocab = np.empty(n_distinct, dtype=object)
        for c in range(n_distinct):
            vocab[c] = values[first_idx[c]]
        return codes, vocab


class NativeQGram:
    """Hashed bag-of-q-grams (FNV-1a over codepoints) via the C++ kernel."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.delphi_qgram_features.restype = None
        lib.delphi_qgram_features.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]

    def features(self, values: Sequence[Optional[str]],
                 row_of_value: Sequence[int], n_rows: int, q: int,
                 feature_dim: int) -> np.ndarray:
        n_values = len(values)
        offs = np.zeros(n_values, dtype=np.int64)
        lens = np.zeros(n_values, dtype=np.int64)
        rows = np.asarray(row_of_value, dtype=np.int64)
        chunks: List[bytes] = []
        pos = 0
        for i, v in enumerate(values):
            if v is None:
                lens[i] = -1
            else:
                cp = v.encode("utf-32-le", "surrogatepass")
                offs[i] = pos
                lens[i] = len(cp) // 4
                chunks.append(cp)
                pos += lens[i]
        flat_buf = b"".join(chunks) or b"\0\0\0\0"
        flat = np.frombuffer(flat_buf, dtype=np.uint32).copy()
        out = np.zeros((n_rows, feature_dim), dtype=np.float32)
        self._lib.delphi_qgram_features(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_values, q, feature_dim,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
