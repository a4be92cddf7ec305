"""K1 ``pair_counts``: co-occurrence count matrices of code-column pairs.

Replaces the JAX package's Pallas kernel ``_pair_count_kernel``
(``delphi_tpu/ops/pallas_kernels.py``). For pair p = (x, y) over a code
matrix ``codes[m, n]`` (int32, NULL = -1), the result is the int32 matrix
``[vx+1, vy+1]`` whose slot (a+1, b+1) counts the rows with x = a and y = b
(slot 0 is NULL). All pairs' matrices come back flattened into one int32
buffer; ``offsets[p]:offsets[p+1]`` is pair p's row-major matrix.

A CUDA tensor goes to the hand kernel (``csrc/pair_counts.cu``), a CPU
tensor to :func:`pair_counts_plain`, the fused-key ``torch.bincount`` the
kernel is held against.

Launch planning is pure Python (:func:`plan_launches`): the pairs split,
in order, into launches of at most :data:`MAX_PAIRS` pairs over at most
:data:`MAX_COLS` distinct columns, whose parameter table
(:class:`PairTable`) goes to the kernel by value. A call with more pairs
makes several launches, and each counts. Nothing in a call copies to or
waits for the device.
"""

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel since the last reset (read by the chip smoke
# test to prove the main path went through the kernel). Requests served in
# threads launch side by side, so the count moves under a lock.
launches = 0
_count_lock = threading.Lock()

THREADS = 256                 # threads per block (csrc: kThreads)
MAX_PAIRS = 128               # pairs per launch (csrc: kMaxPairs)
MAX_COLS = 16                 # distinct columns per launch (csrc: kMaxCols)
ROWS_PER_THREAD = 4           # one int4 per column per thread and tile
# two stage buffers of one int4 per thread and column
STAGE_BYTES_PER_COL = 2 * THREADS * 16
# One shared histogram per block of at most BLOCK_HIST_BYTES; pairs beyond
# that count with global atomics.
BLOCK_HIST_BYTES = 96 * 1024
# Persistent grid: at most BLOCKS_PER_SM blocks per SM, fewer when the
# block's shared memory leaves room for fewer (SMEM_PER_SM bytes an SM
# shares out, 1 KB of it reserved per block).
BLOCKS_PER_SM = 4
SMEM_PER_SM = 228 * 1024


def reset_launches() -> None:
    global launches
    launches = 0


class PairEntry(ctypes.Structure):
    """One pair of a launch; the layout of ``PairEntry`` in
    ``csrc/pair_counts.cu`` (24 bytes)."""
    _fields_ = [("out_off", ctypes.c_int64), ("smem_off", ctypes.c_int32),
                ("wy", ctypes.c_int32), ("bins", ctypes.c_int32),
                ("xs", ctypes.c_uint8), ("ys", ctypes.c_uint8),
                ("pad", ctypes.c_uint16)]


class PairTable(ctypes.Structure):
    """A launch's parameters, passed to the kernel by value; the layout of
    ``PairTable`` in ``csrc/pair_counts.cu`` (3,176 bytes)."""
    _fields_ = [("codes", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n_rows", ctypes.c_int64), ("n_pairs", ctypes.c_int32),
                ("n_cols", ctypes.c_int32), ("hist_bins", ctypes.c_int32),
                ("pad", ctypes.c_int32),
                ("cols", ctypes.c_int32 * MAX_COLS),
                ("pairs", PairEntry * MAX_PAIRS)]


@dataclass(frozen=True)
class Launch:
    """One launch: pairs ``[first, stop)`` of the call, the code columns it
    reads (slot order), and its shared-memory plan."""
    first: int
    stop: int
    cols: Tuple[int, ...]
    smem_off: Tuple[int, ...]     # per pair; -1 = global-atomic route
    hist_bins: int

    @property
    def smem_bytes(self) -> int:
        return len(self.cols) * STAGE_BYTES_PER_COL + 4 * self.hist_bins


def matrix_offsets(pairs: Sequence[Tuple[int, int]],
                   vocab: Sequence[int]) -> np.ndarray:
    """int64 [P+1] element offsets of each pair's [vx+1, vy+1] matrix in the
    flat output."""
    sizes = [(vocab[x] + 1) * (vocab[y] + 1) for x, y in pairs]
    return np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]) \
        .astype(np.int64)


def group_pairs(pairs: Sequence[Tuple[int, int]], max_pairs: int = MAX_PAIRS,
                max_cols: int = MAX_COLS) -> List[Tuple[int, int]]:
    """Cuts ``pairs``, in order, into ranges ``[first, stop)`` of at most
    ``max_pairs`` pairs over at most ``max_cols`` distinct columns."""
    groups: List[Tuple[int, int]] = []
    first, cols = 0, set()
    for p, (x, y) in enumerate(pairs):
        grown = cols | {x, y}
        if p > first and (p - first >= max_pairs or len(grown) > max_cols):
            groups.append((first, p))
            first, grown = p, {x, y}
        cols = grown
    if len(pairs) > first:
        groups.append((first, len(pairs)))
    return groups


def _shared_plan(sizes: Sequence[int]) -> Tuple[Tuple[int, ...], int]:
    """(smem_off per pair, bins): the smallest matrices first into one
    block histogram of at most BLOCK_HIST_BYTES."""
    smem_off = [-1] * len(sizes)
    used = 0
    for p in sorted(range(len(sizes)), key=lambda i: (sizes[i], i)):
        if 4 * (used + sizes[p]) > BLOCK_HIST_BYTES:
            break
        smem_off[p] = used
        used += sizes[p]
    return tuple(smem_off), used


@functools.lru_cache(maxsize=64)
def plan_launches(pairs: Tuple[Tuple[int, int], ...],
                  vocab: Tuple[int, ...]) -> Tuple[Launch, ...]:
    """The launches of one call (pure Python; cached by its arguments)."""
    launches_: List[Launch] = []
    for first, stop in group_pairs(pairs):
        group = pairs[first:stop]
        cols = tuple(dict.fromkeys(c for p in group for c in p))
        sizes = [(vocab[x] + 1) * (vocab[y] + 1) for x, y in group]
        smem_off, bins = _shared_plan(sizes)
        launches_.append(Launch(first, stop, cols, smem_off, bins))
    return tuple(launches_)


@functools.lru_cache(maxsize=64)
def _prepare(pairs: Tuple[Tuple[int, int], ...], vocab: Tuple[int, ...]) \
        -> Tuple[np.ndarray, Tuple[Tuple[Launch, bytes], ...]]:
    """What a call needs beyond its pointers (cached by its arguments): the
    output offsets (read-only) and each launch with its :class:`PairTable`,
    filled but for the pointers and ``n_rows``."""
    offsets = matrix_offsets(pairs, vocab)
    if int(np.diff(offsets).max(initial=0)) >= 1 << 31:
        raise ValueError("pair_counts: a pair's matrix must hold fewer than "
                         "2^31 bins")
    offsets.flags.writeable = False
    out = []
    for ln in plan_launches(pairs, vocab):
        t = PairTable()
        t.n_pairs = ln.stop - ln.first
        t.n_cols = len(ln.cols)
        t.hist_bins = ln.hist_bins
        t.cols[:len(ln.cols)] = ln.cols
        slot = {c: i for i, c in enumerate(ln.cols)}
        ent = np.ctypeslib.as_array(t.pairs)
        group = pairs[ln.first:ln.stop]
        k = len(group)
        ent["out_off"][:k] = offsets[ln.first:ln.stop]
        ent["smem_off"][:k] = ln.smem_off
        ent["wy"][:k] = [vocab[y] + 1 for _, y in group]
        ent["bins"][:k] = np.diff(offsets[ln.first:ln.stop + 1])
        ent["xs"][:k] = [slot[x] for x, _ in group]
        ent["ys"][:k] = [slot[y] for _, y in group]
        out.append((ln, bytes(t)))
    return offsets, tuple(out)


def _tables(prepared, codes_ptr: int, out_ptr: int, n_rows: int) \
        -> List[Tuple[Launch, PairTable]]:
    tables = []
    for ln, raw in prepared:
        t = PairTable.from_buffer_copy(raw)
        t.codes, t.out, t.n_rows = codes_ptr, out_ptr, n_rows
        tables.append((ln, t))
    return tables


def pack_tables(pairs: Sequence[Tuple[int, int]], vocab: Sequence[int],
                codes_ptr: int, out_ptr: int, n_rows: int) -> List[PairTable]:
    """The filled :class:`PairTable` of each launch of one call."""
    _, prepared = _prepare(tuple(map(tuple, pairs)), tuple(vocab))
    return [t for _, t in _tables(prepared, codes_ptr, out_ptr, n_rows)]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid_size(n_rows: int, sms: int, smem_bytes: int) -> int:
    """Blocks of a launch: enough for every 1,024-row tile, at most as many
    per SM as are resident at once, and at most BLOCKS_PER_SM (the blocks
    stride over the tiles)."""
    tiles = -(-n_rows // (THREADS * ROWS_PER_THREAD))
    resident = max(1, min(BLOCKS_PER_SM, SMEM_PER_SM // (smem_bytes + 1024)))
    return max(1, min(tiles, resident * sms))


def pair_counts_plain(codes: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                      vocab: Sequence[int]) -> Tuple[torch.Tensor, np.ndarray]:
    """The plain version: one fused-key ``torch.bincount`` per pair."""
    offsets = matrix_offsets(pairs, vocab)
    parts: List[torch.Tensor] = []
    for x, y in pairs:
        wy = vocab[y] + 1
        key = (codes[x].long() + 1) * wy + (codes[y].long() + 1)
        parts.append(torch.bincount(key, minlength=(vocab[x] + 1) * wy)
                     .to(torch.int32))
    flat = torch.cat(parts) if parts \
        else torch.zeros(0, dtype=torch.int32, device=codes.device)
    return flat, offsets


def pair_counts(codes: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                vocab: Sequence[int]) -> Tuple[torch.Tensor, np.ndarray]:
    """Counts every pair of ``pairs`` (row indices into ``codes``), in as
    few launches as :func:`plan_launches` allows. ``vocab[i]`` is the
    vocabulary size of ``codes[i]``; every code must lie in
    ``[-1, vocab[i])``. Returns (flat int32 counts on ``codes.device``,
    int64 offsets [P+1] on the host)."""
    if codes.device.type == "cpu":
        return pair_counts_plain(codes, pairs, vocab)
    if not codes.is_cuda:
        raise ValueError(f"pair_counts: unsupported device {codes.device}")
    return _launch(codes, pairs, vocab)


def _launch(codes: torch.Tensor, pairs: Sequence[Tuple[int, int]],
            vocab: Sequence[int]) -> Tuple[torch.Tensor, np.ndarray]:
    global launches
    if codes.dtype != torch.int32 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("pair_counts: codes must be a contiguous int32 "
                         "[columns, rows] matrix")
    n_rows = int(codes.shape[1])
    if n_rows >= 1 << 31:
        raise ValueError("pair_counts: the kernel counts fewer than 2^31 rows")
    offsets, prepared = _prepare(tuple(map(tuple, pairs)), tuple(vocab))
    offsets = offsets.copy()  # the cached array stays the cache's
    if not pairs or n_rows == 0:
        return torch.zeros(int(offsets[-1]), dtype=torch.int32,
                           device=codes.device), offsets
    out = torch.empty(int(offsets[-1]), dtype=torch.int32, device=codes.device)
    lib = build.library()
    stream = build.current_stream()
    sms = _sm_count(codes.device.index)
    for ln, t in _tables(prepared, codes.data_ptr(), out.data_ptr(), n_rows):
        err = lib.delphi_pair_counts(
            ctypes.addressof(t), grid_size(n_rows, sms, ln.smem_bytes),
            ln.smem_bytes, stream)
        build.check(err, "pair_counts")
        with _count_lock:
            launches += 1
    return out, offsets
