"""K2 ``entropy_terms``: entropy partial sums of count segments.

Replaces the JAX package's Pallas kernel ``_entropy_kernel``
(``delphi_tpu/ops/pallas_kernels.py``). For each segment
``counts[offsets[s]:offsets[s+1]]`` of an int32 count buffer it returns

* ``h[s] = -sum_{c>0} (c/n) log2(c/n)`` (f64),
* ``total[s] = sum c`` and ``nnz[s] = #{c > 0}`` (int64),

the observed part of the corrected entropy; the missing-mass correction
stays with the caller (:mod:`delphi_tpu_torch.ops.entropy`).

A CUDA tensor goes to the hand kernel (``csrc/entropy.cu``), a CPU tensor
to :func:`entropy_terms_plain`, the f64 host formula written in torch.

The chunk plan is pure Python (:func:`plan_chunks`): every segment is cut
into chunks of :func:`chunk_length` counts, at least one each, and the
kernel gives every chunk one warp. The segment table
(:class:`EntropyTable`) goes to the kernel by value: as a stride and a
count when the segments are uniform, inline up to
:data:`INLINE_SEGMENTS` segments, else in one ``non_blocking`` copy from
pinned memory. Nothing in a call waits for the device.

:func:`entropy_terms_owned` reduces a chosen subset of the segments with
the chunk length of the call over all of them (the kernel's gather modes),
so each result equals the all-segment call's bit for bit: the row-shard
plane's ranks reduce the pairs they own this way.
"""

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel since the last reset, and of those the
# launches of the owned-segment entry point (entropy_terms_owned).
# Requests served in threads launch side by side: the counts move under a
# lock.
launches = 0
owned_launches = 0
_count_lock = threading.Lock()

# Counts per chunk (one warp each): the call's counts over TARGET_CHUNKS,
# rounded up to a power of two within [MIN_CHUNK, MAX_CHUNK].
TARGET_CHUNKS = 2048
MIN_CHUNK, MAX_CHUNK = 256, 8192
INLINE_SEGMENTS = 192         # csrc: kInline
MODE_UNIFORM, MODE_INLINE, MODE_DEVICE = 0, 1, 2
MODE_GATHER_INLINE, MODE_GATHER_DEVICE = 3, 4
# gather-mode segments held inline: starts, ends and chunk_base (3S + 1)
# in the inline table
GATHER_INLINE_SEGMENTS = (2 * (INLINE_SEGMENTS + 1) - 1) // 3


def reset_launches() -> None:
    global launches, owned_launches
    launches = owned_launches = 0


class EntropyTable(ctypes.Structure):
    """A launch's parameters, passed to the kernel by value; the layout of
    ``EntropyTable`` in ``csrc/entropy.cu`` (3,208 bytes)."""
    _fields_ = [("counts", ctypes.c_void_p), ("h", ctypes.c_void_p),
                ("total", ctypes.c_void_p), ("nnz", ctypes.c_void_p),
                ("part_h", ctypes.c_void_p), ("part_total", ctypes.c_void_p),
                ("part_nnz", ctypes.c_void_p), ("tickets", ctypes.c_void_p),
                ("table_dev", ctypes.c_void_p), ("n_rows", ctypes.c_double),
                ("base", ctypes.c_int64), ("stride", ctypes.c_int64),
                ("chunk", ctypes.c_int64), ("n_segments", ctypes.c_int32),
                ("n_chunks", ctypes.c_int32),
                ("chunks_per_segment", ctypes.c_int32),
                ("mode", ctypes.c_int32),
                ("table", ctypes.c_int64 * (2 * (INLINE_SEGMENTS + 1)))]


def chunk_length(offsets: np.ndarray) -> int:
    """Counts per chunk for one call: enough chunks to spread a large
    segment over every SM, few enough that finishing it stays short."""
    total = int(offsets[-1] - offsets[0]) if len(offsets) else 0
    want = max(1, -(-total // TARGET_CHUNKS))
    return min(MAX_CHUNK, max(MIN_CHUNK, 1 << (want - 1).bit_length()))


def plan_chunks(offsets: np.ndarray, chunk: int) -> np.ndarray:
    """int64 [S+1] ``chunk_base``: segment s owns chunks
    ``[chunk_base[s], chunk_base[s+1])``, at least one."""
    lengths = np.diff(np.asarray(offsets, dtype=np.int64))
    per = np.maximum(1, -(-lengths // chunk))
    return np.concatenate([[0], np.cumsum(per)]).astype(np.int64)


def _uniform(offsets: np.ndarray) -> Optional[int]:
    """The common segment length, if every segment has one."""
    lengths = np.diff(offsets)
    if len(lengths) and (lengths == lengths[0]).all():
        return int(lengths[0])
    return None


@functools.lru_cache(maxsize=64)
def _plan(off_bytes: bytes, chunk: int) \
        -> Tuple[bytes, Optional[np.ndarray], int, bool]:
    """(table template without pointers and ``n_rows``, the host copy of a
    mode-2 table, chunks, whether any segment has several chunks), for
    valid offsets (cached by them)."""
    off = np.frombuffer(off_bytes, dtype=np.int64)
    if len(off) < 2 or off[0] < 0 or (np.diff(off) < 0).any():
        raise ValueError("entropy_terms: offsets must be ascending and "
                         "inside the count buffer")
    n_seg = len(off) - 1
    chunk_base = plan_chunks(off, chunk)
    n_chunks = int(chunk_base[-1])
    if n_chunks >= 1 << 31:
        raise ValueError("entropy_terms: too many chunks for one launch")
    t = EntropyTable()
    t.chunk, t.n_segments, t.n_chunks = chunk, n_seg, n_chunks
    host_table = None
    stride = _uniform(off)
    if stride is not None:
        t.mode, t.base, t.stride = MODE_UNIFORM, int(off[0]), stride
        t.chunks_per_segment = n_chunks // n_seg
    else:
        tab = np.concatenate([off, chunk_base]).astype(np.int64)
        if n_seg <= INLINE_SEGMENTS:
            t.mode = MODE_INLINE
            np.ctypeslib.as_array(t.table)[:len(tab)] = tab
        else:
            t.mode = MODE_DEVICE
            host_table = tab
    return bytes(t), host_table, n_chunks, n_chunks > n_seg


@functools.lru_cache(maxsize=64)
def _plan_gather(off_bytes: bytes, seg_bytes: bytes, chunk: int) \
        -> Tuple[bytes, Optional[np.ndarray], int, bool]:
    """:func:`_plan` for the segments numbered by ``seg_bytes`` among
    those the offsets cut, in the gather modes: each segment by its own
    start and end, chunked by ``chunk``, the all-segment call's length."""
    off = np.frombuffer(off_bytes, dtype=np.int64)
    segs = np.frombuffer(seg_bytes, dtype=np.int64)
    if len(off) < 2 or off[0] < 0 or (np.diff(off) < 0).any():
        raise ValueError("entropy_terms: offsets must be ascending and "
                         "inside the count buffer")
    if not len(segs) or segs.min() < 0 or segs.max() >= len(off) - 1:
        raise ValueError("entropy_terms_owned: segments outside the "
                         "offsets")
    starts, ends = off[segs], off[segs + 1]
    chunk_base = plan_chunks(np.concatenate([[0], np.cumsum(ends - starts)]),
                             chunk)
    n_seg, n_chunks = len(segs), int(chunk_base[-1])
    if n_chunks >= 1 << 31:
        raise ValueError("entropy_terms: too many chunks for one launch")
    t = EntropyTable()
    t.chunk, t.n_segments, t.n_chunks = chunk, n_seg, n_chunks
    tab = np.concatenate([starts, ends, chunk_base]).astype(np.int64)
    host_table = None
    if n_seg <= GATHER_INLINE_SEGMENTS:
        t.mode = MODE_GATHER_INLINE
        np.ctypeslib.as_array(t.table)[:len(tab)] = tab
    else:
        t.mode = MODE_GATHER_DEVICE
        host_table = tab
    return bytes(t), host_table, n_chunks, n_chunks > n_seg


def entropy_terms_plain(counts: torch.Tensor, offsets: Sequence[int],
                        n_rows: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: the f64 formula over each segment's positive
    counts."""
    off = torch.as_tensor(np.asarray(offsets, dtype=np.int64),
                          device=counts.device)
    lengths = off[1:] - off[:-1]
    n_seg = int(lengths.numel())
    seg = counts[int(offsets[0]):int(offsets[-1])]
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=counts.device), lengths)
    nz = seg > 0
    c = seg.to(torch.float64)
    p = torch.where(nz, c, torch.ones_like(c)) / float(n_rows)
    terms = torch.where(nz, p * torch.log2(p), torch.zeros_like(p))
    h = 0.0 - torch.segment_reduce(terms, "sum", lengths=lengths, unsafe=True)
    total = torch.zeros(n_seg, dtype=torch.int64, device=counts.device) \
        .index_add_(0, ids, seg.long())
    nnz = torch.zeros(n_seg, dtype=torch.int64, device=counts.device) \
        .index_add_(0, ids, nz.long())
    return h, total, nnz


def entropy_terms_owned_plain(counts: torch.Tensor, offsets: Sequence[int],
                              n_rows: int, segments: Sequence[int]) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`entropy_terms_owned`: the chosen
    segments gathered back to back and reduced by
    :func:`entropy_terms_plain`, whose per-segment sums read only their own
    segment, in order."""
    off = np.asarray(offsets, dtype=np.int64)
    segs = np.asarray(segments, dtype=np.int64)
    lengths = off[segs + 1] - off[segs]
    sub = torch.cat([counts[int(off[s]):int(off[s + 1])] for s in segs]) \
        if len(segs) else counts[:0]
    return entropy_terms_plain(
        sub, np.concatenate([[0], np.cumsum(lengths)]), n_rows)


def entropy_terms(counts: torch.Tensor, offsets: Sequence[int], n_rows: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h f64 [S], total int64 [S], nnz int64 [S]) on ``counts.device`` for
    the S segments that ``offsets`` (host ints, length S+1) cut out of the
    int32 buffer ``counts``."""
    if counts.device.type == "cpu":
        return entropy_terms_plain(counts, offsets, n_rows)
    if not counts.is_cuda:
        raise ValueError(f"entropy_terms: unsupported device {counts.device}")
    return _launch(counts, offsets, n_rows)


def entropy_terms_owned(counts: torch.Tensor, offsets: Sequence[int],
                        n_rows: int, segments: Sequence[int]) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`entropy_terms` of the segments numbered ``segments`` (indices
    into the S that ``offsets`` cut), in that order: each result equals,
    bit for bit, the one ``entropy_terms(counts, offsets, n_rows)`` gives
    for that segment (one launch in the kernel's gather modes, with the
    chunk length of the all-segment call)."""
    if counts.device.type == "cpu":
        return entropy_terms_owned_plain(counts, offsets, n_rows, segments)
    if not counts.is_cuda:
        raise ValueError(f"entropy_terms: unsupported device {counts.device}")
    return _launch(counts, offsets, n_rows, segments)


def to_host(h: torch.Tensor, total: torch.Tensor, nnz: torch.Tensor) \
        -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(h, total, nnz) as numpy arrays, in one device-to-host copy: h is
    bit-cast to int64 and the three stacked."""
    packed = torch.stack([h.view(torch.int64), total, nnz]).cpu().numpy()
    return packed[0].view(np.float64), packed[1], packed[2]


def pack_table(counts: torch.Tensor, offsets: Sequence[int], n_rows: int,
               segments: Optional[Sequence[int]] = None) \
        -> Tuple[EntropyTable, Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]]:
    """The filled :class:`EntropyTable` of one call (of the ``segments``
    only, when given) and its (h, total, nnz) outputs; allocates the
    outputs and scratch and, for a table past the inline capacity, starts
    its ``non_blocking`` upload from pinned memory. The table holds the
    only references to the scratch tensors' memory, so they ride along on
    the table object."""
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    if segments is None:
        raw, host_table, n_chunks, multi = _plan(off.tobytes(),
                                                 chunk_length(off))
        n_seg = len(off) - 1
    else:
        segs = np.ascontiguousarray(segments, dtype=np.int64)
        raw, host_table, n_chunks, multi = _plan_gather(
            off.tobytes(), segs.tobytes(), chunk_length(off))
        n_seg = len(segs)
    dev = counts.device
    packed = torch.empty((3, n_seg), dtype=torch.int64, device=dev)
    t = EntropyTable.from_buffer_copy(raw)
    t.counts, t.n_rows = counts.data_ptr(), float(n_rows)
    base = packed.data_ptr()
    t.h, t.total, t.nnz = base, base + 8 * n_seg, base + 16 * n_seg
    keep = [packed]
    if multi:
        scratch = torch.empty(3 * n_chunks + (n_seg + 1) // 2,
                              dtype=torch.int64, device=dev)
        base = scratch.data_ptr()
        t.part_h, t.part_total, t.part_nnz = (
            base, base + 8 * n_chunks, base + 16 * n_chunks)
        t.tickets = base + 24 * n_chunks
        keep.append(scratch)
    if host_table is not None:
        pinned = torch.from_numpy(host_table).pin_memory()
        dev_table = torch.empty(len(host_table), dtype=torch.int64,
                                device=dev)
        dev_table.copy_(pinned, non_blocking=True)
        t.table_dev = dev_table.data_ptr()
        keep.append(dev_table)
    t._keep = keep
    h, total, nnz = packed.unbind(0)
    return t, (h.view(torch.float64), total, nnz)


def _launch(counts: torch.Tensor, offsets: Sequence[int], n_rows: int,
            segments: Optional[Sequence[int]] = None) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches, owned_launches
    if counts.dtype != torch.int32 or counts.dim() != 1 \
            or not counts.is_contiguous():
        raise ValueError("entropy_terms: counts must be a contiguous 1-D "
                         "int32 tensor")
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    if len(off) < 1 or off[-1] > counts.numel():
        raise ValueError("entropy_terms: offsets must be ascending and "
                         "inside the count buffer")
    if len(off) == 1 or (segments is not None and not len(segments)):
        empty = torch.empty(0, dtype=torch.int64, device=counts.device)
        return empty.view(torch.float64), empty, empty.clone()
    t, out = pack_table(counts, off, n_rows, segments)
    err = build.library().delphi_entropy_terms(ctypes.addressof(t),
                                               build.current_stream())
    build.check(err, "entropy_terms")
    with _count_lock:
        launches += 1
        if segments is not None:
            owned_launches += 1
    return out
