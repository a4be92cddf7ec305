"""K5 ``domain_scores``: the bucketed domain route's gather-reduce.

Replaces the integer mode of the JAX package's ``_jit_bucket_kernel``
(``delphi_tpu/ops/domain.py``, a vmap of ``_int_score_body`` over the
pieces of one launch), which XLA jits. For each piece ``p``, padded row
``r`` and candidate value ``v``, over the piece's ``k`` correlates:

* ``big = sum(cnt - 1 | cnt >= 2)`` and ``tiny = #(cnt == 1)`` over the
  active correlates (int32 [b, rows_pad, va_pad]),
* ``contributed``: some correlate is active (bool, written as uint8),

where the pair count ``cnt = tables[p, c, code + 1, 1 + v]`` of the row's
code in correlate column ``col_idx[p, c]`` is active when the code is not
NULL, ``cnt > taus[p, c]``, ``cnt > 0`` and ``hs[p, v]``. ``row_idx``
indexes the columns of ``codes`` ([n_cols, rows + 1], int32, the last
column a sentinel of NULL codes that padded rows point at).

A CUDA tensor goes to the hand kernel (``csrc/domain_scores.cu``), a CPU
tensor to :func:`domain_scores_plain`, the same arithmetic in PyTorch ops.
Nothing in a call copies to or waits for the device.
"""

import ctypes
import functools
from typing import Tuple

import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel since the last reset.
launches = 0

THREADS = 256                 # csrc: kThreads
# grid-stride blocks per SM: enough to keep every SM busy at the main
# path's sizes without a grid as large as the output
BLOCKS_PER_SM = 16


def reset_launches() -> None:
    global launches
    launches = 0


class DomainTable(ctypes.Structure):
    """A launch's parameters, passed to the kernel by value; the layout of
    ``DomainTable`` in ``csrc/domain_scores.cu`` (104 bytes)."""
    _fields_ = [("codes", ctypes.c_void_p), ("col_idx", ctypes.c_void_p),
                ("taus", ctypes.c_void_p), ("hs", ctypes.c_void_p),
                ("row_idx", ctypes.c_void_p), ("tables", ctypes.c_void_p),
                ("big", ctypes.c_void_p), ("tiny", ctypes.c_void_p),
                ("contributed", ctypes.c_void_p),
                ("codes_stride", ctypes.c_int64), ("b", ctypes.c_int32),
                ("k", ctypes.c_int32), ("va_pad", ctypes.c_int32),
                ("vc_pad", ctypes.c_int32), ("rows_pad", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


def _check(codes: torch.Tensor, col_idx: torch.Tensor, taus: torch.Tensor,
           hs: torch.Tensor, row_idx: torch.Tensor,
           tables: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """Validates the operands; returns (b, k, va_pad, vc_pad, rows_pad)."""
    if tables.dim() != 4 or codes.dim() != 2:
        raise ValueError("domain_scores: tables must be [b, k, vc_pad, "
                         "va_pad + 1] and codes [n_cols, rows + 1]")
    b, k, vc_pad, w = (int(d) for d in tables.shape)
    va_pad = w - 1
    rows_pad = int(row_idx.shape[-1]) if row_idx.dim() == 2 else -1
    shapes = {"col_idx": (col_idx, (b, k)), "taus": (taus, (b, k)),
              "hs": (hs, (b, va_pad)), "row_idx": (row_idx, (b, rows_pad))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"domain_scores: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    for name, t in (("codes", codes), ("col_idx", col_idx), ("taus", taus),
                    ("hs", hs), ("row_idx", row_idx), ("tables", tables)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != codes.device:
            raise ValueError(f"domain_scores: {name} must be a contiguous "
                             f"int32 tensor on {codes.device}")
    return b, k, va_pad, vc_pad, rows_pad


def domain_scores_plain(codes: torch.Tensor, col_idx: torch.Tensor,
                        taus: torch.Tensor, hs: torch.Tensor,
                        row_idx: torch.Tensor, tables: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: one gather of the pair-count rows per correlate,
    the activation mask and the two int32 sums."""
    b, k, va_pad, vc_pad, rows_pad = _check(codes, col_idx, taus, hs,
                                            row_idx, tables)
    dev = codes.device
    big = torch.zeros((b, rows_pad, va_pad), dtype=torch.int32, device=dev)
    tiny = torch.zeros_like(big)
    contributed = torch.zeros((b, rows_pad, va_pad), dtype=torch.bool,
                              device=dev)
    piece = torch.arange(b, device=dev)[:, None]
    on = hs.bool()[:, None, :]
    for c in range(k):
        code = codes[col_idx[:, c].long()[:, None], row_idx.long()]
        g = tables[piece, c, code.long() + 1, 1:]     # [b, rows_pad, va_pad]
        active = (g > taus[:, c][:, None, None]) & (g > 0) \
            & (code != -1)[:, :, None] & on
        big += torch.where(active & (g >= 2), g - 1, torch.zeros_like(g))
        tiny += (active & (g == 1)).to(torch.int32)
        contributed |= active
    return big, tiny, contributed


def domain_scores(codes: torch.Tensor, col_idx: torch.Tensor,
                  taus: torch.Tensor, hs: torch.Tensor, row_idx: torch.Tensor,
                  tables: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(big int32, tiny int32, contributed bool), each [b, rows_pad,
    va_pad], on ``codes.device`` (see the module docstring). Every operand
    is a contiguous int32 tensor on one device."""
    if codes.device.type == "cpu":
        return domain_scores_plain(codes, col_idx, taus, hs, row_idx, tables)
    if not codes.is_cuda:
        raise ValueError(f"domain_scores: unsupported device {codes.device}")
    return _launch(codes, col_idx, taus, hs, row_idx, tables)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid_size(cells: int, sms: int) -> int:
    """Blocks of a launch: one thread per output cell, at most
    BLOCKS_PER_SM per SM (the blocks stride over the rest)."""
    return max(1, min(-(-cells // THREADS), BLOCKS_PER_SM * sms))


def _launch(codes: torch.Tensor, col_idx: torch.Tensor, taus: torch.Tensor,
            hs: torch.Tensor, row_idx: torch.Tensor, tables: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    b, k, va_pad, vc_pad, rows_pad = _check(codes, col_idx, taus, hs,
                                            row_idx, tables)
    dev = codes.device
    big = torch.empty((b, rows_pad, va_pad), dtype=torch.int32, device=dev)
    tiny = torch.empty_like(big)
    contributed = torch.empty((b, rows_pad, va_pad), dtype=torch.uint8,
                              device=dev)
    cells = b * rows_pad * va_pad
    if cells == 0:
        return big, tiny, contributed.view(torch.bool)
    t = DomainTable(
        codes=codes.data_ptr(), col_idx=col_idx.data_ptr(),
        taus=taus.data_ptr(), hs=hs.data_ptr(), row_idx=row_idx.data_ptr(),
        tables=tables.data_ptr(), big=big.data_ptr(), tiny=tiny.data_ptr(),
        contributed=contributed.data_ptr(),
        codes_stride=int(codes.shape[1]), b=b, k=k, va_pad=va_pad,
        vc_pad=vc_pad, rows_pad=rows_pad, pad=0)
    err = build.library().delphi_domain_scores(
        ctypes.addressof(t), grid_size(cells, _sm_count(dev.index)),
        build.current_stream())
    build.check(err, "domain_scores")
    launches += 1
    return big, tiny, contributed.view(torch.bool)
