"""K5 ``domain_scores``: the bucketed domain route's gather-reduce and its
weak-label epilogue.

Replaces the JAX package's ``_jit_bucket_kernel``
(``delphi_tpu/ops/domain.py``, a vmap over the pieces of one launch),
which XLA jits in two modes. One launch scores the error cells of ``b``
pieces; piece ``p``'s cells are ``rows[cell_off[p]:cell_off[p + 1]]``
(row indices into ``codes``, [n_cols, n_rows] int32, NULL = -1) and it
has ``piece_va[p]`` candidate values. For each cell and value ``v``, over
the piece's ``k`` correlates, the pair count ``cnt = tables[p, c, code +
1, 1 + v]`` of the cell's code in column ``col_idx[p, c]`` is active when
the code is not NULL, ``cnt > taus[p, c]``, ``cnt > 0`` and ``hs[p, v]``.

* :func:`domain_scores` (integer mode, the JAX package's for runs with a
  provenance ledger): ``big = sum(cnt - 1 | cnt >= 2)`` and ``tiny =
  #(cnt == 1)`` over the active correlates and ``contributed`` (some
  correlate active), per cell and value of the launch's ``va`` values;
* :func:`weak_label` (weak-label mode, its fused mode): per cell, the
  f64 combine of ``_combine_scores`` with the row sum in numpy's
  ``pairwise_sum`` order, the beta mask and the rank tie-break of the host
  pick, returning ``has_domain`` and ``top`` (the vocabulary slot).

The operands travel as one int32 blob (:func:`pack`, one upload), carved
into views by :class:`Operands`. A CUDA tensor goes to the hand kernel
(``csrc/domain_scores.cu``), a CPU tensor to the plain version (the same
arithmetic in PyTorch ops; the row sum an explicit loop in numpy's order,
never ``torch.sum``). Each returns ONE uint8 buffer, so the host takes its
results in one copy; :func:`split_weak` and :func:`split_scores` view it.
Nothing in a call copies to or waits for the device.
"""

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of the CUDA kernel since the last reset, in all and by mode
# ("weak", "int") and by where the pair tables were read ("shared",
# "global"). Requests served in threads launch side by side: the counts
# move under a lock.
launches = 0
mode_launches = {"weak": 0, "int": 0}
branch_launches = {"shared": 0, "global": 0}
_count_lock = threading.Lock()

THREADS = 256                 # csrc: kThreads, one cell per thread
# the launch's pair tables are staged in shared memory when they take at
# most this many bytes (two blocks an SM); else they are read through L2
SMEM_TABLE_BUDGET = 100 * 1024
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
THREADS_PER_SM = 2048

# the blob's parts, in order (shapes: Layout.shapes)
_PARTS = ("col_idx", "taus", "vcs", "hs", "rank", "cell_off", "piece_va",
          "rows", "tables")


def reset_launches() -> None:
    global launches
    launches = 0
    for d in (mode_launches, branch_launches):
        for key in d:
            d[key] = 0


class DomainTable(ctypes.Structure):
    """A launch's parameters, passed to the kernel by value; the layout of
    ``DomainTable`` in ``csrc/domain_scores.cu`` (136 bytes)."""
    _fields_ = [("codes", ctypes.c_void_p), ("col_idx", ctypes.c_void_p),
                ("taus", ctypes.c_void_p), ("vcs", ctypes.c_void_p),
                ("hs", ctypes.c_void_p), ("rank", ctypes.c_void_p),
                ("cell_off", ctypes.c_void_p), ("piece_va", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("tables", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("beta", ctypes.c_double),
                ("n_rows", ctypes.c_double), ("codes_stride", ctypes.c_int64),
                ("k", ctypes.c_int32), ("va", ctypes.c_int32),
                ("vc_pad", ctypes.c_int32), ("cells", ctypes.c_int32),
                ("weak", ctypes.c_int32), ("shared", ctypes.c_int32)]


@dataclass(frozen=True)
class Layout:
    """The host-side extents of one launch: ``b`` pieces of ``k``
    correlates, the launch's value width ``va`` (its widest piece's) and
    table rows ``vc_pad``, and each piece's (cells, values)."""
    k: int
    va: int
    vc_pad: int
    extents: Tuple[Tuple[int, int], ...]

    @property
    def b(self) -> int:
        return len(self.extents)

    @property
    def cells(self) -> int:
        return sum(m for m, _ in self.extents)

    def shapes(self) -> dict:
        b, k, va = self.b, self.k, self.va
        return {"col_idx": (b, k), "taus": (b, k), "vcs": (b, k),
                "hs": (b, va), "rank": (b, va), "cell_off": (b + 1,),
                "piece_va": (b,), "rows": (self.cells,),
                "tables": (b, k, self.vc_pad, va + 1)}

    def size(self) -> int:
        return sum(int(np.prod(s)) for s in self.shapes().values())


@dataclass(frozen=True)
class Piece:
    """One piece's host operands: its cells' row indices, its correlates'
    columns (slots of the launch's code matrix), taus and real table rows,
    its has-single flags and vocab ranks ([v_a]), and its pair tables
    ``[k, >= vc, >= v_a + 1]`` (zero past the real extents)."""
    rows: np.ndarray
    col_idx: Sequence[int]
    taus: Sequence[int]
    vcs: Sequence[int]
    hs: np.ndarray
    rank: np.ndarray
    tables: np.ndarray


def pack(pieces: Sequence[Piece], vc_pad: int) -> Tuple[np.ndarray, Layout]:
    """The int32 blob of one launch and its layout; values past a piece's
    v_a get ``hs`` 0, rank 0 and zero tables."""
    k = len(pieces[0].col_idx)
    va = max(len(p.hs) for p in pieces)
    layout = Layout(k, va, vc_pad, tuple((len(p.rows), len(p.hs))
                                         for p in pieces))
    shapes = layout.shapes()
    arrs = {name: np.zeros(shapes[name], np.int32) for name in _PARTS}
    arrs["cell_off"][1:] = np.cumsum([m for m, _ in layout.extents])
    for i, p in enumerate(pieces):
        v_a = len(p.hs)
        arrs["col_idx"][i] = p.col_idx
        arrs["taus"][i] = p.taus
        arrs["vcs"][i] = p.vcs
        arrs["hs"][i, :v_a] = p.hs
        arrs["rank"][i, :v_a] = p.rank
        arrs["piece_va"][i] = v_a
        t = p.tables[:, :vc_pad, :v_a + 1]
        arrs["tables"][i, :, :t.shape[1], :t.shape[2]] = t
        lo = arrs["cell_off"][i]
        arrs["rows"][lo:lo + len(p.rows)] = p.rows
    return np.concatenate([arrs[n].ravel() for n in _PARTS]), layout


class Operands:
    """One launch's device operands: the code matrix and views into the
    uploaded blob, validated once here, plus the launch's shape and its
    kernel parameters (built on first launch)."""

    def __init__(self, codes: torch.Tensor, blob: torch.Tensor,
                 layout: Layout):
        for name, t, dim in (("codes", codes, 2), ("blob", blob, 1)):
            if t.dtype != torch.int32 or t.dim() != dim \
                    or not t.is_contiguous():
                raise ValueError(f"domain_scores: {name} must be a "
                                 f"contiguous {dim}-D int32 tensor")
        if blob.device != codes.device:
            raise ValueError("domain_scores: codes and blob on different "
                             "devices")
        if int(blob.numel()) != layout.size():
            raise ValueError(f"domain_scores: blob of {blob.numel()} "
                             f"elements, the layout needs {layout.size()}")
        if layout.b == 0 or layout.b > 65535 or layout.k == 0:
            raise ValueError(f"domain_scores: {layout.b} pieces of "
                             f"{layout.k} correlates")
        self.codes, self.blob, self.layout = codes, blob, layout
        at = 0
        for name, shape in layout.shapes().items():
            size = int(np.prod(shape))
            setattr(self, name, blob[at:at + size].view(shape))
            at += size
        self._params = {}

    @property
    def device(self) -> torch.device:
        return self.codes.device


def split_weak(buf: torch.Tensor, cells: int) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """(has_domain bool [cells], top int32 [cells]) views of a
    :func:`weak_label` buffer."""
    return buf[4 * cells:].view(torch.bool), buf[:4 * cells].view(torch.int32)


def split_scores(buf: torch.Tensor, cells: int, va: int) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(big int32, tiny int32, contributed bool), each [cells, va], views of
    a :func:`domain_scores` buffer. The buffer is value-major, so the views
    are transposed (not contiguous)."""
    plane = cells * va
    big = buf[:4 * plane].view(torch.int32).view(va, cells).t()
    tiny = buf[4 * plane:8 * plane].view(torch.int32).view(va, cells).t()
    return big, tiny, buf[8 * plane:].view(torch.bool).view(va, cells).t()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _piece_of_cells(ops: Operands) -> torch.Tensor:
    counts = torch.tensor([m for m, _ in ops.layout.extents],
                          dtype=torch.int64)
    return torch.repeat_interleave(torch.arange(ops.layout.b), counts) \
        .to(ops.device)


def _scores_plain(ops: Operands):
    """big, tiny int32 and contributed bool [cells, va]."""
    lay = ops.layout
    piece = _piece_of_cells(ops)
    rows = ops.rows.long()
    big = torch.zeros((lay.cells, lay.va), dtype=torch.int32,
                      device=ops.device)
    tiny = torch.zeros_like(big)
    contributed = torch.zeros((lay.cells, lay.va), dtype=torch.bool,
                              device=ops.device)
    on = ops.hs.bool()[piece]
    for c in range(lay.k):
        code = ops.codes[ops.col_idx[piece, c].long(), rows].long()
        g = ops.tables[piece, c, code + 1, 1:]       # [cells, va]
        known = (code != -1) & (code + 1 < ops.vcs[piece, c])
        active = (g > ops.taus[piece, c][:, None]) & (g > 0) \
            & known[:, None] & on
        big += torch.where(active & (g >= 2), g - 1, torch.zeros_like(g))
        tiny += (active & (g == 1)).to(torch.int32)
        contributed |= active
    return big, tiny, contributed


def pairwise_rowsum(a: torch.Tensor) -> torch.Tensor:
    """Row sums of an f64 [m, n] tensor in numpy's ``pairwise_sum`` order
    (what ``a.numpy().sum(axis=1)`` gives), written out as separate
    additions so that no reduction reorders them."""
    n = int(a.shape[1])
    if n < 8:
        res = torch.full((a.shape[0],), -0.0, dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        r = a[:, :8]
        body = n - n % 8
        for i in range(8, body, 8):
            r = r + a[:, i:i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) \
            + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(body, n):
            res = res + a[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_rowsum(a[:, :n2]) + pairwise_rowsum(a[:, n2:])


def weak_epilogue(big: torch.Tensor, tiny: torch.Tensor,
                  contributed: torch.Tensor, rank: torch.Tensor, beta: float,
                  n_rows: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(has_domain, top) of one piece's [m, v_a] sums: the host numpy
    route's combine (``_combine_scores``) and pick, in torch f64."""
    # the divisor as a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, an ulp away from numpy's division
    score = (big.double() + 0.1 * tiny.double()) \
        / torch.full_like(big, float(n_rows), dtype=torch.float64)
    denom = pairwise_rowsum(score)[:, None]
    prob = torch.where(denom > 0, score / denom, torch.zeros_like(score))
    masked = torch.where(contributed & (prob > beta), prob,
                         torch.full_like(prob, -float("inf")))
    if masked.shape[1] == 0:
        m = masked.shape[0]
        return (torch.zeros(m, dtype=torch.bool, device=big.device),
                torch.zeros(m, dtype=torch.int32, device=big.device))
    best = masked.max(dim=1).values
    ties = masked == best[:, None]
    keyed = torch.where(ties, rank.long()[None, :],
                        torch.full_like(ties, 2 ** 62, dtype=torch.int64))
    return best > -float("inf"), keyed.argmin(dim=1).to(torch.int32)


def domain_scores_plain(ops: Operands) -> torch.Tensor:
    """The plain integer mode: one gather of the pair-count rows per
    correlate, the activation mask and the two int32 sums, packed as
    :func:`domain_scores` packs them."""
    return torch.cat([t.t().contiguous().reshape(-1).view(torch.uint8)
                      for t in _scores_plain(ops)])


def weak_label_plain(ops: Operands, beta: float, n_rows: float) \
        -> torch.Tensor:
    """The plain weak-label mode: :func:`domain_scores_plain`'s sums, then
    :func:`weak_epilogue` over each piece's real cells and values."""
    big, tiny, contributed = _scores_plain(ops)
    tops, hases = [], []
    at = 0
    for p, (m, v_a) in enumerate(ops.layout.extents):
        cells = slice(at, at + m)
        has, top = weak_epilogue(big[cells, :v_a], tiny[cells, :v_a],
                                 contributed[cells, :v_a],
                                 ops.rank[p, :v_a], beta, n_rows)
        tops.append(top)
        hases.append(has)
        at += m
    top = torch.cat(tops) if tops else torch.zeros(0, dtype=torch.int32)
    has = torch.cat(hases) if hases else torch.zeros(0, dtype=torch.bool)
    return torch.cat([top.view(torch.uint8), has.view(torch.uint8)])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def domain_scores(ops: Operands) -> torch.Tensor:
    """Integer mode: a uint8 buffer holding big int32, tiny int32 and
    contributed bool, each value-major [va, cells], on the operands' device
    (see :func:`split_scores`)."""
    if ops.device.type == "cpu":
        return domain_scores_plain(ops)
    return _launch(ops, False, 0.0, 0.0)


def weak_label(ops: Operands, beta: float, n_rows: float) -> torch.Tensor:
    """Weak-label mode: a uint8 buffer holding top int32 [cells] and
    has_domain bool [cells], on the operands' device (see
    :func:`split_weak`); ``n_rows`` is the table's row count that divides
    every score."""
    if ops.device.type == "cpu":
        return weak_label_plain(ops, beta, n_rows)
    return _launch(ops, True, float(beta), float(n_rows))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_shape(layout: Layout, weak: bool, sms: int) -> dict:
    """A launch's shared memory and grid: whether the pair tables are
    staged in shared memory (they fit :data:`SMEM_TABLE_BUDGET`, each row
    at an odd pitch), the dynamic shared bytes, and the grid (blocks per
    piece, pieces) that fills every SM, each block striding over its
    piece's cells."""
    k, va = layout.k, layout.va
    fixed = 4 * (THREADS * k + 3 * k + va * (2 if weak else 1))
    tables = 4 * k * layout.vc_pad * ((va + 1) | 1)
    shared = tables <= SMEM_TABLE_BUDGET
    smem = fixed + (tables if shared else 0)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"domain_scores: {smem} bytes of shared memory at "
                         f"k {k}, va {va}")
    resident = max(1, min(THREADS_PER_SM // THREADS,
                          SMEM_PER_SM // (smem + 1024)))
    most = max(m for m, _ in layout.extents)
    grid_x = max(1, min(-(-most // THREADS), sms * resident // layout.b))
    return {"shared": shared, "smem": smem, "grid": (grid_x, layout.b)}


def params(ops: Operands, weak: bool) -> Tuple[DomainTable, dict]:
    """The launch's parameter table (its ``out``, ``beta`` and ``n_rows``
    set per call) and :func:`launch_shape`, built once per operands and
    mode."""
    cached = ops._params.get(weak)
    if cached is None:
        lay = ops.layout
        shape = launch_shape(lay, weak, _sm_count(ops.device.index))
        t = DomainTable(
            codes=ops.codes.data_ptr(), col_idx=ops.col_idx.data_ptr(),
            taus=ops.taus.data_ptr(), vcs=ops.vcs.data_ptr(),
            hs=ops.hs.data_ptr(), rank=ops.rank.data_ptr(),
            cell_off=ops.cell_off.data_ptr(),
            piece_va=ops.piece_va.data_ptr(), rows=ops.rows.data_ptr(),
            tables=ops.tables.data_ptr(), out=0, beta=0.0, n_rows=1.0,
            codes_stride=int(ops.codes.shape[1]), k=lay.k, va=lay.va,
            vc_pad=lay.vc_pad, cells=lay.cells, weak=int(weak),
            shared=int(shape["shared"]))
        cached = ops._params[weak] = (t, shape)
    return cached


def out_bytes(layout: Layout, weak: bool) -> int:
    return 5 * layout.cells if weak else 9 * layout.cells * layout.va


def _launch(ops: Operands, weak: bool, beta: float, n_rows: float) \
        -> torch.Tensor:
    global launches
    if not ops.codes.is_cuda:
        raise ValueError(f"domain_scores: unsupported device {ops.device}")
    t, shape = params(ops, weak)
    out = torch.empty(out_bytes(ops.layout, weak), dtype=torch.uint8,
                      device=ops.device)
    if ops.layout.cells == 0:
        return out
    t.out, t.beta, t.n_rows = out.data_ptr(), beta, n_rows
    err = build.library().delphi_domain_scores(
        ctypes.addressof(t), shape["grid"][0], shape["grid"][1],
        shape["smem"], build.current_stream())
    build.check(err, "domain_scores")
    with _count_lock:
        launches += 1
        mode_launches["weak" if weak else "int"] += 1
        branch_launches["shared" if shape["shared"] else "global"] += 1
    return out
