"""K3 + K4: the GBDT tree builder's per-level programs and the boosted
predictor (``csrc/gbdt.cu``), and their plain PyTorch versions.

The JAX package jits them as XLA programs, not Pallas ones
(``delphi_tpu/models/gbdt.py``); on the TPU each tree level is one fused
program with one-hot matmul histograms. The port's builder
(:func:`delphi_tpu_torch.models.gbdt._build_trees`) calls, per level:

* :func:`hist` (K3a ``gbdt_hist``; replaces the histogram of
  ``_build_tree``, ``gbdt.py:157-163``, and its leaf sums, :220-222): for
  every (tree, node, feature, bin, channel), the f32 sum of the channel
  over the rows at that node and bin, added one row at a time in
  increasing row order from 0.0. Bound by bytes on paper (each row's
  channels, node and bins read once, the histograms written once), and
  by its order: each bin's sum is a chain of dependent adds, so no call
  beats its fullest bin's rows times an add's latency. One block per
  (tree, node, feature) compacts its node's rows into shared memory in
  row order, buckets them by bin stably (warp ranks from
  ``__match_any_sync``, a scan over (bin, warp)), and a thread per bin
  adds only its bin's rows.
* :func:`split` (K3b ``gbdt_split``; replaces :181-215): per (tree, node)
  the bin cumsums in XLA:CPU's blocked order, the gain and its masks, the
  first maximum with ``torch.argmax``'s NaN rule, the sentinel; writes
  ``feat`` / ``thr`` at the level's offset. Bound by the histogram bytes;
  a block per (tree, node) and a thread per (feature, bin) over chunks of
  features, each prefix at most 16 adds from its block of 16 bins and
  that block's offset.
* :func:`route` (K3c ``gbdt_route``; replaces :217-218): ``node <- 2 *
  node + (bins[row, feat[node]] > thr[node])``, a fresh tensor each
  level. Bound by bytes on paper (a node id in and out, one bin read a
  row), in practice by the launch and ramp of its grid: a thread per
  (tree, row); designs that cut its chain of dependent loads were
  measured no faster.

and the predictor calls :func:`predict` (K4 ``gbdt_predict``; replaces
``_predict_tree`` :230 and ``_predict_boosted`` :373): every round's tree
traversed for every (class tree, row), its leaf added to the base margin
round by round in f32. Bound by its instructions a node visit, not its
bytes: a block per (group of class trees, share of the row tiles), a
thread per row; the group's trees staged in shared memory as one 32-bit
word a node (a 16-bit threshold, a 16-bit feature offset or byte
selector), once when they fit, else a chunk of rounds at a time
through ``cp.async``; a row of at most four features whose bins fit a
byte holds them in one register. Rows as wide as
:data:`PREDICT_MAX_FEATURES` and trees as deep as :data:`MAX_DEPTH` are
taken; a wider or deeper call raises. The bins are the binner's codes,
below :data:`MAX_BINS`.

The plain versions are the port's arithmetic before the kernels, moved
here unchanged: a stable sort by segment and ``torch.segment_reduce``
(which adds each segment's values one after the other), the blocked
cumsum as a Python loop, the split search and the traversal as tensor
ops. Every kernel returns the plain version's bits (``csrc/gbdt.cu``
says how). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Node ids are int32 on both.

Each wrapper adds one to ``launches[name]`` where it launches, and
nowhere else. Nothing in a call copies to or waits for the device.
"""

import ctypes
import threading
from typing import Any, Optional

import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of each CUDA kernel since the last reset. Requests served in
# threads launch side by side, so the counts move under a lock.
launches = {"gbdt_hist": 0, "gbdt_split": 0, "gbdt_route": 0,
            "gbdt_predict": 0}
_count_lock = threading.Lock()

MAX_BINS = 256        # csrc: kMaxBins (a thread per bin)
MAX_CHANNELS = 4      # csrc: kMaxChannels
BLOCK = 16            # XLA:CPU's cumsum block
MAX_DEPTH = 10        # csrc: kMaxDepth
PREDICT_MAX_FEATURES = 1024  # csrc: kMaxPredictFeatures (one warp's rows)


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _counted(name: str) -> None:
    with _count_lock:
        launches[name] += 1


class HistParams(ctypes.Structure):
    """The layout of ``HistParams`` in ``csrc/gbdt.cu`` (72 bytes)."""
    _fields_ = [("vals", ctypes.c_void_p), ("node", ctypes.c_void_p),
                ("bins", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("trees", ctypes.c_int32),
                ("levels", ctypes.c_int32), ("d", ctypes.c_int32),
                ("n_bins", ctypes.c_int32), ("channels", ctypes.c_int32),
                ("per_round", ctypes.c_int32), ("models", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


class SplitParams(ctypes.Structure):
    """The layout of ``SplitParams`` in ``csrc/gbdt.cu`` (104 bytes)."""
    _fields_ = [("hist", ctypes.c_void_p), ("lam", ctypes.c_void_p),
                ("msg", ctypes.c_void_p), ("mcw", ctypes.c_void_p),
                ("mcs", ctypes.c_void_p), ("feat", ctypes.c_void_p),
                ("thr", ctypes.c_void_p), ("lam_s", ctypes.c_float),
                ("msg_s", ctypes.c_float), ("mcw_s", ctypes.c_float),
                ("mcs_s", ctypes.c_float), ("trees", ctypes.c_int32),
                ("levels", ctypes.c_int32), ("d", ctypes.c_int32),
                ("n_bins", ctypes.c_int32), ("channels", ctypes.c_int32),
                ("w_slot", ctypes.c_int32), ("c_slot", ctypes.c_int32),
                ("width", ctypes.c_int32)]


class RouteParams(ctypes.Structure):
    """The layout of ``RouteParams`` in ``csrc/gbdt.cu`` (72 bytes)."""
    _fields_ = [("node", ctypes.c_void_p), ("bins", ctypes.c_void_p),
                ("feat", ctypes.c_void_p), ("thr", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("trees", ctypes.c_int32), ("d", ctypes.c_int32),
                ("offset", ctypes.c_int32), ("width", ctypes.c_int32),
                ("per_round", ctypes.c_int32), ("models", ctypes.c_int32)]


class PredictParams(ctypes.Structure):
    """The layout of ``PredictParams`` in ``csrc/gbdt.cu`` (72 bytes)."""
    _fields_ = [("bins", ctypes.c_void_p), ("feats", ctypes.c_void_p),
                ("thrs", ctypes.c_void_p), ("leaves", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("trees", ctypes.c_int32),
                ("d", ctypes.c_int32), ("rounds", ctypes.c_int32),
                ("depth", ctypes.c_int32)]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """[n_seg, C] sums of the rows of ``vals`` [N, C] grouped by ``seg``
    [N], each segment summed in index order. Nothing waits for the card."""
    order = torch.argsort(seg, stable=True)
    lengths = torch.zeros(n_seg, dtype=torch.int64, device=seg.device) \
        .index_add_(0, seg, torch.ones_like(seg))
    return torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    acc = x[..., 0] + 0.0
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def blocked_cumsum(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Inclusive cumsum over the last axis in XLA:CPU's order: sequential
    prefix sums inside blocks of ``block``, the block totals scanned the
    same way (recursively), then each block's exclusive offset added."""
    n = x.shape[-1]
    if n <= block:
        return seq_cumsum(x)
    m = -(-n // block)
    pad = m * block - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    inner = seq_cumsum(xp.reshape(*x.shape[:-1], m, block))
    outer = blocked_cumsum(inner[..., -1], block)
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], -1)
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], m * block)
    return out[..., :n]


def per_tree(v: Any, T: int, dims: int) -> Any:
    """A per-tree hyperparameter (f32 [T] tensor) shaped to broadcast over
    ``dims`` trailing axes; a Python float stays as it is."""
    if isinstance(v, torch.Tensor):
        return v.reshape((T,) + (1,) * dims)
    return v


def tree_bins(bins: torch.Tensor, T: int, per_round: int) -> torch.Tensor:
    """[T, n, d] bins of every tree from bins [n, d] shared by every tree
    or [M, n, d] per model (tree t reads model t // per_round)."""
    if bins.dim() == 2:
        return bins.expand(T, *bins.shape)
    if bins.shape[0] == 1:
        return bins.expand(T, *bins.shape[1:])
    if per_round > 1:
        return bins.repeat_interleave(per_round, dim=0)
    return bins


def hist_plain(vals: torch.Tensor, node: Optional[torch.Tensor],
               bins: Optional[torch.Tensor], n_level: int, n_bins: int,
               per_round: int = 1) -> torch.Tensor:
    """The plain version of :func:`hist`: one stable segment sum over the
    flattened (tree, row, feature) order."""
    T, n, C = vals.shape
    dev = vals.device
    if node is None:
        node = torch.zeros((T, n), dtype=torch.int32, device=dev)
    if bins is None:
        bins = torch.zeros((T, n, 1), dtype=torch.int64, device=dev)
    else:
        bins = tree_bins(bins, T, per_round)
    d = bins.shape[2]
    flat = vals[:, :, None, :].expand(T, n, d, C).reshape(T * n * d, C)
    tree_ids = torch.arange(T, device=dev)[:, None, None]
    feat_ids = torch.arange(d, device=dev)[None, None, :]
    seg = ((tree_ids * n_level + node[:, :, None]) * d + feat_ids) \
        * n_bins + bins
    return segment_sum(flat, seg.reshape(-1), T * n_level * d * n_bins) \
        .reshape(T, n_level, d, n_bins, C)


def split_plain(hist: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                level: int, n_bins: int, reg_lambda: Any,
                min_split_gain: Any, min_child_weight: Any,
                min_child_samples: Any, w_slot: int, c_slot: int) -> None:
    """The plain version of :func:`split`."""
    T, n_level, d = hist.shape[:3]
    lam = per_tree(reg_lambda, T, 3)
    # every channel's cumsum in one pass (elementwise the same sums)
    cum = blocked_cumsum(hist.permute(4, 0, 1, 2, 3))
    tot = cum[..., -1:]
    GL, HL = cum[0], cum[1]
    G, H = tot[0], tot[1]
    GR, HR = G - GL, H - HL

    gain = (GL * GL / (HL + lam)
            + GR * GR / (HR + lam)
            - G * G / (H + lam))
    ok = None
    if w_slot >= 0:
        mcw = per_tree(min_child_weight, T, 3)
        WL, W = cum[w_slot], tot[w_slot]
        WR = W - WL
        ok = (WL >= mcw) & (WR >= mcw)
    if c_slot >= 0:
        mcs = per_tree(min_child_samples, T, 3)
        CL, Ct = cum[c_slot], tot[c_slot]
        CR = Ct - CL
        ok_c = (CL >= mcs) & (CR >= mcs)
        ok = ok_c if ok is None else ok & ok_c
    if ok is not None:
        gain = torch.where(ok, gain, torch.full_like(gain, -torch.inf))
    # never split on the last bin (right side empty by construction)
    gain[..., -1] = -torch.inf

    flat_gain = gain.reshape(T, n_level, d * n_bins)
    best = torch.argmax(flat_gain, dim=2)      # first max, like jnp
    best_gain = torch.gather(flat_gain, 2, best[..., None])[..., 0]
    best_f = best // n_bins
    best_b = best % n_bins
    do_split = best_gain > per_tree(min_split_gain, T, 1)
    best_f = torch.where(do_split, best_f, torch.zeros_like(best_f))
    best_b = torch.where(do_split, best_b, torch.full_like(best_b, n_bins))

    offset = n_level - 1
    feat[:, offset:offset + n_level] = best_f
    thr[:, offset:offset + n_level] = best_b


def route_plain(node: Optional[torch.Tensor], bins: torch.Tensor,
                feat: torch.Tensor, thr: torch.Tensor, level: int,
                per_round: int = 1) -> torch.Tensor:
    """The plain version of :func:`route`."""
    T = feat.shape[0]
    bins = tree_bins(bins, T, per_round)
    n = bins.shape[1]
    if node is None:
        node = torch.zeros((T, n), dtype=torch.int32, device=bins.device)
    offset = (1 << level) - 1
    best_f = feat[:, offset:offset + (1 << level)]
    best_b = thr[:, offset:offset + (1 << level)]
    f_row = torch.gather(best_f, 1, node)
    b_row = torch.gather(best_b, 1, node)
    go_right = torch.gather(bins, 2, f_row[..., None])[..., 0] > b_row
    return node * 2 + go_right.to(torch.int32)


def predict_plain(bins: torch.Tensor, feats: torch.Tensor,
                  thrs: torch.Tensor, leaves: torch.Tensor, depth: int,
                  base: torch.Tensor, multiclass: bool) -> torch.Tensor:
    """The plain version of :func:`predict`."""
    n = bins.shape[0]
    T = feats.shape[1]
    tree_b = bins.expand(T, *bins.shape)
    if multiclass:
        F = base[:, None].expand(T, n).clone()
    else:
        F = torch.full((n,), float(base[0]), dtype=torch.float32,
                       device=bins.device)
    for r in range(feats.shape[0]):
        node = torch.zeros((T, n), dtype=torch.int64, device=bins.device)
        for level in range(depth):
            idx = (1 << level) - 1 + node
            f = torch.gather(feats[r], 1, idx)
            b = torch.gather(thrs[r], 1, idx)
            node = node * 2 + (torch.gather(tree_b, 2, f[..., None])[..., 0]
                               > b).to(torch.int64)
        delta = torch.gather(leaves[r], 1, node)
        F = F + (delta if multiclass else delta[0])
    return F


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dims: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"{dims} dimensions on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _bins_models(bins: torch.Tensor, T: int, per_round: int) -> int:
    """The model count of ``bins`` the kernels index (1: shared)."""
    if bins.dim() == 2 or bins.shape[0] == 1:
        return 1
    if bins.shape[0] * per_round != T:
        raise ValueError(f"gbdt: {bins.shape[0]} bin matrices for {T} trees "
                         f"at {per_round} a round")
    return int(bins.shape[0])


def _launch(name: str, p: ctypes.Structure) -> None:
    build.check(getattr(build.library(), "delphi_" + name)(
        ctypes.addressof(p), build.current_stream()), name)
    _counted(name)


def hist_params(vals: torch.Tensor, node: Optional[torch.Tensor],
                bins: Optional[torch.Tensor], n_level: int, n_bins: int,
                per_round: int = 1):
    """(parameter table, output) of one :func:`hist` launch on the card,
    checked; the output is unfilled."""
    dev = vals.device
    _check("gbdt_hist vals", vals, torch.float32, 3, dev)
    T, n, C = vals.shape
    if not 1 <= C <= MAX_CHANNELS or not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"gbdt_hist: {C} channels and {n_bins} bins (at "
                         f"most {MAX_CHANNELS} and {MAX_BINS})")
    p = HistParams()
    p.n, p.trees, p.levels, p.n_bins, p.channels = n, T, n_level, n_bins, C
    p.per_round, p.d, p.models = per_round, 1, 1
    if node is not None:
        _check("gbdt_hist node", node, torch.int32, 2, dev)
    if bins is not None:
        _check("gbdt_hist bins", bins, torch.int64, bins.dim(), dev)
        p.d = int(bins.shape[-1])
        p.models = _bins_models(bins, T, per_round)
    out = torch.empty((T, n_level, p.d, n_bins, C), dtype=torch.float32,
                      device=dev)
    p.vals, p.node, p.bins, p.out = (vals.data_ptr(), _ptr(node), _ptr(bins),
                                     out.data_ptr())
    return p, out


def hist(vals: torch.Tensor, node: Optional[torch.Tensor],
         bins: Optional[torch.Tensor], n_level: int, n_bins: int,
         per_round: int = 1) -> torch.Tensor:
    """f32 [T, n_level, d, n_bins, C] histograms of ``vals`` [T, n, C]
    (C <= 4 channels) over the rows' nodes ``node`` [T, n] (None: all at
    node 0) and bins ``bins`` ([n, d] shared, or [M, n, d] with tree t
    reading model t // per_round; None: one feature, every row in bin 0,
    the leaf sums)."""
    if not _on_card("gbdt_hist", vals):
        return hist_plain(vals, node, bins, n_level, n_bins, per_round)
    p, out = hist_params(vals, node, bins, n_level, n_bins, per_round)
    if out.numel():
        _launch("gbdt_hist", p)
    return out


def _hyper(p: ctypes.Structure, name: str, v: Any, T: int,
           dev: torch.device) -> None:
    if isinstance(v, torch.Tensor):
        _check(f"gbdt_split {name}", v, torch.float32, 1, dev)
        if v.shape[0] != T:
            raise ValueError(f"gbdt_split: {name} has {v.shape[0]} values "
                             f"for {T} trees")
        setattr(p, name, v.data_ptr())
    else:
        setattr(p, name + "_s", float(v))


def split_params(hist_: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                 level: int, n_bins: int, reg_lambda: Any,
                 min_split_gain: Any, min_child_weight: Any,
                 min_child_samples: Any, w_slot: int, c_slot: int):
    """The parameter table of one :func:`split` launch on the card,
    checked."""
    dev = hist_.device
    _check("gbdt_split hist", hist_, torch.float32, 5, dev)
    T, n_level, d, B, C = hist_.shape
    if B != n_bins or n_level != 1 << level or not 2 <= C <= MAX_CHANNELS \
            or not 1 <= B <= MAX_BINS:
        raise ValueError(f"gbdt_split: histograms {tuple(hist_.shape)} at "
                         f"level {level} with {n_bins} bins")
    for name, t in (("feat", feat), ("thr", thr)):
        _check(f"gbdt_split {name}", t, torch.int64, 2, dev)
        if t.shape[0] != T or t.shape[1] < 2 * n_level - 1:
            raise ValueError(f"gbdt_split: {name} {tuple(t.shape)} for {T} "
                             f"trees at level {level}")
    p = SplitParams()
    for name, v in (("lam", reg_lambda), ("msg", min_split_gain),
                    ("mcw", min_child_weight), ("mcs", min_child_samples)):
        _hyper(p, name, v, T, dev)
    p.hist, p.feat, p.thr = hist_.data_ptr(), feat.data_ptr(), thr.data_ptr()
    p.trees, p.levels, p.d, p.n_bins, p.channels = T, n_level, d, B, C
    p.w_slot, p.c_slot, p.width = w_slot, c_slot, int(feat.shape[1])
    return p


def split(hist_: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
          level: int, n_bins: int, reg_lambda: Any, min_split_gain: Any,
          min_child_weight: Any, min_child_samples: Any,
          w_slot: int, c_slot: int) -> None:
    """Each node's best split from its histograms ``hist_`` [T, 2^level,
    d, n_bins, C] (channel 0 the gradient, 1 the hessian, ``w_slot`` the
    weight, ``c_slot`` the row count; -1: no such mask), written into
    ``feat`` / ``thr`` [T, nodes - 1] (int64) at offset 2^level - 1. Each
    hyperparameter is a float or an f32 [T] tensor."""
    if not _on_card("gbdt_split", hist_):
        return split_plain(hist_, feat, thr, level, n_bins, reg_lambda,
                           min_split_gain, min_child_weight,
                           min_child_samples, w_slot, c_slot)
    p = split_params(hist_, feat, thr, level, n_bins, reg_lambda,
                     min_split_gain, min_child_weight, min_child_samples,
                     w_slot, c_slot)
    if p.trees * p.levels:
        _launch("gbdt_split", p)
    return None


def route_params(node: Optional[torch.Tensor], bins: torch.Tensor,
                 feat: torch.Tensor, thr: torch.Tensor, level: int,
                 per_round: int = 1):
    """(parameter table, output) of one :func:`route` launch on the card,
    checked; the output is unfilled."""
    dev = feat.device
    T, width = feat.shape
    _check("gbdt_route feat", feat, torch.int64, 2, dev)
    _check("gbdt_route thr", thr, torch.int64, 2, dev)
    _check("gbdt_route bins", bins, torch.int64, bins.dim(), dev)
    n, d = int(bins.shape[-2]), int(bins.shape[-1])
    if width < (2 << level) - 1:
        raise ValueError(f"gbdt_route: {width} splits a tree hold no level "
                         f"{level}")
    if node is not None:
        _check("gbdt_route node", node, torch.int32, 2, dev)
    out = torch.empty((T, n), dtype=torch.int32, device=dev)
    p = RouteParams()
    p.node, p.bins, p.feat, p.thr, p.out = (_ptr(node), bins.data_ptr(),
                                            feat.data_ptr(), thr.data_ptr(),
                                            out.data_ptr())
    p.n, p.trees, p.d = n, T, d
    p.offset, p.width = (1 << level) - 1, int(width)
    p.per_round, p.models = per_round, _bins_models(bins, T, per_round)
    return p, out


def route(node: Optional[torch.Tensor], bins: torch.Tensor,
          feat: torch.Tensor, thr: torch.Tensor, level: int,
          per_round: int = 1) -> torch.Tensor:
    """The rows' nodes one level down: ``2 * node + (bins[row, f] > b)``
    with (f, b) the split of the row's node at ``level`` in ``feat`` /
    ``thr`` [T, nodes - 1]; ``node`` (int32) None is every row at node 0.
    A new int32 tensor."""
    if not _on_card("gbdt_route", feat):
        return route_plain(node, bins, feat, thr, level, per_round)
    p, out = route_params(node, bins, feat, thr, level, per_round)
    if out.numel():
        _launch("gbdt_route", p)
    return out


def predict_params(bins: torch.Tensor, feats: torch.Tensor,
                   thrs: torch.Tensor, leaves: torch.Tensor, depth: int,
                   base: torch.Tensor, multiclass: bool):
    """(parameter table, [T, n] output) of one :func:`predict` launch on
    the card, checked; the output is unfilled."""
    dev = bins.device
    _check("gbdt_predict bins", bins, torch.int64, 2, dev)
    _check("gbdt_predict feats", feats, torch.int64, 3, dev)
    _check("gbdt_predict thrs", thrs, torch.int64, 3, dev)
    _check("gbdt_predict leaves", leaves, torch.float32, 3, dev)
    _check("gbdt_predict base", base, torch.float32, 1, dev)
    R, T, width = feats.shape
    if width != (1 << depth) - 1 or tuple(thrs.shape) != (R, T, width) \
            or tuple(leaves.shape) != (R, T, width + 1) \
            or (multiclass and base.shape[0] != T) \
            or (not multiclass and T != 1):
        raise ValueError(f"gbdt_predict: trees {tuple(feats.shape)}, "
                         f"{tuple(thrs.shape)}, {tuple(leaves.shape)} and "
                         f"base {tuple(base.shape)} at depth {depth}")
    n, d = bins.shape
    if not 1 <= d <= PREDICT_MAX_FEATURES or not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"gbdt_predict: {d} features at depth {depth} (at "
                         f"most {PREDICT_MAX_FEATURES} features, the widest "
                         f"rows whose bins one warp's 32 rows stage, and "
                         f"depth {MAX_DEPTH})")
    out = torch.empty((T, n), dtype=torch.float32, device=dev)
    p = PredictParams()
    p.bins, p.feats, p.thrs, p.leaves, p.base, p.out = (
        bins.data_ptr(), feats.data_ptr(), thrs.data_ptr(),
        leaves.data_ptr(), base.data_ptr(), out.data_ptr())
    p.n, p.trees, p.d, p.rounds, p.depth = n, T, d, R, depth
    return p, out


def predict(bins: torch.Tensor, feats: torch.Tensor, thrs: torch.Tensor,
            leaves: torch.Tensor, depth: int, base: torch.Tensor,
            multiclass: bool) -> torch.Tensor:
    """Margins of boosted trees: ``bins`` int64 [n, d], ``feats`` /
    ``thrs`` int64 [R, T, 2^depth - 1], ``leaves`` f32 [R, T, 2^depth],
    ``base`` f32 [T] per class tree ([1] otherwise). Returns f32 [T, n]
    when ``multiclass``, else [n] (T is 1). The bins are the binner's
    codes, in [0, MAX_BINS) (``models/gbdt.py`` ``_Binner`` emits at most
    ``max_bin``, itself at most 63): the card's kernel reads a bin as a
    byte (rows of four features or fewer) or a 16-bit word, so a bin
    outside that range gives another margin than the plain version."""
    if not _on_card("gbdt_predict", bins):
        return predict_plain(bins, feats, thrs, leaves, depth, base,
                             multiclass)
    p, out = predict_params(bins, feats, thrs, leaves, depth, base,
                            multiclass)
    if out.numel():
        _launch("gbdt_predict", p)
    return out if multiclass else out[0]
