"""K10: the logistic head's gather route and the Adam step
(``csrc/linear.cu``), and their plain PyTorch versions.

The JAX package jits each fit of its heads as one XLA program, a
``lax.while_loop`` over ``jax.value_and_grad`` and ``optax.adam``
(``delphi_tpu/models/linear.py``: ``_fit_logreg_gather`` :118, the
dense and MLP fits :58, :194); not Pallas. The port runs the loop on the
host and each step of the gather route as three launches and one
readback of the loss:

* :func:`logreg_forward` (K10a; replaces the loss of
  ``_fit_logreg_gather``, :137-143): per row the logits ``Wcat[gid[r,
  0]] + ... + Wcat[gid[r, F-1]]``, then ``+ cont[r, j] * Wcont[j]`` for
  each continuous column in order, then ``+ b``; their maximum; ``e_c =
  exp(logit_c - max)`` in f64 rounded to f32 (the CPU's and the card's
  f32 ``exp`` differ in the last ulp, their rounded f64 values almost
  never); ``Z`` the sum of the ``e_c`` over the adjacent-pair tree of the
  classes padded with zeros to a power of two (:func:`pairwise_sum`);
  the row's loss ``w_r * (log Z - (logit_y - max))`` (``log`` in f64
  rounded to f32); ``dlogits = (w_r / denom) * (e / Z - onehot(y))``.
  The loss is ``tree_sum(row losses) / denom + l2 * (tree_sum(Wcat *
  Wcat) + tree_sum(Wcont * Wcont))``, written to ``loss[0]``.
* :func:`logreg_backward` (K10b; replaces the same loss's
  ``jax.value_and_grad``, :155): ``gWcat[v]`` is 0.0 plus ``dlogits`` of
  each of v's occurrences in row-major order, one after the other, then
  ``+ (t + t)`` with ``t = l2 * Wcat[v]`` (an id with no occurrence gets
  its L2 term only); ``gWcont[j] = xla_sum over rows of cont[:, j] *
  dlogits + (t + t)``; ``gb = xla_sum over rows of dlogits``. The
  occurrence walk is the order of the JAX package's scatter-add, and
  :func:`xla_sum` that of its reductions over rows, so each tie between
  two classes that rounding alone decides falls closer to the JAX
  package's way.
* :func:`adam_step` (K10c; replaces ``optax.adam`` :133, :156-157, and
  :63, :206 of the dense and MLP fits): in f32, ``mu = fma(1 - b1, g, b1
  mu)``; ``nu = fma(1 - b2, g g, b2 nu)``; ``p = fma(mu / (bc1 (sqrt(nu /
  bc2) + eps)), -lr, p)``. That is the arithmetic XLA:CPU compiles optax
  0.2.6's update into (its simplifier turns ``(mu / bc1) / d`` into ``mu /
  (bc1 d)``, and LLVM fuses each multiply feeding an add), so the JAX
  package's parameters come out bit for bit. ``bc1`` and ``bc2`` come from
  :func:`bias_corrections` on the host; the plain version's fused
  multiply-add is exact (:func:`_fma`).

:func:`tree_sum` is K10a's fixed order of the long sums: the last axis
padded with zeros to a multiple of :data:`TILE`, each tile summed by
halving (``x[:16] + x[16:32]``, then 8, 4, 2, 1: a warp's shuffle
tree), and the tile sums summed the same way until one is left. Every
summand it takes is at least +0.0 (squares, ``w * nll``), so padding
never changes a bit. K10b's row sums take :func:`xla_sum` instead.

Every wrapper writes into the tensors it is given (views into the fit's
flat buffers, ``models/linear.py``). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Every kernel
returns the plain version's bits on the same device: the plain versions
divide only by tensors (PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal) and take f32 ``sqrt`` through f64 (the
CPU's vectorized f32 ``sqrt`` is not correctly rounded).

Each wrapper adds one to ``launches[name]`` where it launches, and
nowhere else. Nothing in a call copies to or waits for the device.
"""

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from delphi_tpu_torch.ops.kernels import build

# Launches of each CUDA kernel since the last reset. Requests served in
# threads launch side by side, so the counts move under a lock.
launches = {"logreg_forward": 0, "logreg_backward": 0, "adam_step": 0}
_count_lock = threading.Lock()

TILE = 32               # csrc: kTile, the fan-in of tree_sum (a warp)
ROWS_PER_BLOCK = 32     # K10a's rows an item (one tile of tree_sum)
WEIGHTS_PER_BLOCK = TILE * TILE  # K10a's squared weights an item
MAX_CLASSES = 1 << 16   # csrc: kMaxClasses (the class tree's stack)
RING_STAGE = 256        # csrc: kOcc, K10b's occurrences a ring stage
WIDE_CLASSES = 64       # csrc: kWideClasses, K10b a block an id from here
WEIGHT_SMEM = 44 * 1024  # csrc: kWeightSmem, K10a's staged weights up to this

B1, B2, EPS = 0.9, 0.999, 1e-8
# optax's constants as f32: 1 - b taken in Python first
_C1, _C2 = float(np.float32(1 - B1)), float(np.float32(1 - B2))
_B1, _B2, _EPS = float(np.float32(B1)), float(np.float32(B2)), \
    float(np.float32(EPS))


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _counted(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def bias_corrections(t: int) -> Tuple[float, float]:
    """optax's ``1 - b ** count`` of step ``t`` (its int32 count after the
    increment) for b1 and b2, in f32 as XLA computes them: f32(b) to the
    power f32(t), subtracted from 1."""
    t32 = np.float32(t)
    return (float(np.float32(1.0) - np.float32(B1) ** t32),
            float(np.float32(1.0) - np.float32(B2) ** t32))


class ForwardParams(ctypes.Structure):
    """The layout of ``ForwardParams`` in ``csrc/linear.cu`` (136 bytes)."""
    _fields_ = [("gid", ctypes.c_void_p), ("cont", ctypes.c_void_p),
                ("y", ctypes.c_void_p), ("sample_w", ctypes.c_void_p),
                ("wcat", ctypes.c_void_p), ("wcont", ctypes.c_void_p),
                ("b", ctypes.c_void_p), ("loss", ctypes.c_void_p),
                ("dlogits", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("n_cat", ctypes.c_int64), ("n_cont", ctypes.c_int64),
                ("f", ctypes.c_int32), ("c", ctypes.c_int32),
                ("k", ctypes.c_int32), ("denom", ctypes.c_float),
                ("l2", ctypes.c_float), ("pad", ctypes.c_int32)]


class BackwardParams(ctypes.Structure):
    """The layout of ``BackwardParams`` in ``csrc/linear.cu`` (112 bytes)."""
    _fields_ = [("dlogits", ctypes.c_void_p), ("cont", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("wcat", ctypes.c_void_p), ("wcont", ctypes.c_void_p),
                ("gwcat", ctypes.c_void_p), ("gwcont", ctypes.c_void_p),
                ("gb", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("vocab", ctypes.c_int32), ("c", ctypes.c_int32),
                ("k", ctypes.c_int32), ("l2", ctypes.c_float)]


class AdamParams(ctypes.Structure):
    """The layout of ``AdamParams`` in ``csrc/linear.cu`` (72 bytes)."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("n", ctypes.c_int64), ("c1", ctypes.c_float),
                ("b1", ctypes.c_float), ("c2", ctypes.c_float),
                ("b2", ctypes.c_float), ("bc1", ctypes.c_float),
                ("bc2", ctypes.c_float), ("eps", ctypes.c_float),
                ("neg_lr", ctypes.c_float)]


@dataclass
class GatherPlan:
    """What every step of one gather fit reads: the design on the device
    (``gid`` int64 [n, F] global vocabulary ids, ``cont`` f32 [n, C],
    ``y`` int64 [n], ``sample_w`` f32 [n]), the f32 ``denom`` and ``l2``,
    K10b's occurrence plan (``rows`` int64 [n F]: the row of each
    occurrence, vocabulary ids ascending and row-major within one;
    ``lengths`` / ``offsets`` int64 [V] / [V + 1]: each id's occurrences
    and where they start) and, on the card, the kernels' scratch (tree
    partials, and two tickets that are 0 between launches)."""
    gid: torch.Tensor
    cont: torch.Tensor
    y: torch.Tensor
    sample_w: torch.Tensor
    denom: float
    l2: float
    n_vocab: int
    k: int
    rows: torch.Tensor
    lengths: torch.Tensor
    offsets: torch.Tensor
    fwd_partials: Optional[torch.Tensor] = None
    bwd_partials: Optional[torch.Tensor] = None
    tickets: Optional[torch.Tensor] = None


def _blocks(n: int, per: int) -> int:
    return -(-n // per)


def gather_plan(gid: torch.Tensor, cont: torch.Tensor, y: torch.Tensor,
                sample_w: torch.Tensor, denom: float, l2: float,
                n_vocab: int, k: int) -> GatherPlan:
    """The plan of one fit, made once on ``gid``'s device (a stable sort
    of the flattened ids; no wait for the device)."""
    n, F = gid.shape
    if n < 1 or F < 1 or n_vocab < 1 or not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"logreg: {n} rows, {F} categorical features, "
                         f"{n_vocab} ids and {k} classes (at least one of "
                         f"each, at most {MAX_CLASSES} classes)")
    dev = gid.device
    flat = gid.reshape(-1)
    order = torch.argsort(flat, stable=True)
    lengths = torch.zeros(n_vocab, dtype=torch.int64, device=dev) \
        .index_add_(0, flat, torch.ones_like(flat))
    offsets = torch.zeros(n_vocab + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lengths, 0, out=offsets[1:])
    plan = GatherPlan(gid=gid, cont=cont, y=y, sample_w=sample_w,
                      denom=float(np.float32(denom)),
                      l2=float(np.float32(l2)), n_vocab=n_vocab, k=k,
                      rows=order // F, lengths=lengths, offsets=offsets)
    if dev.type == "cuda":
        C = cont.shape[1]
        plan.fwd_partials = torch.empty(
            _blocks(n, ROWS_PER_BLOCK)
            + _blocks(n_vocab * k, WEIGHTS_PER_BLOCK)
            + _blocks(C * k, WEIGHTS_PER_BLOCK), dtype=torch.float32,
            device=dev)
        plan.bwd_partials = torch.empty(_blocks(n, TILE) * (C + 1) * k,
                                        dtype=torch.float32, device=dev)
        plan.tickets = torch.zeros(2, dtype=torch.int32, device=dev)
    return plan


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in the kernels' fixed order: padded with
    zeros to a multiple of :data:`TILE`, each tile halved down to one
    value (``x[:s] + x[s:2s]`` for s = 16, 8, 4, 2, 1), and again over the
    tile sums until one tile is left (at least one level, so an empty or
    one-long axis sums to its value plus zeros)."""
    while True:
        L = x.shape[-1]
        tiles = max(_blocks(L, TILE), 1)
        if tiles * TILE != L:
            x = torch.nn.functional.pad(x, (0, tiles * TILE - L))
        x = x.reshape(*x.shape[:-1], tiles, TILE)
        s = TILE // 2
        while s:
            x = x[..., :s] + x[..., s:2 * s]
            s //= 2
        x = x[..., 0]
        if tiles == 1:
            return x[..., 0]


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in XLA:CPU's order for a long reduction
    (the JAX package's ``.sum()``; equal to ``jax.jit`` sums bit for bit):
    while more than :data:`TILE` values are left, windows of TILE values,
    the axis padded with zeros split between its front (half, rounded
    down) and its back, each summed one value after another from 0.0;
    then the last at most TILE values the same way. K10b's row sums."""
    L = x.shape[-1]
    while L > TILE:
        tiles = _blocks(L, TILE)
        pad = tiles * TILE - L
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)) \
            .reshape(*x.shape[:-1], tiles, TILE)
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(TILE):
            acc = acc + x[..., i]
        x, L = acc, tiles
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(L):
        acc = acc + x[..., i]
    return acc


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis by adjacent pairs (``x[0::2] +
    x[1::2]``), the axis padded with zeros to a power of two: K10a's
    class tree (a warp's butterfly over 32 classes, then the chunks'
    sums the same way)."""
    k = x.shape[-1]
    width = 1 << (k - 1).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device: an operand that PyTorch's
    CUDA division takes as a tensor, not as a reciprocal."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def logreg_forward_plain(plan: GatherPlan, Wcat: torch.Tensor,
                         Wcont: torch.Tensor, b: torch.Tensor,
                         loss: torch.Tensor, dlogits: torch.Tensor) -> None:
    """The plain version of :func:`logreg_forward`."""
    gid, cont = plan.gid, plan.cont
    logits = Wcat[gid[:, 0]]
    for f in range(1, gid.shape[1]):
        logits = logits + Wcat[gid[:, f]]
    for j in range(cont.shape[1]):
        logits = logits + cont[:, j:j + 1] * Wcont[j]
    logits = logits + b
    d = logits - logits.amax(dim=1, keepdim=True)
    e = _exp(d)
    Z = pairwise_sum(e)
    nll = _log(Z) - d.gather(1, plan.y[:, None])[:, 0]
    denom = _scalar(plan.denom, e)
    sq = tree_sum((Wcat * Wcat).reshape(-1))
    if Wcont.numel():
        sq = sq + tree_sum((Wcont * Wcont).reshape(-1))
    total = tree_sum(plan.sample_w * nll) / denom + _scalar(plan.l2, e) * sq
    loss.copy_(total.reshape(1))
    onehot = torch.zeros_like(e).scatter_(1, plan.y[:, None], 1.0)
    dlogits.copy_((plan.sample_w / denom)[:, None] * (e / Z[:, None] - onehot))


def logreg_backward_plain(plan: GatherPlan, dlogits: torch.Tensor,
                          Wcat: torch.Tensor, Wcont: torch.Tensor,
                          gWcat: torch.Tensor, gWcont: torch.Tensor,
                          gb: torch.Tensor) -> None:
    """The plain version of :func:`logreg_backward`."""
    seg = torch.segment_reduce(dlogits[plan.rows], "sum",
                               lengths=plan.lengths, axis=0, unsafe=True)
    l2 = _scalar(plan.l2, dlogits)
    t = l2 * Wcat
    gWcat.copy_(seg + (t + t))
    for j in range(plan.cont.shape[1]):
        t = l2 * Wcont[j]
        gWcont[j].copy_(xla_sum((plan.cont[:, j:j + 1] * dlogits).T)
                        + (t + t))
    gb.copy_(xla_sum(dlogits.T))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (a fused multiply-add, as
    ``__fmaf_rn``), exactly: the product of two f32 values is exact in
    f64, the f64 sum is rounded to odd (its TwoSum error decides), and an
    f64 value rounded to odd rounds to the correct f32."""
    p = a.double() * b
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even & torch.isfinite(s)
    s = torch.where(bump, torch.nextafter(s, s + err), s)
    return s.float()


def adam_step_plain(params: torch.Tensor, grads: torch.Tensor,
                    mu: torch.Tensor, nu: torch.Tensor, lr: float,
                    t: int) -> None:
    """The plain version of :func:`adam_step`."""
    bc1, bc2 = bias_corrections(t)
    mu.copy_(_fma(grads, _C1, mu * _B1))
    nu.copy_(_fma(grads * grads, _C2, nu * _B2))
    root = torch.sqrt((nu / _scalar(bc2, nu)).double()).float()
    u = mu / (_scalar(bc1, mu) * (root + _EPS))
    params.copy_(_fma(u, float(np.float32(-lr)), params))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _launch(name: str, p: ctypes.Structure) -> None:
    build.check(getattr(build.library(), "delphi_" + name)(
        ctypes.addressof(p), build.current_stream()), name)
    _counted(name)


def _check_plan(name: str, plan: GatherPlan, dev: torch.device) -> None:
    n, F = plan.gid.shape
    _check(f"{name} gid", plan.gid, torch.int64, (n, F), dev)
    _check(f"{name} cont", plan.cont, torch.float32,
           (n, plan.cont.shape[1]), dev)
    _check(f"{name} y", plan.y, torch.int64, (n,), dev)
    _check(f"{name} sample_w", plan.sample_w, torch.float32, (n,), dev)
    if plan.tickets is None:
        raise ValueError(f"{name}: a plan made for the CPU")


def _check_weights(name: str, plan: GatherPlan, Wcat: torch.Tensor,
                   Wcont: torch.Tensor, dev: torch.device) -> None:
    k, C = plan.k, plan.cont.shape[1]
    _check(f"{name} Wcat", Wcat, torch.float32, (plan.n_vocab, k), dev)
    _check(f"{name} Wcont", Wcont, torch.float32, (C, k), dev)


def forward_params(plan: GatherPlan, Wcat: torch.Tensor, Wcont: torch.Tensor,
                   b: torch.Tensor, loss: torch.Tensor,
                   dlogits: torch.Tensor) -> ForwardParams:
    """The parameter table of one :func:`logreg_forward` launch, checked."""
    dev = Wcat.device
    _check_plan("logreg_forward", plan, dev)
    _check_weights("logreg_forward", plan, Wcat, Wcont, dev)
    n, F = plan.gid.shape
    k, C = plan.k, plan.cont.shape[1]
    _check("logreg_forward b", b, torch.float32, (k,), dev)
    _check("logreg_forward loss", loss, torch.float32, (1,), dev)
    _check("logreg_forward dlogits", dlogits, torch.float32, (n, k), dev)
    p = ForwardParams()
    p.gid, p.cont, p.y = (plan.gid.data_ptr(), plan.cont.data_ptr(),
                          plan.y.data_ptr())
    p.sample_w, p.wcat = plan.sample_w.data_ptr(), Wcat.data_ptr()
    p.wcont, p.b = Wcont.data_ptr(), b.data_ptr()
    p.loss, p.dlogits = loss.data_ptr(), dlogits.data_ptr()
    p.partials, p.ticket = (plan.fwd_partials.data_ptr(),
                            plan.tickets.data_ptr())
    p.n, p.n_cat, p.n_cont = n, plan.n_vocab * k, C * k
    p.f, p.c, p.k = F, C, k
    p.denom, p.l2 = plan.denom, plan.l2
    return p


def logreg_forward(plan: GatherPlan, Wcat: torch.Tensor,
                   Wcont: torch.Tensor, b: torch.Tensor, loss: torch.Tensor,
                   dlogits: torch.Tensor) -> None:
    """K10a: the gather route's loss into ``loss`` (f32 [1]) and its
    gradient with respect to the logits into ``dlogits`` (f32 [n, k]),
    from ``Wcat`` [V, k], ``Wcont`` [C, k] and ``b`` [k]."""
    if not _on_card("logreg_forward", Wcat):
        return logreg_forward_plain(plan, Wcat, Wcont, b, loss, dlogits)
    _launch("logreg_forward",
            forward_params(plan, Wcat, Wcont, b, loss, dlogits))
    return None


def backward_params(plan: GatherPlan, dlogits: torch.Tensor,
                    Wcat: torch.Tensor, Wcont: torch.Tensor,
                    gWcat: torch.Tensor, gWcont: torch.Tensor,
                    gb: torch.Tensor) -> BackwardParams:
    """The parameter table of one :func:`logreg_backward` launch,
    checked."""
    dev = dlogits.device
    _check_plan("logreg_backward", plan, dev)
    _check_weights("logreg_backward", plan, Wcat, Wcont, dev)
    n = plan.gid.shape[0]
    k, C, V = plan.k, plan.cont.shape[1], plan.n_vocab
    _check("logreg_backward dlogits", dlogits, torch.float32, (n, k), dev)
    _check("logreg_backward rows", plan.rows, torch.int64,
           (n * plan.gid.shape[1],), dev)
    _check("logreg_backward offsets", plan.offsets, torch.int64, (V + 1,),
           dev)
    _check("logreg_backward gWcat", gWcat, torch.float32, (V, k), dev)
    _check("logreg_backward gWcont", gWcont, torch.float32, (C, k), dev)
    _check("logreg_backward gb", gb, torch.float32, (k,), dev)
    p = BackwardParams()
    p.dlogits, p.cont = dlogits.data_ptr(), plan.cont.data_ptr()
    p.rows, p.offsets = plan.rows.data_ptr(), plan.offsets.data_ptr()
    p.wcat, p.wcont = Wcat.data_ptr(), Wcont.data_ptr()
    p.gwcat, p.gwcont, p.gb = gWcat.data_ptr(), gWcont.data_ptr(), \
        gb.data_ptr()
    p.partials, p.ticket = (plan.bwd_partials.data_ptr(),
                            plan.tickets.data_ptr() + 4)
    p.n, p.vocab, p.c, p.k, p.l2 = n, V, C, k, plan.l2
    return p


def logreg_backward(plan: GatherPlan, dlogits: torch.Tensor,
                    Wcat: torch.Tensor, Wcont: torch.Tensor,
                    gWcat: torch.Tensor, gWcont: torch.Tensor,
                    gb: torch.Tensor) -> None:
    """K10b: the gradients of K10a's loss with respect to ``Wcat``,
    ``Wcont`` and ``b`` into ``gWcat``, ``gWcont`` and ``gb``, from its
    ``dlogits``."""
    if not _on_card("logreg_backward", dlogits):
        return logreg_backward_plain(plan, dlogits, Wcat, Wcont, gWcat,
                                     gWcont, gb)
    _launch("logreg_backward", backward_params(plan, dlogits, Wcat, Wcont,
                                               gWcat, gWcont, gb))
    return None


def adam_params(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, lr: float, t: int) -> AdamParams:
    """The parameter table of one :func:`adam_step` launch, checked."""
    dev = params.device
    shape = (params.numel(),)
    for name, x in (("params", params), ("grads", grads), ("mu", mu),
                    ("nu", nu)):
        _check(f"adam_step {name}", x, torch.float32, shape, dev)
    if t < 1:
        raise ValueError(f"adam_step: step {t} (counted from 1)")
    bc1, bc2 = bias_corrections(t)
    p = AdamParams()
    p.p, p.g, p.mu, p.nu = (params.data_ptr(), grads.data_ptr(),
                            mu.data_ptr(), nu.data_ptr())
    p.n = shape[0]
    p.c1, p.b1, p.c2, p.b2, p.eps = _C1, _B1, _C2, _B2, _EPS
    p.bc1, p.bc2, p.neg_lr = bc1, bc2, float(np.float32(-lr))
    return p


def adam_step(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, lr: float, t: int) -> None:
    """K10c: Adam's ``t``-th update (t counted from 1) of the flat f32
    ``params`` in place, from ``grads``, with the moments ``mu`` and
    ``nu`` updated in place."""
    if not _on_card("adam_step", params):
        return adam_step_plain(params, grads, mu, nu, lr, t)
    p = adam_params(params, grads, mu, nu, lr, t)
    if p.n:
        _launch("adam_step", p)
    return None
