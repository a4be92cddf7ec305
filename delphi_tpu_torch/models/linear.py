"""Linear / MLP repair-model heads in PyTorch — the port of the JAX
package's ``models/linear.py`` (without its mesh path).

The classifier is a class-weighted multinomial logistic regression over
the one-hot features, the regressor a small MLP; both train full-batch
with Adam (``torch.optim.Adam``, optax's ``adam`` update rule) and stop
once the loss plateaus (the JAX package's ``while_loop`` rule, read on the
host after every step). The logistic head trains on the factored one-hot
design (:class:`OneHotDesign`) as an embedding gather whose backward is a
fixed-order segment sum, so two fits on the card are bit-identical; a
dense design trains with one matmul.

Rows are not padded: padded rows carry zero weight and padded vocabulary
or feature columns only feel the L2 pull from zero, so they change
nothing. The class axis IS padded exactly as in the JAX package (to a
multiple of 8): padded classes stay in the softmax denominator.

They expose the scikit-learn-like duck type (``classes_`` / ``predict`` /
``predict_proba``) the repair pipeline expects.
"""

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.models.encoding import (OneHotDesign,
                                              balanced_class_weights)
from delphi_tpu_torch.ops.xfer import to_device
from delphi_tpu_torch.parallel import planner


def _pad_cols(X: np.ndarray) -> np.ndarray:
    """Pads the feature axis to the next power of two (at least 8), as the
    JAX package does: the MLP's initial scale depends on the padded width,
    and JAX-fitted dense weights carry the padded rows."""
    d = X.shape[1]
    target = planner.pow2_pad(d, floor=8)
    if target == d:
        return X
    return np.concatenate(
        [X, np.zeros((X.shape[0], target - d), X.dtype)], axis=1)


def _adam_until_plateau(params: List[torch.Tensor],
                        loss_fn: Callable[[], torch.Tensor], lr: float,
                        n_steps: int, min_steps: int, tol: float) \
        -> Tuple[int, float]:
    """Full-batch Adam steps until ``n_steps`` or, from step ``min_steps``,
    until ``|prev - cur| <= tol * (1 + |cur|)`` (f32, as the JAX package's
    ``while_loop`` condition). Each step applies one update and records the
    loss it was computed at. Reading that loss waits for the device once a
    step. Returns (updates applied, last loss)."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    tol32 = np.float32(tol)
    prev = cur = np.float32(np.inf)
    i = 0
    while i < n_steps and (
            i < min_steps or np.abs(prev - cur) > tol32 * (np.float32(1.0)
                                                           + np.abs(cur))):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        i += 1
        prev, cur = cur, np.float32(loss.item())
    return i, float(cur)


class _GatherSum(torch.autograd.Function):
    """``Wcat[gid].sum(1)`` ([n, k]) with a fixed-order backward: the
    gradient of each vocabulary row is the sum of its (row, feature)
    occurrences in row-major order (a stable sort by id, then
    ``segment_reduce``), never float atomics."""

    @staticmethod
    def forward(ctx: Any, Wcat: torch.Tensor, gid: torch.Tensor,
                rows_sorted: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(rows_sorted, lengths)
        return Wcat[gid].sum(dim=1)

    @staticmethod
    def backward(ctx: Any, grad_out: torch.Tensor) -> Tuple[Any, ...]:
        rows_sorted, lengths = ctx.saved_tensors
        grad = torch.segment_reduce(grad_out[rows_sorted], "sum",
                                    lengths=lengths, axis=0, unsafe=True)
        return grad, None, None, None


def _gather_plan(gid: torch.Tensor, n_vocab: int) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """(row of each occurrence in vocabulary-sorted order, occurrences per
    vocabulary id) for :class:`_GatherSum`'s backward, made once a fit."""
    flat = gid.reshape(-1)
    order = torch.argsort(flat, stable=True)
    lengths = torch.zeros(n_vocab, dtype=torch.int64, device=gid.device) \
        .index_add_(0, flat, torch.ones_like(flat))
    return order // gid.shape[1], lengths


def _nll(logits: torch.Tensor, y: torch.Tensor, sample_w: torch.Tensor,
         denom: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None])[:, 0]
    return (sample_w * nll).sum() / denom


def _fit_logreg(X: torch.Tensor, y: torch.Tensor, class_weights: torch.Tensor,
                l2: float, lr: float, n_steps: int) \
        -> Tuple[Tuple[torch.Tensor, ...], float, int]:
    """Dense logistic head: logits = X @ W + b. Returns ((W, b), last loss,
    updates applied)."""
    d, k = X.shape[1], class_weights.shape[0]
    W = torch.zeros((d, k), dtype=torch.float32, device=X.device,
                    requires_grad=True)
    b = torch.zeros((k,), dtype=torch.float32, device=X.device,
                    requires_grad=True)
    sample_w = class_weights[y]
    denom = torch.clamp_min(sample_w.sum(), 1.0)

    def loss_fn() -> torch.Tensor:
        return _nll(X @ W + b, y, sample_w, denom) + l2 * torch.sum(W * W)

    steps, loss = _adam_until_plateau([W, b], loss_fn, lr, n_steps, 20, 1e-6)
    return (W.detach(), b.detach()), loss, steps


def _fit_logreg_gather(gid: torch.Tensor, cont: torch.Tensor, y: torch.Tensor,
                       class_weights: torch.Tensor, l2: float, lr: float,
                       n_steps: int, n_vocab: int) \
        -> Tuple[Tuple[torch.Tensor, ...], float, int]:
    """The logistic head on the factored one-hot design: ``X @ W`` over a
    block-one-hot matrix is an embedding gather (``gid`` [n, F] global
    vocabulary ids), plus the continuous columns' matmul. Same objective,
    weights and exit rule as :func:`_fit_logreg`. Returns ((Wcat, Wcont,
    b), last loss, updates applied)."""
    k = class_weights.shape[0]
    dev = gid.device
    Wcat = torch.zeros((n_vocab, k), dtype=torch.float32, device=dev,
                       requires_grad=True)
    Wcont = torch.zeros((cont.shape[1], k), dtype=torch.float32, device=dev,
                        requires_grad=True)
    b = torch.zeros((k,), dtype=torch.float32, device=dev, requires_grad=True)
    sample_w = class_weights[y]
    denom = torch.clamp_min(sample_w.sum(), 1.0)
    rows_sorted, lengths = _gather_plan(gid, n_vocab)

    def loss_fn() -> torch.Tensor:
        logits = _GatherSum.apply(Wcat, gid, rows_sorted, lengths) + b
        if cont.shape[1]:
            logits = logits + cont @ Wcont
        return _nll(logits, y, sample_w, denom) \
            + l2 * (torch.sum(Wcat * Wcat) + torch.sum(Wcont * Wcont))

    steps, loss = _adam_until_plateau([Wcat, Wcont, b], loss_fn, lr, n_steps,
                                      20, 1e-6)
    return (Wcat.detach(), Wcont.detach(), b.detach()), loss, steps


def _mlp_init(d: int, hidden: int, seed: int) -> Dict[str, torch.Tensor]:
    """He-scaled normal weights from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same draw on every device), zero biases."""
    g = torch.Generator().manual_seed(int(seed))

    def normal(shape: Tuple[int, int], fan_in: int) -> torch.Tensor:
        return torch.randn(shape, generator=g, dtype=torch.float32) \
            * math.sqrt(2.0 / max(fan_in, 1))

    return {"w1": normal((d, hidden), d), "b1": torch.zeros(hidden),
            "w2": normal((hidden, hidden), hidden), "b2": torch.zeros(hidden),
            "w3": normal((hidden, 1), hidden), "b3": torch.zeros(1)}


def _mlp_forward(params: Dict[str, torch.Tensor],
                 X: torch.Tensor) -> torch.Tensor:
    h = torch.relu(X @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"] + params["b3"])[:, 0]


def _fit_mlp_regressor(X: torch.Tensor, y: torch.Tensor, l2: float, lr: float,
                       n_steps: int, hidden: int, seed: int,
                       init: Optional[Dict[str, Any]] = None) \
        -> Tuple[Dict[str, torch.Tensor], float, int]:
    """Full-batch Adam on the MLP's MSE plus L2 on its weights, from
    ``init`` (numpy or tensors; e.g. another package's initial draw) or
    :func:`_mlp_init`. Returns (params, last loss, updates applied)."""
    start = init if init is not None else _mlp_init(X.shape[1], hidden, seed)
    # a copy: Adam updates in place and must not write into ``init``
    params = {name: torch.tensor(np.asarray(v), dtype=torch.float32,
                                 device=X.device, requires_grad=True)
              for name, v in start.items()}
    denom = float(max(X.shape[0], 1))

    def loss_fn() -> torch.Tensor:
        mse = ((_mlp_forward(params, X) - y) ** 2).sum() / denom
        reg = sum(torch.sum(params[w] ** 2) for w in ("w1", "w2", "w3"))
        return mse + l2 * reg

    # non-convex objective: only a near-exact plateau stops early
    steps, loss = _adam_until_plateau(list(params.values()), loss_fn, lr,
                                      n_steps, 50, 1e-7)
    return {k: v.detach() for k, v in params.items()}, loss, steps


class LogisticRegressionModel:
    """Multinomial logistic regression with balanced class weights."""

    def __init__(self, n_steps: int = 300, lr: float = 0.2, l2: float = 1e-4) -> None:
        self.n_steps = n_steps
        self.lr = lr
        self.l2 = l2
        self._params: Optional[Tuple[np.ndarray, ...]] = None
        self._classes: Optional[np.ndarray] = None
        self._compact: Optional[Dict[str, Any]] = None
        self.loss_: float = 0.0
        self.n_steps_run_: int = 0

    @property
    def classes_(self) -> np.ndarray:
        assert self._classes is not None
        return self._classes

    def fit(self, X: Any, y: "pd.Series") -> "LogisticRegressionModel":
        codes, classes = pd.factorize(np.asarray(y), sort=True)
        assert (codes >= 0).all(), "y must not contain NULLs"
        self._classes = np.asarray(classes)
        k = len(classes)
        # the class axis pads to a multiple of 8 as in the JAX package:
        # padded classes have weight 0 and are never a label, but they stay
        # in the softmax denominator
        k_pad = max(8, -(-k // 8) * 8)
        counts = np.bincount(codes, minlength=k_pad).astype(np.float32)
        class_weights = np.zeros(k_pad, np.float32)
        class_weights[:k] = balanced_class_weights(
            counts[:k], len(codes), damped=False)
        cw = to_device(class_weights)
        y_d = to_device(codes, torch.int64)

        self._compact = None
        if isinstance(X, OneHotDesign) and X.cat_idx.shape[1] > 0:
            sizes = np.asarray(X.cat_sizes, np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes[:-1])])
            gid = to_device(offsets[None, :] + X.cat_idx, torch.int64)
            params, loss, steps = _fit_logreg_gather(
                gid, to_device(X.cont, torch.float32), y_d, cw, self.l2,
                self.lr, self.n_steps, int(sizes.sum()))
            self._compact = {"offsets": offsets, "sizes": sizes,
                             "layout": X.layout, "width": X.width}
        else:
            if isinstance(X, OneHotDesign):
                X = X.dense()
            params, loss, steps = _fit_logreg(
                to_device(np.asarray(X, np.float32)), y_d, cw, self.l2,
                self.lr, self.n_steps)
        self._params = tuple(p.cpu().numpy() for p in params)
        self.loss_, self.n_steps_run_ = loss, steps
        return self

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "LogisticRegressionModel":
        """A fitted model from numpy arrays: ``classes``, ``params`` ((W, b)
        dense, or (Wcat, Wcont, b) with ``compact`` = {offsets, sizes,
        layout, width}); JAX-padded rows and columns are accepted."""
        m = cls()
        m._classes = np.asarray(state["classes"])
        m._params = tuple(np.asarray(p, np.float32) for p in state["params"])
        m._compact = state.get("compact")
        return m

    def _dense_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense-equivalent (W, b) of gather-path params via the recorded
        design layout (for callers handing in dense arrays)."""
        Wcat, Wcont, b = self._params
        c = self._compact
        W = np.zeros((c["width"], Wcat.shape[1]), np.float32)
        for kind, start, slot in c["layout"]:
            if kind == "cat":
                o = int(c["offsets"][slot])
                W[start:start + int(c["sizes"][slot])] = \
                    Wcat[o:o + int(c["sizes"][slot])]
            else:
                W[start] = Wcont[slot]
        return W, b

    def predict_proba(self, X: Any) -> np.ndarray:
        assert self._params is not None
        k = len(self.classes_)
        if self._compact is not None:
            if isinstance(X, OneHotDesign):
                Wcat, Wcont, b = self._params
                gid = (self._compact["offsets"][None, :] + X.cat_idx) \
                    .astype(np.int64)
                logits = Wcat[gid].sum(axis=1) + b
                if X.cont.shape[1]:
                    logits = logits + X.cont @ Wcont[:X.cont.shape[1]]
            else:
                W, b = self._dense_weights()
                logits = np.asarray(X, np.float32) @ W + b
        else:
            if isinstance(X, OneHotDesign):
                X = X.dense()
            W, b = self._params
            Xd = np.asarray(X, np.float32)
            logits = Xd @ W[:Xd.shape[1]] + b
        logits = logits[:, :k]  # drop padded bucket classes
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        # no prior recalibration here, unlike the GBDT head (as in the JAX
        # package): wide targets' true repairs are often rare values
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X: Any) -> np.ndarray:
        return self.classes_[self.predict_proba(X).argmax(axis=1)]


class MLPRegressorModel:
    """Small MLP regressor with standardized targets."""

    def __init__(self, n_steps: int = 500, lr: float = 0.01, l2: float = 1e-5,
                 hidden: int = 64, seed: int = 42) -> None:
        self.n_steps = n_steps
        self.lr = lr
        self.l2 = l2
        self.hidden = hidden
        self.seed = seed
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self.loss_: float = 0.0
        self.n_steps_run_: int = 0

    @property
    def classes_(self) -> np.ndarray:
        return np.array([])

    def fit(self, X: Any, y: "pd.Series",
            init: Optional[Dict[str, Any]] = None) -> "MLPRegressorModel":
        """``init``: starting params (w1 over the padded width) instead of
        the seeded draw."""
        if isinstance(X, OneHotDesign):
            X = X.dense()
        yv = pd.to_numeric(pd.Series(np.asarray(y)), errors="coerce") \
            .to_numpy(dtype=np.float64)
        assert not np.isnan(yv).any(), "y must not contain NULLs"
        self._y_mean = float(yv.mean())
        self._y_std = float(yv.std()) or 1.0
        yn = ((yv - self._y_mean) / self._y_std).astype(np.float32)
        self._params, self.loss_, self.n_steps_run_ = _fit_mlp_regressor(
            to_device(_pad_cols(np.asarray(X, np.float32))), to_device(yn),
            self.l2, self.lr, self.n_steps, self.hidden, self.seed, init)
        return self

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "MLPRegressorModel":
        """A fitted model from numpy arrays: ``params`` {w1, b1, w2, b2, w3,
        b3} (w1 over the padded width), ``y_mean`` and ``y_std``."""
        m = cls()
        m._params = {k: to_device(np.array(v, np.float32))
                     for k, v in state["params"].items()}
        m._y_mean = float(state["y_mean"])
        m._y_std = float(state["y_std"])
        return m

    def predict(self, X: Any) -> np.ndarray:
        if isinstance(X, OneHotDesign):
            X = X.dense()
        assert self._params is not None
        with torch.no_grad():
            pred = _mlp_forward(self._params, to_device(
                _pad_cols(np.asarray(X, np.float32)))).cpu().numpy()
        return pred * self._y_std + self._y_mean

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError("regressors have no probability output")
