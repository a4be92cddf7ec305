"""Linear / MLP repair-model heads in PyTorch — the port of the JAX
package's ``models/linear.py``.

The classifier is a class-weighted multinomial logistic regression over
the one-hot features, the regressor a small MLP; both train full-batch
with Adam (optax's ``adam`` update rule, the hand kernel K10c
:func:`~delphi_tpu_torch.ops.kernels.linear.adam_step` over one flat
buffer of parameters) and stop once the loss plateaus (the JAX package's
``while_loop`` rule, read on the host after every step). The logistic
head trains on the factored one-hot design (:class:`OneHotDesign`) as an
embedding gather whose loss and gradients are the hand kernels K10a and
K10b, each summing in a fixed order, so two fits on the card are
bit-identical and a step is three launches; a dense design trains with
one matmul, its gradients from autograd.

Rows are not padded: padded rows carry zero weight and padded vocabulary
or feature columns only feel the L2 pull from zero, so they change
nothing. The class axis IS padded exactly as in the JAX package (to a
multiple of 8): padded classes stay in the softmax denominator.

Under a device mesh (:mod:`delphi_tpu_torch.parallel.mesh`) the logistic
head trains on the dense design with its rows sharded over the ranks
(:func:`_mesh_fit_logreg`, the JAX package's ``_mesh_fit_logreg``): each
step sums the block's loss and gradients over the mesh, so every rank
applies the same update and leaves the Adam loop at the same step.

They expose the scikit-learn-like duck type (``classes_`` / ``predict`` /
``predict_proba``) the repair pipeline expects.
"""

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.models.encoding import (OneHotDesign,
                                              balanced_class_weights)
from delphi_tpu_torch.ops.kernels import linear as k_lin
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


class _FlatAdam:
    """One fit's parameters, its step's ``[loss, gradients]`` and Adam's
    two moments, one flat f32 buffer each on ``device``; ``views`` and
    ``grad_views`` are the parameters (of ``shapes``) and their gradients
    as views into them. The parameters start at 0, or at ``inits``."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]],
                 device: torch.device,
                 inits: Optional[Sequence[Any]] = None) -> None:
        self.shapes = [tuple(s) for s in shapes]
        size = sum(math.prod(s) for s in self.shapes)
        self.params = torch.zeros(size, dtype=torch.float32, device=device)
        self.lg = torch.zeros(size + 1, dtype=torch.float32, device=device)
        self.mu = torch.zeros(size, dtype=torch.float32, device=device)
        self.nu = torch.zeros(size, dtype=torch.float32, device=device)
        self.loss, self.grads = self.lg[:1], self.lg[1:]
        self.views = self.split(self.params)
        self.grad_views = self.split(self.grads)
        for view, start in zip(self.views, inits or ()):
            if not isinstance(start, torch.Tensor):
                start = torch.from_numpy(np.array(start, np.float32))
            view.copy_(start)

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        out, at = [], 0
        for shape in self.shapes:
            size = math.prod(shape)
            out.append(flat[at:at + size].view(shape))
            at += size
        return out


def _autograd_step(adam: _FlatAdam,
                   loss_fn: Callable[..., torch.Tensor]) -> Callable[[], None]:
    """A step function for :func:`_adam_until_plateau` whose gradients
    come from autograd: ``loss_fn(*parameters)`` on views of a leaf that
    shares the flat parameters, its gradient copied into ``adam.grads``
    and its value into ``adam.loss``."""
    def step() -> None:
        leaf = adam.params.detach().requires_grad_()
        loss = loss_fn(*adam.split(leaf))
        (grad,) = torch.autograd.grad(loss, leaf)
        adam.grads.copy_(grad)
        adam.loss.copy_(loss.detach().reshape(1))
    return step


def _adam_until_plateau(adam: _FlatAdam, step: Callable[[], None], lr: float,
                        n_steps: int, min_steps: int, tol: float,
                        reduce: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None) \
        -> Tuple[int, float]:
    """Full-batch Adam steps until ``n_steps`` or, from step ``min_steps``,
    until ``|prev - cur| <= tol * (1 + |cur|)`` (f32, as the JAX package's
    ``while_loop`` condition). Each step calls ``step()``, which fills
    ``adam.lg`` with the loss at the current parameters and its
    gradients, and applies one update (K10c, :func:`k_lin.adam_step`).
    Reading that loss waits for the device once a step. ``reduce`` (a mesh
    sum) takes the flat ``[loss, gradients]`` before the update, so every
    rank steps alike and reads the same exit test. Returns (updates
    applied, last loss)."""
    tol32 = np.float32(tol)
    prev = cur = np.float32(np.inf)
    i = 0
    while i < n_steps and (
            i < min_steps or np.abs(prev - cur) > tol32 * (np.float32(1.0)
                                                           + np.abs(cur))):
        step()
        lg = adam.lg if reduce is None else reduce(adam.lg)
        k_lin.adam_step(adam.params, lg[1:], adam.mu, adam.nu, lr, i + 1)
        i += 1
        prev, cur = cur, np.float32(lg[0].item())
    return i, float(cur)


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
    adam = _FlatAdam([(d, k), (k,)], X.device)
    sample_w = class_weights[y]
    denom = torch.clamp_min(sample_w.sum(), 1.0)

    def loss_fn(W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _nll(X @ W + b, y, sample_w, denom) + l2 * torch.sum(W * W)

    steps, loss = _adam_until_plateau(adam, _autograd_step(adam, loss_fn),
                                      lr, n_steps, 20, 1e-6)
    return tuple(adam.views), loss, steps


def _mesh_fit_logreg(mesh: Any, X: np.ndarray, y: torch.Tensor,
                     class_weights: torch.Tensor, l2: float, lr: float,
                     n_steps: int) \
        -> Tuple[Tuple[torch.Tensor, ...], float, int]:
    """The dense logistic head with its rows sharded over the mesh (``y``
    and ``class_weights`` on the device): this rank's block of the rows
    padded to ``train_row_target``, the weighted
    row normalizer summed over the mesh, the L2 term divided by the
    ``dp`` size so that the sum counts it once (the JAX package's
    ``_fit_logreg`` under ``axis_name``), and each step's loss and
    gradients summed over the mesh. Returns ((W, b), last loss, updates
    applied), the same on every rank."""
    from delphi_tpu_torch.models.gbdt import _train_block
    from delphi_tpu_torch.parallel.mesh import psum
    lo, hi = _train_block(len(y), mesh)
    Xb = to_device(np.ascontiguousarray(X[lo:hi], np.float32))
    yb = y[lo:hi]
    d, k = X.shape[1], class_weights.shape[0]
    adam = _FlatAdam([(d, k), (k,)], Xb.device)
    sample_w = class_weights[yb]
    denom = torch.clamp_min(psum(sample_w.sum(), mesh,
                                 site="mesh.logreg.denom"), 1.0)
    reg_scale = 1.0 / mesh.shape["dp"]

    def loss_fn(W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _nll(Xb @ W + b, yb, sample_w, denom) \
            + reg_scale * l2 * torch.sum(W * W)

    steps, loss = _adam_until_plateau(
        adam, _autograd_step(adam, loss_fn), lr, n_steps, 20, 1e-6,
        reduce=lambda t: psum(t, mesh, site="mesh.logreg.step"))
    return tuple(adam.views), loss, steps


def _fit_logreg_gather(gid: torch.Tensor, cont: torch.Tensor, y: torch.Tensor,
                       class_weights: torch.Tensor, denom: float, l2: float,
                       lr: float, n_steps: int, n_vocab: int) \
        -> Tuple[Tuple[torch.Tensor, ...], float, int]:
    """The logistic head on the factored one-hot design: ``X @ W`` over a
    block-one-hot matrix is an embedding gather (``gid`` [n, F] global
    vocabulary ids), plus the continuous columns' matmul. Same objective,
    weights and exit rule as :func:`_fit_logreg`, over the weighted row
    normalizer ``denom`` (computed on the host). Each step is K10a
    (:func:`k_lin.logreg_forward`: the loss and its gradient at the
    logits), K10b (:func:`k_lin.logreg_backward`: the weights' gradients,
    each in a fixed order, so two fits on the card are bit-identical) and
    K10c, with no autograd graph. Returns ((Wcat, Wcont, b), last loss,
    updates applied)."""
    k = class_weights.shape[0]
    dev = gid.device
    adam = _FlatAdam([(n_vocab, k), (cont.shape[1], k), (k,)], dev)
    plan = k_lin.gather_plan(gid, cont, y, class_weights[y], denom, l2,
                             n_vocab, k)
    dlogits = torch.empty((gid.shape[0], k), dtype=torch.float32, device=dev)
    Wcat, Wcont, b = adam.views
    gWcat, gWcont, gb = adam.grad_views

    def step() -> None:
        k_lin.logreg_forward(plan, Wcat, Wcont, b, adam.loss, dlogits)
        k_lin.logreg_backward(plan, dlogits, Wcat, Wcont, gWcat, gWcont, gb)

    steps, loss = _adam_until_plateau(adam, step, lr, n_steps, 20, 1e-6)
    return (Wcat, Wcont, b), loss, steps


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
    names = list(start)
    # copied into the flat buffer: Adam updates in place and must not
    # write into ``init``
    adam = _FlatAdam([np.shape(start[name]) for name in names], X.device,
                     [start[name] for name in names])
    denom = float(max(X.shape[0], 1))

    def loss_fn(*views: torch.Tensor) -> torch.Tensor:
        params = dict(zip(names, views))
        mse = ((_mlp_forward(params, X) - y) ** 2).sum() / denom
        reg = sum(torch.sum(params[w] ** 2) for w in ("w1", "w2", "w3"))
        return mse + l2 * reg

    # non-convex objective: only a near-exact plateau stops early
    steps, loss = _adam_until_plateau(adam, _autograd_step(adam, loss_fn),
                                      lr, n_steps, 50, 1e-7)
    return dict(zip(names, adam.views)), loss, steps


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

        from delphi_tpu_torch.parallel.mesh import get_active_mesh
        mesh = get_active_mesh()
        self._compact = None
        if mesh is not None:
            # the dense design with the rows over the mesh, as the JAX
            # package fits it there
            if isinstance(X, OneHotDesign):
                X = X.dense()
            params, loss, steps = _mesh_fit_logreg(
                mesh, np.asarray(X, np.float32), y_d, cw, self.l2, self.lr,
                self.n_steps)
        elif isinstance(X, OneHotDesign) and X.cat_idx.shape[1] > 0:
            sizes = np.asarray(X.cat_sizes, np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes[:-1])])
            gid = to_device(offsets[None, :] + X.cat_idx, torch.int64)
            # the weighted row normalizer on the host, in the kernels' order
            denom = max(float(k_lin.tree_sum(torch.from_numpy(
                class_weights[codes]))), 1.0)
            params, loss, steps = _fit_logreg_gather(
                gid, to_device(X.cont, torch.float32), y_d, cw, denom,
                self.l2, self.lr, self.n_steps, int(sizes.sum()))
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
