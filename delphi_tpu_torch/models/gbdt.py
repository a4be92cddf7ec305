"""Histogram gradient-boosted decision trees in PyTorch — the port of the
JAX package's ``models/gbdt.py``: the single fit, the chunked
early-stopping K-fold CV grid search over one or many targets, the batched
multi-model final fit, and their mesh forms.

* features are quantile-binned on the host into an integer bin matrix
  (NaN/missing = bin 0); CV folds bin from their own training rows;
* trees grow depth-wise: level ``t`` owns node ids ``[0, 2^t)``; per level
  the (node, feature, bin) histograms of the gradient channels are segment
  sums, the split gain is an argmax over the (feature, bin) grid;
* ONE tree builder serves every fit: its leading tree axis stacks the
  class trees of a multiclass round, the configs of a CV group and the
  (target, fold) instances of a CV launch or the models of a batched fit,
  each tree with its own bins, row weights and hyperparameters — the
  JAX package's vmaps.

Objectives: L2 regression, binary logistic, multiclass softmax, with
balanced class weights.

Summation order is fixed and the same on the CPU and the card, and it is
the order the JAX package's CPU route uses (its scatter histograms): each
histogram bin sums its rows in row order in f32, and the bin cumsum
reproduces XLA:CPU's blocked scan (sequential within blocks of 16, then
the block totals). On the card each tree level is three hand kernels
and prediction one (K3 and K4, :mod:`delphi_tpu_torch.ops.kernels.gbdt`);
on the CPU their plain versions (a stable sort by segment, then
``torch.segment_reduce``). Both give the same bits. Float atomics, whose
order changes from run to run and can flip near-tie splits, are never
used. Rows and features added to stack unequal fits into one launch
carry zero weight and a constant bin, so they add exact zeros to every
sum and never win a split.

Each CV launch and each chunk of a final fit runs behind the resilience
plane's guarded seam (``gbdt.cv_chunk``, ``gbdt.fit_chunk``). A launch
returns new margins and never updates a tensor in place that outlives it,
so a retried launch starts from the same carry.

Under a device mesh (:mod:`delphi_tpu_torch.parallel.mesh`) the training
rows pad to :func:`train_row_target` and each rank holds its contiguous
block: the level histograms and leaf sums of ``_build_trees`` (and the
CV's confusion or error sums) are this block's partials, summed over the mesh
in slot order before any split is taken, so every rank grows the same
trees. The CV search then launches one target's folds at a time (the JAX
package's sequential mesh path; a target's folds share its row blocks),
the final fits run one model at a time, and prediction scores each rank's
block of rows and all-gathers them in slot order.
"""

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
from delphi_tpu_torch.ops.xfer import to_device
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.parallel.mesh import (all_gather, get_active_mesh,
                                            padded_row_target, psum,
                                            row_block)
from delphi_tpu_torch.parallel.resilience import run_guarded
from delphi_tpu_torch.utils import counter_inc

MAX_MULTICLASS = 24

# Boosting runs in chunks of this many rounds; CV early stopping checks
# its scores between chunks.
_CHUNK_ROUNDS = 25

# CV macro-F1 past which further search cannot pay for itself: the chunk
# loop and the later config groups stop for that target.
_GOOD_ENOUGH_F1 = 0.995

# Instances ((target, fold) pairs) per CV launch, and models per batched
# fit launch: they bound the stacked tensors' memory.
_CV_INSTANCE_CAP = 16
_FIT_BATCH_CAP = 8


def gbdt_supported(is_discrete: bool, num_class: int) -> bool:
    """Very wide multiclass targets route to the logistic head instead."""
    return (not is_discrete) or num_class <= MAX_MULTICLASS


def round_chunks(n_rounds: int, chunk: int = _CHUNK_ROUNDS) -> List[int]:
    """``n_rounds`` boosting rounds as fixed-size chunks plus one remainder
    (the launch planner's boost-chunk policy)."""
    return planner.round_chunks(n_rounds, chunk)


def train_row_target(n: int, mesh: Any = None) -> int:
    """The JAX package's training-row pad target: a power of two (at least
    8) up to 4096 rows, then the next multiple of 2048, raised to a
    multiple of the mesh's ``dp`` size. The port's one-device slabs pad to
    their largest instance instead; this target names the CV launch
    shapes in the planner's ``gbdt.cv`` plans and the prewarm plan, as in
    the JAX package, and splits the rows of a mesh fit into its blocks."""
    if n <= 4096:
        return padded_row_target(n, mesh)
    target = -(-n // 2048) * 2048
    if mesh is not None:
        dp = int(mesh.shape["dp"])
        target = -(-target // dp) * dp
    return target


def _train_block(n: int, mesh: Any) -> Tuple[int, int]:
    """This rank's real rows ``[lo, hi)`` of an ``n``-row training set
    padded to :func:`train_row_target` and split over the mesh."""
    lo, hi = row_block(train_row_target(n, mesh), mesh)
    return min(lo, n), min(hi, n)


def _mesh_reduce(mesh: Any, site: str) -> Any:
    """The mesh sum of a partial (None without a mesh)."""
    if mesh is None:
        return None
    return lambda t: psum(t, mesh, site=site)


# ---------------------------------------------------------------------------
# Binning (host)
# ---------------------------------------------------------------------------

class _Binner:
    """Quantile binning; bin 0 is reserved for NaN/missing."""

    def __init__(self, max_bin: int) -> None:
        self.max_bin = max_bin
        self.edges: List[np.ndarray] = []

    def fit(self, X: np.ndarray) -> "_Binner":
        self.edges = []
        for j in range(X.shape[1]):
            col = X[:, j]
            col = col[~np.isnan(col)]
            uniq = np.unique(col)
            if len(uniq) <= 1:
                self.edges.append(np.array([np.inf]))
            elif len(uniq) <= self.max_bin:
                self.edges.append((uniq[1:] + uniq[:-1]) / 2.0)
            else:
                qs = np.quantile(col, np.linspace(0, 1, self.max_bin + 1)[1:-1])
                self.edges.append(np.unique(qs))
        return self

    @property
    def n_bins(self) -> int:
        return self.max_bin + 1

    def transform(self, X: np.ndarray) -> np.ndarray:
        n, d = X.shape
        out = np.zeros((n, d), dtype=np.int32)
        for j in range(d):
            col = X[:, j]
            bins = np.searchsorted(self.edges[j], col, side="left") + 1
            out[:, j] = np.where(np.isnan(col), 0, bins)
        return out


# ---------------------------------------------------------------------------
# Transcendentals
# ---------------------------------------------------------------------------

def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor, computed in f64 and rounded to f32. The CPU's
    and the card's f32 ``exp`` differ in the last ulp on some inputs,
    enough to flip a near-tie split, so the trees (and the CV's choice of
    config) would differ between the two devices; the rounded f64 value
    is the same on both."""
    return torch.exp(x.double()).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """log computed in f64 and rounded to f32, for the reason of ``_exp``."""
    return torch.log(x.double()).float()


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in f32 over :func:`_exp`."""
    return 1.0 / (1.0 + _exp(-x))


# ---------------------------------------------------------------------------
# Tree building / prediction
# ---------------------------------------------------------------------------

def _build_trees(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                 weight: torch.Tensor, depth: int, n_bins: int,
                 reg_lambda: Any, min_split_gain: Any,
                 min_child_weight: Any, min_child_samples: Any,
                 use_counts: bool = True, hess_is_weight: bool = False,
                 reduce: Any = None, per_round: int = 1) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grows T depth-wise trees at once, one per row of ``grad``/``hess``
    [T, n]. ``bins`` is [n, d] shared by every tree, or [M, n, d] per
    model, tree t reading model t // ``per_round``; ``weight`` [n] or
    [T, n]; each hyperparameter is a float or an f32 [T] tensor. Returns
    (feat [T, nodes-1], thr [T, nodes-1], leaf f32 [T, nodes], node
    [T, n]) with all-left sentinel splits (thr = n_bins) for terminated
    nodes — the JAX package's ``_build_tree`` per tree. Each level is
    three calls of :mod:`delphi_tpu_torch.ops.kernels.gbdt` (histograms,
    split search, routing), the leaf sums a fourth.
    Rows with weight 0 drop out of the row-count channel
    (``min_child_samples``), which exists only when ``use_counts``; for L2
    (``hess_is_weight``) the hessian doubles as the weight channel. Under
    a mesh the rows are this rank's block and ``reduce`` sums each level's
    histograms and the leaf sums over the mesh (the JAX package's psums):
    every rank takes the same splits."""
    T, n = grad.shape
    dev = grad.device
    n_nodes = 1 << depth
    weight = weight.expand(T, n)

    feat = torch.zeros((T, n_nodes - 1), dtype=torch.int64, device=dev)
    thr = torch.full((T, n_nodes - 1), n_bins, dtype=torch.int64, device=dev)

    channels = [grad, hess]
    w_slot = 1 if hess_is_weight else len(channels)
    if not hess_is_weight:
        channels.append(weight)
    c_slot = len(channels) if use_counts else -1
    if use_counts:
        channels.append((weight > 0).to(grad.dtype))
    vals = torch.stack(channels, dim=-1)      # [T, n, C]

    node = None                               # every row at the root
    for level in range(depth):
        hist = k_gbdt.hist(vals, node, bins, 1 << level, n_bins, per_round)
        if reduce is not None:
            hist = reduce(hist)
        k_gbdt.split(hist, feat, thr, level, n_bins, reg_lambda,
                     min_split_gain, min_child_weight, min_child_samples,
                     w_slot, c_slot)
        node = k_gbdt.route(node, bins, feat, thr, level, per_round)
    leaf_gh = k_gbdt.hist(torch.stack([grad, hess], dim=-1), node, None,
                          n_nodes, 1)[:, :, 0, 0, :]
    if reduce is not None:
        leaf_gh = reduce(leaf_gh)
    lam = k_gbdt.per_tree(reg_lambda, T, 1)
    leaf = -leaf_gh[..., 0] / (leaf_gh[..., 1] + lam)
    if node is None:
        node = torch.zeros((T, n), dtype=torch.int32, device=dev)
    return feat, thr, leaf, node


def _grad_hess(F: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
               objective: str, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[M * trees per round, n] gradient and hessian channels of M models:
    F is [M, n] ([M, k, n] multiclass), y and weight [M, n]."""
    if objective == "regression":
        return (F - y) * weight, weight
    if objective == "binary":
        p = _sigmoid(F)
        return (p - y) * weight, torch.clamp_min(p * (1 - p), 1e-6) * weight
    z = F - F.max(dim=1, keepdim=True).values
    e = _exp(z)
    p = e / e.sum(dim=1, keepdim=True)
    onehot = torch.nn.functional.one_hot(y.to(torch.int64), k) \
        .permute(0, 2, 1).to(F.dtype)
    w = weight[:, None, :]
    M, n = y.shape
    return ((p - onehot) * w).reshape(M * k, n), \
        (torch.clamp_min(p * (1 - p), 1e-6) * w).reshape(M * k, n)


def _boost(bins: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
           F: torch.Tensor, n_rounds: int, depth: int, n_bins: int,
           objective: str, k: int, lr: Any, reg_lambda: Any,
           min_split_gain: Any, min_child_weight: Any,
           min_child_samples: Any, use_counts: bool,
           collect_trees: bool = True, reduce: Any = None) \
        -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """``n_rounds`` boosting rounds of M models at once, RESUMING from
    their margins ``F`` ([M, n], or [M, k, n] multiclass): a fit advances
    chunk by chunk with the carry on the device. Each model has its own
    bins [M, n, d], labels and row weights [M, n]; each hyperparameter is
    a float or an f32 [M] tensor. Returns (F, (feats [R, M * trees, nodes-1],
    thrs, leaves [R, M * trees, nodes])), the trees None when not
    ``collect_trees`` (CV reads only the margins: the carry IS every row's
    prediction, held-out rows included). ``reduce``: the mesh sum of the
    partials of ``_build_trees`` (rows are then this rank's block)."""
    M, n = y.shape
    per_round = k if objective == "multiclass" else 1
    T = M * per_round

    def trees_of(v: Any) -> Any:
        if isinstance(v, torch.Tensor) and per_round > 1:
            return v.repeat_interleave(per_round)
        return v

    tree_w = weight.repeat_interleave(per_round, dim=0) if per_round > 1 \
        else weight
    lr_t = k_gbdt.per_tree(trees_of(lr), T, 1)
    hyper = [trees_of(v) for v in (reg_lambda, min_split_gain,
                                   min_child_weight, min_child_samples)]
    feats, thrs, leaves = [], [], []
    for _ in range(n_rounds):
        g, h = _grad_hess(F, y, weight, objective, k)
        feat, thr, leaf, node = _build_trees(
            bins, g, h, tree_w, depth, n_bins, *hyper,
            use_counts=use_counts, hess_is_weight=(objective == "regression"),
            reduce=reduce, per_round=per_round)
        leaf = leaf * lr_t
        delta = torch.gather(leaf, 1, node)     # [T, n]
        F = F + delta.reshape(F.shape)
        if collect_trees:
            feats.append(feat)
            thrs.append(thr)
            leaves.append(leaf)
    if not collect_trees:
        return F, None
    return F, (torch.stack(feats), torch.stack(thrs), torch.stack(leaves))


def _predict_boosted(bins: torch.Tensor, feats: torch.Tensor,
                     thrs: torch.Tensor, leaves: torch.Tensor, depth: int,
                     objective: str, base: torch.Tensor) -> torch.Tensor:
    """Sums every round's tree outputs onto the base margin, round by round
    in f32 (the JAX package's scan order): K4. [n], or [k, n]
    multiclass."""
    return k_gbdt.predict(bins, feats, thrs, leaves, depth, base,
                          objective == "multiclass")


def _init_margin(base: np.ndarray, n: int, objective: str, k: int) -> np.ndarray:
    """Initial margin from per-class base scores: [n], or [k, n]."""
    base = np.asarray(base, np.float32)
    if objective == "multiclass":
        return np.broadcast_to(base[:, None], (k, n)).copy()
    return np.full((n,), base[0], np.float32)


def _stack_pad(arrs: Sequence[np.ndarray], dtype: Any = None) -> np.ndarray:
    """Stacks arrays whose trailing axes may differ, zero-padding each to
    the largest (rows, and features of bin matrices): padded rows carry
    zero weight and padded features one constant bin."""
    arrs = [np.asarray(a) for a in arrs]
    shape = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
    out = np.zeros((len(arrs),) + shape, dtype=dtype or arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


# ---------------------------------------------------------------------------
# Cross-validated grid search
# ---------------------------------------------------------------------------

def _cv_stats(F: torch.Tensor, y: torch.Tensor, val: torch.Tensor,
              y_cmp: torch.Tensor, log_flag: torch.Tensor,
              inv_scale: torch.Tensor, cw_corr: torch.Tensor,
              class_valid: torch.Tensor, objective: str,
              kk: int, reduce: Any = None) -> torch.Tensor:
    """CV scoring statistics of M models from their margins ([M, n] or
    [M, k, n]): a [M, kk, kk] int64 confusion-count matrix over the
    held-out rows (``val`` 1) for classifiers, [M, 2] f64 (scaled SSE,
    count) for regressors — small tensors, so early stopping never fetches
    prediction vectors. Regression errors are scaled by the target's RMS
    (``inv_scale``) in f32, as in the JAX package, and summed in f64.
    Under a mesh ``reduce`` sums the block's statistics over the mesh."""
    M = F.shape[0]
    if objective == "regression":
        pred = torch.where(log_flag[:, None] > 0,
                           torch.expm1(F.double()).float(), F)
        err = (pred - y_cmp) * inv_scale[:, None]
        out = torch.stack([(val * err * err).double().sum(1),
                           val.double().sum(1)], dim=1)
        return out if reduce is None else reduce(out)
    if objective == "binary":
        p = _sigmoid(F)
        # deploy parity: importance-correct back to the true priors before
        # the argmax, as predict_proba does
        pred = (p / cw_corr[:, 1:2] > (1 - p) / cw_corr[:, 0:1]) \
            .to(torch.int64)
    else:
        shifted = F - F.max(dim=1, keepdim=True).values
        logp = shifted - _log(_exp(shifted).sum(dim=1, keepdim=True))
        adj = logp - _log(cw_corr)[:, :, None]
        adj = torch.where(class_valid[:, :, None] > 0, adj,
                          torch.full_like(adj, -torch.inf))
        pred = torch.argmax(adj, dim=1)
    model = torch.arange(M, device=F.device)[:, None]
    idx = (model * kk + y.to(torch.int64)) * kk + pred
    conf = torch.zeros(M * kk * kk, dtype=torch.int64, device=F.device)
    conf.index_add_(0, idx.reshape(-1), val.to(torch.int64).reshape(-1))
    conf = conf.reshape(M, kk, kk)
    return conf if reduce is None else reduce(conf)


def _f1_from_confusion(conf: np.ndarray, k_real: int) -> float:
    """Macro-F1 from a confusion-count matrix, averaging over the classes
    present in the fold's truth (``encoding.f1_macro``'s semantics)."""
    conf = np.asarray(conf, np.float64)[:k_real, :k_real]
    truth_counts = conf.sum(axis=1)
    f1s = []
    for c in range(k_real):
        if truth_counts[c] <= 0:
            continue
        tp = conf[c, c]
        fp = conf[:, c].sum() - tp
        fn = truth_counts[c] - tp
        p = tp / (tp + fp) if tp + fp > 0 else 0.0
        r = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1s.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def _cv_prepare_target(X: Any, y: Any, is_discrete: bool, n_splits: int,
                       class_weight: str,
                       template: "GradientBoostedTreesModel",
                       mesh: Any = None) -> Optional[dict]:
    """Per-target CV preprocessing shared by the single- and multi-target
    searches: factorized labels and balanced weights, per-fold binning (bin
    edges and the regression log-target decision come from the fold's
    TRAINING rows only), the per-fold instances and the scoring constants.
    ``n_pad`` is the JAX package's padded row count (the mesh's, under a
    mesh: it sets the row blocks). Returns None when no fold is usable
    (degenerate labels)."""
    Xm = template._as_matrix(X)
    n = Xm.shape[0]
    y_arr = np.asarray(y)
    per_class_w = None
    yv64 = None
    if is_discrete:
        codes, classes = pd.factorize(y_arr, sort=True)
        k_real = len(classes)
        counts = np.bincount(codes, minlength=k_real).astype(np.float64)
        if class_weight == "balanced":
            from delphi_tpu_torch.models.encoding import balanced_class_weights
            per_class_w = balanced_class_weights(counts, len(codes))
            w_full = per_class_w[codes]
        else:
            w_full = np.ones(n)
        if k_real <= 2:
            objective, k = "binary", 1
        else:
            objective = "multiclass"
            k = next(b for b in (4, 8, 16, 24, MAX_MULTICLASS) if b >= k_real)
        yv = codes.astype(np.float32)
        kk = 2 if objective == "binary" else k
        cw_corr = np.ones(kk, np.float32)
        if per_class_w is not None:
            m = min(k_real, kk)
            cw_corr[:m] = per_class_w[:m]
        class_valid = (np.arange(kk) < k_real).astype(np.float32)
        y_cmp = np.zeros(n, np.float32)  # unused for classifiers
        scale = 1.0
    else:
        objective, k, k_real = "regression", 1, 0
        yv64 = pd.to_numeric(pd.Series(y_arr), errors="coerce") \
            .to_numpy(dtype=np.float64)
        yv = yv64.astype(np.float32)
        w_full = np.ones(n)
        cw_corr = np.ones(1, np.float32)
        class_valid = np.ones(1, np.float32)
        y_cmp = yv64.astype(np.float32)  # original-space comparison target
        # RMS normalizer: errors are scored as (err/scale)^2 on the device
        # and rescaled in f64 on the host
        scale = float(np.sqrt(np.mean(yv64 ** 2))) if n else 1.0
        if not np.isfinite(scale) or scale <= 0:
            scale = 1.0

    rng = np.random.RandomState(42)
    order = rng.permutation(n)
    folds = np.array_split(order, max(2, min(n_splits, n)))
    folds = [f for f in folds if len(f)]

    instances = []
    for fold in folds:
        train_mask = np.ones(n, dtype=bool)
        train_mask[fold] = False
        if is_discrete and len(np.unique(yv[train_mask])) < 2:
            continue
        bins = _Binner(template.max_bin).fit(Xm[train_mask]).transform(Xm)
        log_f = False
        yv_f = yv
        if not is_discrete:
            ytr = yv64[train_mask]
            std = ytr.std()
            skew = float(((ytr - ytr.mean()) ** 3).mean() / (std ** 3)) \
                if std > 0 else 0.0
            log_f = bool((ytr >= 0).all() and skew > 2.0)
            yv_f = (np.log1p(yv64) if log_f else yv64).astype(np.float32)
        w = np.where(train_mask, w_full, 0.0).astype(np.float32)
        if objective == "binary":
            pos = float((w * yv_f).sum() / max(w.sum(), 1e-9))
            pos = min(max(pos, 1e-6), 1 - 1e-6)
            base = np.array([np.log(pos / (1 - pos))], dtype=np.float32)
        elif objective == "multiclass":
            priors = np.zeros(k)
            np.add.at(priors, yv_f.astype(np.int64), w)
            priors = np.maximum(priors / max(priors.sum(), 1e-9), 1e-13)
            base = np.log(priors).astype(np.float32)
        else:
            base = np.array(
                [float((w * yv_f).sum() / max(w.sum(), 1e-9))], np.float32)
        val = np.zeros(n, np.float32)
        val[fold] = 1.0
        instances.append(dict(bins=bins, y=yv_f, w=w, val=val, base=base,
                              log=1.0 if log_f else 0.0))

    if not instances:
        return None
    return dict(
        objective=objective, k=k, k_real=k_real, n=n,
        n_pad=train_row_target(n, mesh),
        d_pad=max(8, -(-int(instances[0]["bins"].shape[1]) // 8) * 8),
        n_bins=template.max_bin + 1, y_cmp=y_cmp, scale=scale,
        cw_corr=cw_corr, class_valid=class_valid, template=template,
        is_discrete=is_discrete, instances=instances)


def _cfg_rounds_for(cfg: dict, objective: str, k: int) -> int:
    r = min(int(cfg.get("n_estimators", 200)), 200)
    if objective == "multiclass":
        r = min(r, max(40, 400 // k))
    return r


class _CVSlab:
    """The device tensors of one CV launch: W instances x C configs as
    M = W * C models (instance-major), rows and features padded to the
    slab's largest instance."""

    _STATIC = ("bins", "y", "w", "val", "y_cmp", "log", "iscale", "cw",
               "valid")

    def __init__(self, preps: List[Optional[dict]], inst: List[Tuple[int, int]],
                 objective: str, k: int, hyper: List[np.ndarray],
                 rows: Optional[Tuple[int, int]] = None,
                 static_cache: Optional[dict] = None) -> None:
        """``rows``: under a mesh, this rank's block ``[lo, hi)`` of the
        instances' rows (all of one target, so of one row count).
        ``static_cache``: a search's cache of the uploaded per-row tensors,
        kept across its config groups (the JAX package's mesh static
        cache)."""
        self.inst = list(inst)
        es = [preps[t]["instances"][j] for t, j in inst]
        ps = [preps[t] for t, _ in inst]
        C = len(hyper[0])
        self.n_cfg = C
        key = (tuple(self.inst), C, rows)
        cached = static_cache.get(key) if static_cache is not None else None
        if cached is None:
            cut = slice(None) if rows is None else slice(*rows)
            rep = lambda a: np.repeat(a, C, axis=0)  # noqa: E731

            def stack(arrs):
                return to_device(rep(_stack_pad(arrs)))

            cached = {
                "bins": to_device(rep(_stack_pad(
                    [e["bins"][cut] for e in es])), torch.int64),
                "y": stack([e["y"][cut] for e in es]),
                "w": stack([e["w"][cut] for e in es]),
                "val": stack([e["val"][cut] for e in es]),
                "y_cmp": stack([p["y_cmp"][cut] for p in ps]),
                "log": to_device(rep(np.array([e["log"] for e in es],
                                              np.float32))),
                "iscale": to_device(rep(np.array(
                    [1.0 / p["scale"] for p in ps], np.float32))),
                "cw": to_device(rep(np.stack([p["cw_corr"] for p in ps]))),
                "valid": to_device(rep(np.stack(
                    [p["class_valid"] for p in ps])))}
            if static_cache is not None:
                static_cache[key] = cached
        for name in self._STATIC:
            setattr(self, name, cached[name])
        n = self.bins.shape[1]
        self.hyper = [to_device(np.tile(np.asarray(h, np.float32), len(es)))
                      for h in hyper]
        self.F = to_device(np.repeat(np.stack(
            [_init_margin(e["base"], n, objective, k) for e in es]), C,
            axis=0))

    def keep(self, rows: List[int]) -> None:
        """Drops every instance not in ``rows`` (retired targets)."""
        C = self.n_cfg
        sel = to_device(np.array([r * C + c for r in rows for c in range(C)]),
                        torch.int64)
        for name in ("bins", "y", "w", "val", "y_cmp", "log", "iscale", "cw",
                     "valid", "F"):
            setattr(self, name, getattr(self, name).index_select(0, sel))
        self.hyper = [h.index_select(0, sel) for h in self.hyper]
        self.inst = [self.inst[r] for r in rows]


def _cv_chunk(slab: _CVSlab, chunk: int, depth: int, n_bins: int,
              objective: str, k: int, kk: int,
              mesh: Any = None) -> Tuple[torch.Tensor, np.ndarray]:
    """One guarded CV launch: ``chunk`` rounds from the slab's margins,
    then the held-out stats. Returns the new margins without touching the
    slab, so a retried launch starts from the same carry."""
    lr, lam, msg, mcw = slab.hyper
    F, _ = _boost(slab.bins, slab.y, slab.w, slab.F, chunk, depth, n_bins,
                  objective, k, lr, lam, msg, mcw, 0.0, use_counts=False,
                  collect_trees=False,
                  reduce=_mesh_reduce(mesh, "mesh.gbdt.hist"))
    return F, _cv_stats(F, slab.y, slab.val, slab.y_cmp, slab.log,
                        slab.iscale, slab.cw, slab.valid, objective, kk,
                        reduce=_mesh_reduce(mesh, "mesh.gbdt.cv_stats")) \
        .cpu().numpy()


def gbdt_cv_grid_search_multi(preps: List[Optional[dict]],
                              configs: List[dict], timeout_s: float = 0.0,
                              good_enough: float = _GOOD_ENOUGH_F1) \
        -> List[Tuple[int, float, int, bool, int]]:
    """Chunked early-stopping K-fold CV grid search over MANY targets in
    shared launches: every (target, fold) instance whose config group
    ((depth, rounds), objective, class bucket, bins) matches stacks with
    every config of the group into one tree-builder call per round.

    Per-target bookkeeping is the JAX package's: classifiers rank by their
    best checkpoint with 2-chunk patience, regressors by the latest
    horizon; a perfect or good-enough macro-F1 retires the target from ALL
    remaining groups (its instances leave the launch). One small stats
    tensor per launch is read back per chunk.

    Returns one (best config index, mean CV score, best round count,
    timed_out, chunk steps run) tuple per prep; a None prep yields
    (0, -inf, 0, False, 0)."""
    deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
    mesh = get_active_mesh()
    static_cache: Dict[Tuple, dict] = {} if mesh is not None else None

    T = len(preps)
    best_by_cfg: List[Dict[int, Tuple[float, int]]] = [{} for _ in range(T)]
    done = [p is None for p in preps]
    timed_out = False
    # timed is PER TARGET: a target retired or fully searched before the
    # deadline keeps its CV-proven round count
    timed = [False] * T
    n_chunks = [0] * T
    patience_chunks = 2
    eps = 1e-12

    # Work units: a (depth, rounds) config group and the static dims;
    # targets sharing a key share its launches. Insertion order keeps each
    # target's group order.
    merged: Dict[Tuple, List[int]] = {}
    for t, prep in enumerate(preps):
        if prep is None:
            continue
        tgroups: Dict[Tuple[int, int], List[int]] = {}
        for ci, cfg in enumerate(configs):
            depth = int(cfg.get("max_depth", prep["template"].max_depth))
            rounds = _cfg_rounds_for(cfg, prep["objective"], prep["k"])
            tgroups.setdefault((depth, rounds), []).append(ci)
        for (depth, rounds), cfg_idx in tgroups.items():
            key = (depth, rounds, prep["n_bins"], prep["objective"],
                   prep["k"], tuple(cfg_idx))
            merged.setdefault(key, []).append(t)

    for gi_group, (key, t_members) in enumerate(merged.items()):
        if timed_out:
            break
        g_depth, g_rounds, n_bins, objective, k, cfg_tuple = key
        members = [t for t in t_members if not done[t]]
        if not members:
            continue
        cfg_indices = list(cfg_tuple)
        is_discrete = preps[members[0]]["is_discrete"]
        tmpl = preps[members[0]]["template"]
        hyper = [
            np.array([configs[ci].get("learning_rate", 0.1)
                      for ci in cfg_indices], np.float32),
            np.array([configs[ci].get("reg_lambda", 1.0)
                      for ci in cfg_indices], np.float32),
            np.array([tmpl.min_split_gain] * len(cfg_indices), np.float32),
            np.array([configs[ci].get("min_child_weight", 1.0)
                      for ci in cfg_indices], np.float32)]
        kk = 2 if objective == "binary" else k

        inst = [(t, j) for t in members
                for j in range(len(preps[t]["instances"]))]
        # the slab split comes from the launch planner's `gbdt.cv[...]`
        # plan (persisted per table fingerprint, as in the JAX package;
        # DELPHI_PLAN_CV_INSTANCE_CAP is the cap). The plan pads the batch
        # axis of a multi-target search to a power of two; eager PyTorch
        # gains nothing from that, so a slab holds its spans only. The JAX
        # package also keys a group by its row and feature pads; the port
        # stacks targets of other pads in one group (a slab pads to its
        # largest instance), so the shape names the group's largest pads.
        if mesh is not None:
            # under a mesh each launch is one target's folds over this
            # rank's block of its rows (the JAX package's sequential mesh
            # path, which records no plan)
            slabs = [_CVSlab(preps, [tj for tj in inst if tj[0] == t],
                             objective, k, hyper,
                             rows=_train_block(preps[t]["n"], mesh),
                             static_cache=static_cache)
                     for t in members]
            launch_of = {}
        else:
            n_pad = max(preps[t]["n_pad"] for t in members)
            d_pad = max(preps[t]["d_pad"] for t in members)
            cap = planner.cv_instance_cap(default=_CV_INSTANCE_CAP)
            slab_plan = planner.plan_launches(
                f"gbdt.cv[{gi_group}]",
                [planner.Piece(key=i, size=1,
                               shape=(g_depth, g_rounds, n_pad, d_pad,
                                      n_bins, objective, k,
                                      len(cfg_indices)))
                 for i in range(len(inst))],
                batch_cap=cap, pad_batch=(T > 1))
            slab_plan.record()
            slabs = [_CVSlab(preps, [inst[span.key] for span in launch.spans],
                             objective, k, hyper)
                     for launch in slab_plan.launches]
            launch_of = {id(slab): launch
                         for slab, launch in zip(slabs, slab_plan.launches)}

        rounds_done = 0
        active = {t: True for t in members}
        no_improve = {t: 0 for t in members}
        for chunk in round_chunks(g_rounds):
            # the retirement check runs BEFORE the deadline check: a search
            # that concluded naturally is not reported as timed out
            if not any(active[t] and not done[t] for t in members):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            stats: Dict[Tuple[int, int], np.ndarray] = {}
            for t in members:
                n_chunks[t] += active[t] and not done[t]
            for slab in slabs:
                live = [r for r, (t, _) in enumerate(slab.inst)
                        if active[t] and not done[t]]
                if not live:
                    continue
                if len(live) < len(slab.inst):
                    slab.keep(live)
                launch = launch_of.get(id(slab))
                with contextlib.nullcontext() if launch is None \
                        else slab_plan.launch_scope(launch):
                    slab.F, s = run_guarded(
                        "gbdt.cv_chunk",
                        lambda slab=slab, chunk=chunk: _cv_chunk(
                            slab, chunk, g_depth, n_bins, objective, k, kk,
                            mesh))
                counter_inc("gbdt.cv_launches")
                if len({t for t, _ in slab.inst}) > 1:
                    counter_inc("gbdt.cv_multi_target_launches")
                C = slab.n_cfg
                for r, tj in enumerate(slab.inst):
                    stats[tj] = s[r * C:(r + 1) * C]
            rounds_done += chunk

            for t in members:
                if done[t] or not active[t]:
                    continue
                prep = preps[t]
                rows_t = [tj for tj in inst if tj[0] == t]
                improved = False
                for jj, ci in enumerate(cfg_indices):
                    fold_scores = []
                    for tj in rows_t:
                        s = stats[tj][jj]
                        if is_discrete:
                            fold_scores.append(
                                _f1_from_confusion(s, prep["k_real"]))
                        else:
                            # rescale the normalized SSE back in float64
                            sse = float(s[0]) * prep["scale"] ** 2
                            fold_scores.append(-sse / max(float(s[1]), 1.0))
                    mean = float(np.mean(fold_scores))
                    if is_discrete:
                        # classifiers rank by their best checkpoint, and
                        # the recorded round count sizes the final fit
                        if mean > best_by_cfg[t].get(ci, (-np.inf, 0))[0] + eps:
                            best_by_cfg[t][ci] = (mean, rounds_done)
                            improved = True
                    else:
                        # regressors rank by the LATEST horizon: their
                        # final fit trains the full round budget
                        best_by_cfg[t][ci] = (mean, rounds_done)
                    # a PERFECT classifier score cannot be beaten
                    if is_discrete and fold_scores \
                            and min(fold_scores) >= 1.0 - 1e-12:
                        done[t] = True
                if done[t]:
                    continue
                if is_discrete and any(
                        best_by_cfg[t].get(ci, (-np.inf, 0))[0] >= good_enough
                        for ci in cfg_indices):
                    done[t] = True
                    continue
                if improved:
                    no_improve[t] = 0
                elif is_discrete:
                    # patience applies to classifiers only: regressors
                    # deploy at the full round budget and must reach it
                    no_improve[t] += 1
                    if no_improve[t] >= patience_chunks:
                        active[t] = False

        if timed_out:
            # only the targets still actively improving lose their round
            # counts: a checkpoint recorded mid-search may under-state them
            for t in members:
                if active[t] and not done[t]:
                    timed[t] = True

    out: List[Tuple[int, float, int, bool, int]] = []
    for t in range(T):
        if not best_by_cfg[t]:
            out.append((0, -np.inf, 0, timed[t] or
                        (timed_out and preps[t] is not None and not done[t]),
                        n_chunks[t]))
            continue
        best_ci = max(best_by_cfg[t], key=lambda ci: best_by_cfg[t][ci][0])
        best_score, best_rounds = best_by_cfg[t][best_ci]
        out.append((best_ci, best_score, best_rounds, timed[t], n_chunks[t]))
    return out


def gbdt_cv_grid_search(X: np.ndarray, y: Any, is_discrete: bool,
                        configs: List[dict], n_splits: int,
                        class_weight: str,
                        template: "GradientBoostedTreesModel",
                        timeout_s: float = 0.0,
                        good_enough: float = _GOOD_ENOUGH_F1) \
        -> Tuple[int, float, int, bool, int]:
    """Single-target K-fold CV grid search: a one-element call into
    :func:`gbdt_cv_grid_search_multi`. Returns (best config index, mean CV
    score, best round count, timed_out, chunk steps run): macro-F1 for
    classifiers, -MSE for regressors, the round count the SMALLEST
    checkpoint where the winning config reached its best score."""
    prep = _cv_prepare_target(X, y, is_discrete, n_splits, class_weight,
                              template, get_active_mesh())
    return gbdt_cv_grid_search_multi(
        [prep], configs, timeout_s=timeout_s, good_enough=good_enough)[0]


# ---------------------------------------------------------------------------
# Public model
# ---------------------------------------------------------------------------

class GradientBoostedTreesModel:
    """LightGBM-style GBDT with the repair pipeline's model duck type."""

    def __init__(self, is_discrete: bool, num_class: int,
                 n_estimators: int = 300, learning_rate: float = 0.1,
                 max_depth: int = 5, max_bin: int = 255,
                 min_split_gain: float = 0.0, reg_lambda: float = 1.0,
                 min_child_weight: float = 1.0,
                 min_child_samples: float = 0.0,
                 class_weight: str = "balanced") -> None:
        self.is_discrete = is_discrete
        self.num_class = num_class
        self.n_estimators = min(n_estimators, 200)
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.max_bin = min(max_bin, 63)
        self.min_split_gain = min_split_gain
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.class_weight = class_weight
        self.loss_: float = 0.0
        self._classes: Optional[np.ndarray] = None

    @property
    def classes_(self) -> np.ndarray:
        assert self._classes is not None
        return self._classes

    def _as_matrix(self, X: Any) -> np.ndarray:
        if isinstance(X, pd.DataFrame):
            X = X.to_numpy()
        return np.asarray(X, dtype=np.float64)

    def _fit_prepare(self, X: Any, y: Any) \
            -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
        """Host work before boosting: binning, label factorization, class
        weights, base margins. Returns (bins, y, w, F0, min_child_samples)
        and sets the model's inference state, so the batched fit can
        prepare each model and boost a whole group together."""
        Xm = self._as_matrix(X)
        n, d = Xm.shape
        self._binner = _Binner(self.max_bin).fit(Xm)
        bins_np = self._binner.transform(Xm)
        self._n_bins = self._binner.n_bins

        if self.is_discrete:
            codes, classes = pd.factorize(np.asarray(y), sort=True)
            self._classes = np.asarray(classes)
            k = len(classes)
            counts = np.bincount(codes, minlength=k).astype(np.float64)
            if self.class_weight == "balanced":
                from delphi_tpu_torch.models.encoding import \
                    balanced_class_weights
                per_class_w = balanced_class_weights(counts, len(codes))
                w = per_class_w[codes]
                self._fit_class_weights = per_class_w
            else:
                w = np.ones(n)
                self._fit_class_weights = None
            if k <= 2:
                self._objective = "binary"
                self._k = 1
                yv = codes.astype(np.float32)
                pos = float((w * yv).sum() / w.sum())
                pos = min(max(pos, 1e-6), 1 - 1e-6)
                base = np.array([np.log(pos / (1 - pos))], dtype=np.float32)
            else:
                self._objective = "multiclass"
                # the class-tree axis is bucketed ({4,8,16,24}) as in the
                # reference: padded classes get a ~-inf prior and are never
                # the label, so their trees carry ~zero gradients
                k_pad = next(b for b in (4, 8, 16, 24, MAX_MULTICLASS)
                             if b >= k)
                self._k = k_pad
                self.n_estimators = min(self.n_estimators, max(40, 400 // k_pad))
                yv = codes.astype(np.float32)
                priors = np.zeros(k_pad)
                np.add.at(priors, codes, w)
                priors = np.maximum(priors / priors.sum(), 1e-13)
                base = np.log(priors).astype(np.float32)
        else:
            self._objective = "regression"
            self._k = 1
            yv = pd.to_numeric(pd.Series(np.asarray(y)), errors="coerce") \
                .to_numpy(dtype=np.float64)
            assert not np.isnan(yv).any(), "y must not contain NULLs"
            # heavily right-skewed nonnegative targets fit in log space
            std = yv.std()
            skew = float(((yv - yv.mean()) ** 3).mean() / (std ** 3)) if std > 0 else 0.0
            self._log_target = bool((yv >= 0).all() and skew > 2.0)
            if self._log_target:
                yv = np.log1p(yv)
            yv = yv.astype(np.float32)
            w = np.ones(n)
            base = np.array([float(yv.mean())], dtype=np.float32)
            self._classes = np.array([])

        self._base = base
        mcs = self.min_child_samples if self.is_discrete else 0.0
        F0 = _init_margin(base, n, self._objective, max(self._k, 1))
        return (bins_np, np.asarray(yv, np.float32), np.asarray(w, np.float32),
                F0, mcs)

    def _set_trees(self, trees: Sequence[np.ndarray],
                   n_rounds: Optional[int] = None) -> None:
        """Installs boosted trees (feat, thr, leaf) stacked [rounds, class
        trees, ...], truncated to ``n_rounds``: boosting is
        prefix-deterministic, so a longer run truncated to r rounds IS the
        r-round model (a batched group boosts to its max budget and each
        model keeps its own prefix)."""
        feats, thrs, leaves = trees
        if n_rounds is not None:
            feats, thrs, leaves = (t[:n_rounds] for t in (feats, thrs, leaves))
        self._trees = (np.asarray(feats, np.int32), np.asarray(thrs, np.int32),
                       np.asarray(leaves, np.float32))
        self.n_estimators = int(self._trees[0].shape[0])

    def fit(self, X: Any, y: Any) -> "GradientBoostedTreesModel":
        return self._fit_boost_prepared(*self._fit_prepare(X, y),
                                        mesh=get_active_mesh())

    def _fit_boost_prepared(self, bins_np: np.ndarray, yv: np.ndarray,
                            w: np.ndarray, F0: np.ndarray, mcs: float,
                            mesh: Any = None) -> "GradientBoostedTreesModel":
        """Chunked fit: the margin carry stays on the device between
        chunks of ``_CHUNK_ROUNDS`` rounds. Under a mesh this rank boosts
        its block of the rows (the JAX package's ``_mesh_boost_fn``)."""
        rows = slice(None) if mesh is None \
            else slice(*_train_block(len(yv), mesh))
        bins = to_device(bins_np[None, rows], torch.int64)
        y_d, w_d = to_device(yv[None, rows]), to_device(w[None, rows])
        F = to_device(F0[None, ..., rows])
        reduce = _mesh_reduce(mesh, "mesh.gbdt.hist")
        parts = []
        for chunk in round_chunks(self.n_estimators):
            F, trees = run_guarded(
                "gbdt.fit_chunk",
                lambda F=F, chunk=chunk: _boost(
                    bins, y_d, w_d, F, chunk, self.max_depth,
                    self._n_bins, self._objective,
                    max(self._k, 1), float(self.learning_rate),
                    float(self.reg_lambda), float(self.min_split_gain),
                    float(self.min_child_weight), float(mcs),
                    use_counts=mcs > 0, reduce=reduce))
            parts.append(trees)
        self._set_trees([torch.cat([p[i] for p in parts]).cpu().numpy()
                         for i in range(3)])
        return self

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "GradientBoostedTreesModel":
        """A fitted model from plain numpy arrays and scalars: ``edges``
        (the binner's per-feature edge arrays), ``trees`` = (feat, thr,
        leaf) stacked [rounds, class trees, ...], ``base``, ``objective``,
        ``k``, ``classes``, ``fit_class_weights``, ``log_target``,
        ``n_estimators`` and ``max_depth``."""
        objective = state["objective"]
        classes = np.asarray(state["classes"])
        m = cls(is_discrete=objective != "regression",
                num_class=len(classes), max_depth=int(state["max_depth"]))
        m._binner = _Binner(m.max_bin)
        m._binner.edges = [np.asarray(e, dtype=np.float64)
                           for e in state["edges"]]
        m._n_bins = m._binner.n_bins
        m._trees = tuple(np.asarray(t) for t in state["trees"])
        m._base = np.asarray(state["base"], dtype=np.float32)
        m._objective = objective
        m._k = int(state["k"])
        m._classes = classes
        w = state.get("fit_class_weights")
        m._fit_class_weights = None if w is None else np.asarray(w)
        m._log_target = bool(state.get("log_target", False))
        m.n_estimators = int(state["n_estimators"])
        return m

    def _raw_scores(self, X: Any) -> np.ndarray:
        mesh = get_active_mesh()
        bins_np = self._binner.transform(self._as_matrix(X))
        if mesh is not None:
            return _mesh_predict(mesh, bins_np, *self._trees, self.max_depth,
                                 self._objective, self._base)
        feats, thrs, leaves = self._trees
        F = _predict_boosted(to_device(bins_np, torch.int64),
                             to_device(feats, torch.int64),
                             to_device(thrs, torch.int64),
                             to_device(leaves, torch.float32), self.max_depth,
                             self._objective, to_device(self._base))
        return F.cpu().numpy()

    def _recalibrate(self, probs: np.ndarray) -> np.ndarray:
        """Importance-corrects probabilities back to the true class priors
        (training reweighted classes by w_c)."""
        w = getattr(self, "_fit_class_weights", None)
        if w is None:
            return probs
        corrected = probs / np.maximum(w[None, :], 1e-12)
        return corrected / np.maximum(
            corrected.sum(axis=1, keepdims=True), 1e-12)

    def predict_proba(self, X: Any) -> np.ndarray:
        assert self.is_discrete
        F = self._raw_scores(X)
        if self._objective == "binary":
            p = 1.0 / (1.0 + np.exp(-F))
            return self._recalibrate(np.stack([1 - p, p], axis=1))
        F = F[: len(self.classes_)]  # drop padded bucket classes
        z = F - F.max(axis=0, keepdims=True)
        e = np.exp(z)
        return self._recalibrate((e / e.sum(axis=0, keepdims=True)).T)

    def predict(self, X: Any) -> np.ndarray:
        if self.is_discrete:
            return self.classes_[self.predict_proba(X).argmax(axis=1)]
        pred = self._raw_scores(X)
        if getattr(self, "_log_target", False):
            pred = np.expm1(pred)
        return pred


def _mesh_predict(mesh: Any, bins_np: np.ndarray, feats: np.ndarray,
                  thrs: np.ndarray, leaves: np.ndarray, depth: int,
                  objective: str, base: np.ndarray) -> np.ndarray:
    """Row-sharded inference: the rows pad to the mesh's
    ``padded_row_target``, each rank scores its block against the
    replicated trees, and the blocks all-gather in slot order (a row's
    margin is the one-device margin, bit for bit)."""
    n = int(bins_np.shape[0])
    n_pad = padded_row_target(n, mesh)
    per = n_pad // mesh.shape["dp"]
    lo, hi = row_block(n_pad, mesh)
    lo, hi = min(lo, n), min(hi, n)
    F = _predict_boosted(to_device(bins_np[lo:hi], torch.int64),
                         to_device(feats, torch.int64),
                         to_device(thrs, torch.int64),
                         to_device(leaves, torch.float32), depth, objective,
                         to_device(base))
    dim = F.dim() - 1
    block = torch.nn.functional.pad(F, (0, per - (hi - lo)))
    out = all_gather(block, mesh, dim=dim, site="mesh.gbdt.predict")
    return out.cpu().numpy()[..., :n]


# ---------------------------------------------------------------------------
# Batched multi-model final fits
# ---------------------------------------------------------------------------

def gbdt_fit_batch(entries: List[Tuple[GradientBoostedTreesModel,
                                       Any, Any]]) -> None:
    """Fits many GBDT models in shared launches: each model is prepared on
    the host (binning, class weights), models are grouped by their static
    dims (depth, bins, objective, class bucket, counts channel), and each
    group boosts to its MAX round budget in ``_FIT_BATCH_CAP``-wide chunked
    launches; every model then keeps its own round-count prefix of the
    stacked trees. Singleton groups take the plain chunked fit. Under a
    mesh the models fit one at a time, each over the mesh (there the mesh
    is the batching axis, as in the JAX package)."""
    if len(entries) <= 1 or get_active_mesh() is not None:
        for m, X, y in entries:
            m.fit(X, y)
        return

    prepped = [(m,) + m._fit_prepare(X, y) for m, X, y in entries]
    groups: Dict[Tuple, List[int]] = {}
    for i, (m, _b, _y, _w, _F, mcs) in enumerate(prepped):
        key = (m.max_depth, m._n_bins, m._objective, max(m._k, 1),
               bool(mcs > 0))
        groups.setdefault(key, []).append(i)

    for (depth, n_bins, objective, k, use_counts), idxs in groups.items():
        if len(idxs) == 1:
            m, *prep = prepped[idxs[0]]
            m._fit_boost_prepared(*prep)
            continue
        for s in range(0, len(idxs), _FIT_BATCH_CAP):
            sub = [prepped[i] for i in idxs[s:s + _FIT_BATCH_CAP]]
            models = [p[0] for p in sub]
            bins = to_device(_stack_pad([p[1] for p in sub]), torch.int64)
            ys = to_device(_stack_pad([p[2] for p in sub]))
            ws = to_device(_stack_pad([p[3] for p in sub]))
            F = to_device(_stack_pad([p[4] for p in sub]))
            hyper = [to_device(np.array(v, np.float32)) for v in (
                [m.learning_rate for m in models],
                [m.reg_lambda for m in models],
                [m.min_split_gain for m in models],
                [m.min_child_weight for m in models],
                [p[5] for p in sub])]
            parts = []
            for chunk in round_chunks(max(m.n_estimators for m in models)):
                F, trees = run_guarded(
                    "gbdt.fit_chunk",
                    lambda F=F, chunk=chunk, bins=bins, ys=ys, ws=ws,
                    hyper=hyper: _boost(
                        bins, ys, ws, F, chunk, depth, n_bins, objective, k,
                        *hyper, use_counts=use_counts))
                counter_inc("gbdt.fit_batch_launches")
                parts.append(trees)
            per_round = k if objective == "multiclass" else 1
            trees_np = [torch.cat([p[i] for p in parts]).cpu().numpy()
                        for i in range(3)]
            for mi, m in enumerate(models):
                rows = slice(mi * per_round, (mi + 1) * per_round)
                m._set_trees([t[:, rows] for t in trees_np],
                             n_rounds=m.n_estimators)
