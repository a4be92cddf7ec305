"""Distributed training steps over the port's mesh of ranks: the JAX
package's ``parallel/train_step.py``.

* :func:`logreg_train_step`: one SGD step of the multinomial logistic
  head with rows sharded over ``dp`` and the class axis over ``tp``: the
  log-sum-exp runs distributed (:func:`~delphi_tpu_torch.parallel.mesh.
  pmax` and :func:`~delphi_tpu_torch.parallel.mesh.psum` over ``tp``) and
  the gradients sum over ``dp``.
* :func:`gbdt_histogram_round`: one boosting round with rows sharded over
  ``dp``: each rank builds its block's gradient and hessian histograms,
  they sum over the mesh, and every rank takes the same splits.

Each returns a function of this rank's blocks, as the JAX package's
return a ``shard_map`` program of the local shards.
"""

from typing import Callable, Tuple

import torch

from delphi_tpu_torch.ops.kernels import gbdt as k_gbdt
from delphi_tpu_torch.parallel.mesh import Mesh, _axis_slot, pmax, psum
from delphi_tpu_torch.utils import counter_inc


def logreg_train_step(mesh: Mesh, lr: float = 0.1,
                      l2: float = 1e-4) -> Callable:
    """``(W, b, X, y) -> (W, b, loss)`` over this rank's blocks: ``W``
    ``[d, K/tp]`` and ``b`` ``[K/tp]`` its class slice, ``X`` ``[n/dp,
    d]`` and ``y`` ``[n/dp]`` its rows; the loss is the global one."""
    counter_inc("parallel.logreg_step_programs")

    def step(W: torch.Tensor, b: torch.Tensor, X: torch.Tensor,
             y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        logits = X @ W + b
        gmax = pmax(logits.max(dim=1, keepdim=True).values, mesh, "tp")
        sumexp = psum(torch.exp(logits - gmax).sum(dim=1, keepdim=True),
                      mesh, "tp")
        logp = logits - gmax - torch.log(sumexp)
        k_local = W.shape[1]
        tp_idx = _axis_slot(mesh, "tp") or 0
        local_classes = tp_idx * k_local + torch.arange(k_local,
                                                        device=W.device)
        onehot = (y[:, None].long() == local_classes[None, :]).float()
        n_global = psum(torch.tensor(float(X.shape[0]), device=X.device),
                        mesh, "dp")
        loss = -psum((onehot * logp).sum(), mesh, ("dp", "tp")) / n_global
        dlogits = (torch.exp(logp) - onehot) / n_global
        dW = psum(X.T @ dlogits, mesh, "dp") + 2.0 * l2 * W
        db = psum(dlogits.sum(dim=0), mesh, "dp")
        return W - lr * dW, b - lr * db, loss

    return step


def gbdt_histogram_round(mesh: Mesh, depth: int, n_bins: int,
                         reg_lambda: float = 1.0,
                         lr: float = 0.1) -> Callable:
    """``(bins, grad, hess) -> (feat, thr, leaf, delta)`` over this rank's
    rows: ``bins`` int ``[n/dp, d]``, ``grad`` / ``hess`` f32 ``[n/dp]``.
    The tree arrays are the same on every rank; ``delta`` is the round's
    prediction step for this rank's rows. Each level goes through the tree
    builder's kernels (:mod:`delphi_tpu_torch.ops.kernels.gbdt`: each
    histogram bin sums its rows in row order), its histograms summed over
    the mesh before the split search; no weight or count mask."""
    counter_inc("parallel.gbdt_round_programs")
    n_nodes = 1 << depth

    def round_fn(bins: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor):
        dev = grad.device
        bins = bins.long().contiguous()
        vals = torch.stack([grad, hess], dim=-1)[None]      # [1, n, 2]
        feat = torch.zeros((1, n_nodes - 1), dtype=torch.int64, device=dev)
        thr = torch.full((1, n_nodes - 1), n_bins, dtype=torch.int64,
                         device=dev)
        node = None
        for level in range(depth):
            hist = psum(k_gbdt.hist(vals, node, bins, 1 << level, n_bins),
                        mesh, "dp")
            k_gbdt.split(hist, feat, thr, level, n_bins, reg_lambda, 0.0,
                         0.0, 0.0, w_slot=-1, c_slot=-1)
            node = k_gbdt.route(node, bins, feat, thr, level)
        leaf_gh = psum(k_gbdt.hist(vals, node, None, n_nodes, 1), mesh,
                       "dp")[0, :, 0, 0, :]
        leaf = -leaf_gh[:, 0] / (leaf_gh[:, 1] + reg_lambda) * lr
        if node is None:
            node = torch.zeros((1, grad.shape[0]), dtype=torch.int32,
                               device=dev)
        return (feat[0].to(torch.int32), thr[0].to(torch.int32), leaf,
                leaf[node[0]])

    return round_fn
