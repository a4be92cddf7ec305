"""K8: batched joint inference for the escalation tier, in PyTorch.

The port of ``delphi_tpu/ops/joint.py::_jit_joint_ascent``: HoloClean-style
approximate MAP inference over a factor graph whose unary potentials come
from the co-occurrence statistics and whose pairwise potentials couple
unknown cells that share a row. A damped synchronous mean-field iteration,
one call per padded shape bucket, never a per-cell loop. The update for
cell ``i`` with belief ``b_i`` over its (padded) candidate domain is::

    b_i <- (1-d) * b_i + d * softmax(unary_i + sum_k pot_ik^T b_nbr(i,k))

with damping ``d = 0.5``, from ``b = softmax(unary)``, for a fixed number of
iterations, in f32 throughout (``device.py`` keeps TF32 off, so the
contraction is a full-precision f32 batched matmul). It runs on the
device its inputs live on, with no copy to the host between iterations.

Written as plain tensor ops (a gather, one ``einsum``, softmax, the damped
update); no hand kernel yet. :data:`launches` counts the calls. Each call
runs behind the resilience plane's guarded seam (site ``escalate.joint``).
"""

import torch

from delphi_tpu_torch.parallel.resilience import run_guarded

#: damping factor for the synchronous belief updates
DAMPING = 0.5

#: effectively -inf for masked (padded) candidate slots: large enough that
#: softmax zeroes them, small enough that f32 arithmetic stays finite
NEG_INF = -1e30

#: calls of :func:`joint_ascent` since the last :func:`reset_launches`
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def joint_ascent(unary: torch.Tensor, nbr_idx: torch.Tensor,
                 nbr_pot: torch.Tensor, iters: int) -> torch.Tensor:
    """unary f32[n, V] (log potentials, NEG_INF on padded slots); nbr_idx
    int[n, K] (cell indices of same-row unknown neighbours, -1 pad);
    nbr_pot f32[n, K, V, V] with pot[i, k, u, v] = log P(cell_i = v |
    nbr = u). Returns beliefs f32[n, V] on the inputs' device."""
    global launches
    launches += 1
    return run_guarded("escalate.joint", lambda: _ascent(
        unary, nbr_idx, nbr_pot, iters))


def _ascent(unary: torch.Tensor, nbr_idx: torch.Tensor,
            nbr_pot: torch.Tensor, iters: int) -> torch.Tensor:
    valid = (nbr_idx >= 0).to(unary.dtype)              # [n, K]
    idx = nbr_idx.clamp(min=0).long()                   # [n, K]
    b = torch.softmax(unary, dim=-1)
    for _ in range(int(iters)):
        nb = b[idx] * valid[..., None]                  # [n, K, V]
        msgs = torch.einsum("nkuv,nku->nv", nbr_pot, nb)
        b_new = torch.softmax(unary + msgs, dim=-1)
        b = (1.0 - DAMPING) * b + DAMPING * b_new
    return b
