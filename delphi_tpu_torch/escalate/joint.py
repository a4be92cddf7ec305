"""Tier B: HoloClean-style joint inference over correlated attributes.

The port of ``delphi_tpu/escalate/joint.py``. It builds a factor graph for
the routed cells out of :func:`delphi_tpu_torch.ops.freq.compute_freq_stats`
over the MASKED table (so every count comes from cells believed clean, and
kernel K1 counts the pairs):

* **unary potentials** — Laplace-smoothed log prior of each candidate value
  plus one log-conditional term per OBSERVED same-row context attribute
  (``log P(a = v | c = u)`` from the pair count matrices);
* **pairwise potentials** — the same conditionals between two UNKNOWN cells
  that share a row, which single-cell scoring cannot express.

Cells group by the power-of-two pad of their candidate-domain size, as the
JAX package's launch planner groups them with no cap, chunk or merge: one
launch per band, the cell axis padded to a power of two, launches in
ascending band order, cells in first-occurrence order within a band.
Neighbour coupling only spans cells of the same launch. Each launch is one
call of K8 (:func:`delphi_tpu_torch.ops.joint.joint_ascent`) on the port's
device.

A proposal is accepted when its converged belief clears both the routing
threshold and the cell's original confidence: joint inference must be MORE
sure than the model it overrides.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from delphi_tpu_torch.device import get_device
from delphi_tpu_torch.escalate.router import RoutedCell
from delphi_tpu_torch.ops import joint as k_joint
from delphi_tpu_torch.ops.freq import compute_freq_stats
from delphi_tpu_torch.ops.joint import NEG_INF
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.utils import counter_inc

#: Laplace smoothing for every count-derived log potential
ALPHA = 0.5
#: largest candidate domain joint inference will model (the pairwise
#: potentials are [V, V] per neighbour edge — quadratic memory)
MAX_DOMAIN = 64
#: observed context attributes folded into each cell's unary potential
CTX_CAP = 4
#: same-row unknown neighbours kept per cell (column order, deterministic)
NBR_CAP = 4


class JointProposal:
    __slots__ = ("cell", "value", "belief")

    def __init__(self, cell: RoutedCell, value: str, belief: float) -> None:
        self.cell = cell
        self.value = value
        self.belief = belief


def plan_buckets(v_sizes: List[int]) -> List[Tuple[int, int, List[int]]]:
    """``(v_pad, n_pad, members)`` per launch for cells whose candidate
    domains have ``v_sizes``, from the launch planner's recorded
    ``escalation.joint`` plan: one launch per power-of-two band (the
    band is the piece shape, never merged), in ascending band order,
    members (indices into ``v_sizes``) in first-occurrence order, the cell
    axis padded to a power of two."""
    plan = planner.plan_launches(
        "escalation.joint",
        [planner.Piece(key=i, size=1, shape=(planner.pow2_pad(v),))
         for i, v in enumerate(v_sizes)],
        pad_batch=True, persist=False)
    plan.record()
    return [(int(l.shape[0]), int(l.batch_pad),
             [int(s.key) for s in l.spans])
            for l in sorted(plan.launches, key=lambda l: l.shape[0])]


def _log_cond(pair_uv: np.ndarray, single_u: np.ndarray,
              v_size: int) -> np.ndarray:
    """log P(v | u) with Laplace smoothing; ``pair_uv`` is [U+1, V+1] raw
    counts (slot 0 = NULL), returns [U, V] over the non-NULL values."""
    num = pair_uv[1:, 1:].astype(np.float64) + ALPHA
    den = single_u[1:].astype(np.float64)[:, None] + ALPHA * v_size
    return np.log(num / den)


def run_joint_tier(masked: Any, cells: List[RoutedCell],
                   conf_threshold: float, iters: int) -> List[JointProposal]:
    """Joint inference over ``cells`` against the ``masked`` encoded table
    (error cells already nulled). Returns the accepted proposals; counters
    ``escalation.joint.*`` record launches, cells and proposals."""
    if not cells:
        return []
    name_to_col = {c.name: c for c in masked.columns}
    # participating attributes: discrete enough for the [V, V] potentials
    attrs = [c.name for c in masked.columns
             if c.name in {x.attribute for x in cells}
             and 1 <= c.domain_size <= MAX_DOMAIN]
    attr_set = set(attrs)
    todo = [c for c in cells if c.attribute in attr_set]
    if not todo:
        return []
    # context attributes: reasonably discrete columns, capped so the
    # all-pairs statistics pass stays bounded on wide tables
    ctx_attrs = [c.name for c in masked.columns
                 if 1 <= c.domain_size <= MAX_DOMAIN]
    needed = list(dict.fromkeys(attrs + ctx_attrs))[:16]
    ctx_attrs = [a for a in ctx_attrs if a in set(needed)]
    pairs = [(a, b) for i, a in enumerate(needed) for b in needed[i + 1:]]
    stats = compute_freq_stats(masked, needed, pairs)

    routed_keys = {(c.row_pos, c.attribute) for c in todo}
    by_row: Dict[int, List[int]] = {}
    for i, c in enumerate(todo):
        by_row.setdefault(c.row_pos, []).append(i)

    # the prior and the conditionals depend only on the attributes, so
    # they are computed once per attribute and per (context, attribute)
    # pair instead of once per cell; the f64 sums below keep the
    # reference's order, so the unaries are the same numbers
    prior: Dict[str, np.ndarray] = {}
    cond: Dict[Tuple[str, str], np.ndarray] = {}

    def prior_of(a: str) -> np.ndarray:
        if a not in prior:
            single_a = stats.single(a, filtered=False)
            n_obs = float(single_a[1:].sum())
            prior[a] = np.log((single_a[1:].astype(np.float64) + ALPHA)
                              / (n_obs + ALPHA * name_to_col[a].domain_size))
        return prior[a]

    def cond_of(b: str, a: str) -> np.ndarray:
        if (b, a) not in cond:
            cond[(b, a)] = _log_cond(stats.pair(b, a, filtered=False),
                                     stats.single(b, filtered=False),
                                     name_to_col[a].domain_size)
        return cond[(b, a)]

    dev = get_device()
    proposals: List[JointProposal] = []
    for v_pad, n_pad, members in plan_buckets(
            [name_to_col[c.attribute].domain_size for c in todo]):
        members = [int(m) for m in members]
        unary = np.full((n_pad, v_pad), NEG_INF, dtype=np.float32)
        unary[:, 0] = 0.0  # padded rows: a defined softmax, discarded below
        nbr_idx = np.full((n_pad, NBR_CAP), -1, dtype=np.int32)
        # neighbour edges (slot, k, [vb, va] potential): most cells have
        # none, so the dense [n, K, V, V] tensor is built on the device
        edges: List[Tuple[int, int, np.ndarray]] = []
        slot_of = {idx: s for s, idx in enumerate(members)}

        for s, idx in enumerate(members):
            cell = todo[idx]
            a = cell.attribute
            va = name_to_col[a].domain_size
            u = prior_of(a)
            # observed context: same-row cells that are NOT routed unknowns
            n_ctx = 0
            for c_attr in ctx_attrs:
                if c_attr == a or n_ctx >= CTX_CAP:
                    continue
                if (cell.row_pos, c_attr) in routed_keys:
                    continue
                code = int(name_to_col[c_attr].codes[cell.row_pos])
                if code < 0 or not stats.has_pair(c_attr, a):
                    continue
                u = u + cond_of(c_attr, a)[code]
                n_ctx += 1
            unary[s, :va] = u.astype(np.float32)
            unary[s, va:] = NEG_INF
            # unknown neighbours: other routed cells of this row, same band
            k = 0
            for j in by_row.get(cell.row_pos, []):
                if j == idx or k >= NBR_CAP:
                    continue
                other = todo[j]
                if other.attribute == a or j not in slot_of:
                    continue
                b_attr = other.attribute
                if not stats.has_pair(b_attr, a):
                    continue
                nbr_idx[s, k] = slot_of[j]
                edges.append((s, k, cond_of(b_attr, a).astype(np.float32)))
                k += 1

        nbr_pot = torch.zeros((n_pad, NBR_CAP, v_pad, v_pad),
                              dtype=torch.float32, device=dev)
        if edges:
            block = np.zeros((len(edges), v_pad, v_pad), dtype=np.float32)
            for e, (_, _, pot) in enumerate(edges):
                block[e, :pot.shape[0], :pot.shape[1]] = pot
            rows = torch.as_tensor([e[0] for e in edges], device=dev)
            ks = torch.as_tensor([e[1] for e in edges], device=dev)
            nbr_pot[rows, ks] = torch.as_tensor(block, device=dev)
        beliefs = k_joint.joint_ascent(
            torch.as_tensor(unary, device=dev),
            torch.as_tensor(nbr_idx, device=dev), nbr_pot, iters) \
            .cpu().numpy()
        counter_inc("escalation.joint.launches")
        counter_inc("escalation.joint.cells", len(members))

        for s, idx in enumerate(members):
            cell = todo[idx]
            col = name_to_col[cell.attribute]
            va = col.domain_size
            b = beliefs[s, :va]
            v = int(np.argmax(b))
            value = str(col.vocab[v])
            accept_at = max(conf_threshold, cell.confidence or 0.0)
            if value != cell.current_value and float(b[v]) >= accept_at:
                proposals.append(JointProposal(cell, value, float(b[v])))
    counter_inc("escalation.joint.proposals", len(proposals))
    return proposals
