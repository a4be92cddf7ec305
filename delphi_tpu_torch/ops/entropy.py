"""Pairwise conditional-entropy correlation statistics.

    H(x|y) = H(x,y) - H(y)

where both entropies carry the reference's missing-mass correction:
frequency groups that fell below the freq-ratio threshold (or were never
observed) are modeled as ``ubDomainSize`` synthetic groups of average count
``max((n - observed_total) / ubDomainSize, 1)``. Domain sizes come from the
ORIGINAL table stats (not bin counts).

The observed part of every H(x,y) comes from one launch of kernel K2
(:mod:`delphi_tpu_torch.ops.kernels.entropy`) over the pair matrices K1
left on the device, and every H(y) from one more over the singleton counts;
only (h, total, nnz) per segment come back to the host, in one copy per
launch, where the correction is applied. For each target x the result list
is sorted ascending — strongest correlate first.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from delphi_tpu_torch.ops.freq import FreqStats, Pair
from delphi_tpu_torch.ops.kernels import entropy as k_entropy
from delphi_tpu_torch.parallel import planner


def _with_correction(h: float, total: int, n_observed: int, n_rows: int,
                     ub_domain: int) -> float:
    """Adds the missing-mass correction for unobserved/filtered groups."""
    if n_rows > total:
        ub = max(ub_domain - n_observed, 1)
        avg = max((n_rows - total) / ub, 1.0)
        h += -ub * (avg / n_rows) * math.log2(avg / n_rows)
    return h


def _segment_terms(buffer, offsets, n_rows: int):
    return k_entropy.to_host(*k_entropy.entropy_terms(buffer, offsets, n_rows))


def compute_pairwise_stats(
        n_rows: int,
        freq: FreqStats,
        target_attr_pairs: Sequence[Pair],
        domain_stats: Dict[str, int]) -> Dict[str, List[Tuple[str, float]]]:
    """For each requested (x, y): H(x|y), grouped by x and sorted
    ascending. Every pair must have been counted into ``freq``."""
    if not target_attr_pairs:
        return {}

    assert n_rows > 0
    target_attrs = list(dict.fromkeys(a for p in target_attr_pairs for a in p))
    assert all(a in domain_stats for a in target_attrs)

    # the launch planner's `entropy` plan over the unordered pairs, as the
    # JAX package records it (its buckets are its Pallas-or-host routes;
    # every pair here takes K2). K2 reduces each pair matrix on its own,
    # so the whole plan runs as the one launch below.
    uniq: List[Pair] = []
    seen = set()
    for x, y in target_attr_pairs:
        if frozenset((x, y)) not in seen:
            seen.add(frozenset((x, y)))
            uniq.append((x, y))
    plan = planner.plan_launches(
        "entropy",
        [planner.Piece(key=i, size=int(freq.pair(x, y).size),
                       shape=("pallas",))
         for i, (x, y) in enumerate(uniq)],
        persist=False)
    plan.record()

    # H(x,y): one launch over every stored pair matrix (the filter, when
    # a threshold is set, runs on the device first)
    h_p, tot_p, nnz_p = _segment_terms(
        freq.filter_device(freq.pair_buffer), freq.pair_offsets, n_rows)
    h_xy: Dict[frozenset, float] = {}
    for x, y in target_attr_pairs:
        key = frozenset((x, y))
        if key in h_xy:
            continue
        slot = freq.pair_slots[(x, y)] if (x, y) in freq.pair_slots \
            else freq.pair_slots[(y, x)]
        h_xy[key] = _with_correction(
            float(h_p[slot]), int(tot_p[slot]), int(nnz_p[slot]), n_rows,
            int(domain_stats[x]) * int(domain_stats[y]))

    # H(y): one launch over the singleton rows (their zero padding past a
    # column's vocabulary counts for nothing)
    m, stride = freq.single_buffer.shape
    h_s, tot_s, nnz_s = _segment_terms(
        freq.filter_device(freq.single_buffer).reshape(-1),
        np.arange(m + 1, dtype=np.int64) * stride, n_rows)
    h_y: Dict[str, float] = {}
    for a in target_attrs:
        slot = freq.single_slots[a]
        h_y[a] = _with_correction(
            float(h_s[slot]), int(tot_s[slot]), int(nnz_s[slot]), n_rows,
            int(domain_stats[a]))

    result: Dict[str, List[Tuple[str, float]]] = {}
    for x, y in target_attr_pairs:
        result.setdefault(x, []).append((y, h_xy[frozenset((x, y))] - h_y[y]))
    for x in result:
        result[x] = sorted(result[x], key=lambda t: t[1])
    return result


def select_candidate_pairs(
        freq_for_pruning,
        attrs_to_repair: Sequence[str],
        all_attrs: Sequence[str],
        domain_stats: Dict[str, int],
        pairwise_freq_ratio_threshold: float,
        max_attrs_to_compute_pairwise_stats: int) -> List[Pair]:
    """Candidate-pair pruning by co-occurrence distinct-count ratio: when a
    target has more candidates than the cap, keep pairs whose
    #distinct(x,y) / (|x|*|y|) is below the threshold, sorted ascending,
    truncated to the cap; remaining slots fill with near-functional pairs
    (#distinct(x,y) close to max(|x|,|y|)), excluding key-like partners.
    The same rule as the JAX package's ``select_candidate_pairs``.

    ``freq_for_pruning`` must expose ``distinct_pair_count(x, y)``.
    """
    out: List[Pair] = []
    for x in attrs_to_repair:
        candidates = [(x, y) for y in all_attrs if y != x]
        if len(candidates) > max_attrs_to_compute_pairwise_stats:
            scored = []
            for (cx, cy) in candidates:
                co = freq_for_pruning.distinct_pair_count(cx, cy)
                dx, dy = int(domain_stats[cx]), int(domain_stats[cy])
                ratio = co / (dx * dy)
                near_fd = co / max(dx, dy)  # 1.0 == exactly functional
                scored.append((ratio, near_fd, (cx, cy)))
            kept = [s for s in scored if s[0] < pairwise_freq_ratio_threshold]
            kept.sort(key=lambda t: t[0])
            kept = kept[:max_attrs_to_compute_pairwise_stats]
            if len(kept) < max_attrs_to_compute_pairwise_stats:
                chosen = {s[2] for s in kept}
                n_rows = getattr(freq_for_pruning, "n_rows", None)
                extras = []
                for s in scored:
                    if s[2] in chosen or s[1] > 1.5:
                        continue
                    _, cy2 = s[2]
                    if n_rows and int(domain_stats[cy2]) >= 0.8 * n_rows:
                        continue
                    extras.append(s)
                extras.sort(key=lambda t: (t[1], int(domain_stats[t[2][1]])))
                kept.extend(
                    extras[:max_attrs_to_compute_pairwise_stats - len(kept)])
            out.extend(p for _, _, p in kept)
        else:
            out.extend(candidates)
    return out
