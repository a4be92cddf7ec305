"""Weak-label demotion of noisy cells by naive-Bayes cell-domain scoring.

For the error cells of target ``a``, each correlated attribute's pair-count
row is gathered, thresholded by tau, turned into evidence weights
``max(cnt - 1, 0.1)``, summed over correlates and normalized per cell; a
cell is demoted (deemed clean) when its top-scoring value above beta equals
its current value. Semantics of the JAX package's host route
(``_score_cells`` + ``_combine_scores``):

* tau = int(alpha * (n_rows // (|dom c| * |dom a|))) — the reference's
  integer-division quirk;
* the score splits into two exact integer accumulators, big = sum(cnt-1 |
  cnt >= 2) and tiny = #(cnt == 1) over active correlates, computed on the
  device in int64;
* big/tiny recombine on the host in f64 (the same numpy reduction as the
  reference, so a probability within one ulp of beta cannot flip), then the
  beta mask and the rank tie-break pick the top value.

Each chunk's device pass runs behind the resilience plane's guarded seam,
named by the route the JAX package takes: ``domain.score`` when a
provenance ledger needs every cell's probabilities, ``domain.weak_label``
(its fused weak-label route) otherwise. The evict rung drops the
correlates' cached device codes, which the retry uploads afresh.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.ops import xfer
from delphi_tpu_torch.ops.freq import FreqStats
from delphi_tpu_torch.parallel.resilience import run_guarded
from delphi_tpu_torch.table import NULL_CODE, DiscretizedTable
from delphi_tpu_torch.utils import counter_inc

# error cells scored per device pass
_CHUNK_CELLS = 1_000_000


@dataclass
class _AttrGroup:
    """One target attribute's error cells plus what scoring needs for them:
    (pair tables [V_c+1, V_a+1], taus, correlate columns, has_single [V_a],
    n_rows)."""
    attr: str
    pos: np.ndarray           # positions into the caller's cell arrays
    rows: np.ndarray
    currents: np.ndarray
    empty_domain: bool
    _ctx: Optional[tuple] = None


def _iter_attr_groups(disc: DiscretizedTable,
                      cells: Tuple[np.ndarray, np.ndarray, np.ndarray],
                      continuous_attrs: Sequence[str],
                      target_attrs: Sequence[str],
                      freq: FreqStats,
                      pairwise_stats: Dict[str, List[Tuple[str, float]]],
                      domain_stats: Dict[str, int],
                      max_attrs_to_compute_domains: int,
                      alpha: float):
    """Per-target-attribute groups: correlate selection (top pairwise
    attrs that have pair counts), taus and the pair-table / correlate
    assembly."""
    n = freq.n_rows
    table = disc.table
    continuous = set(continuous_attrs)
    rows_all, attrs_all, curs_all = cells
    attr_codes, attr_uniques = pd.factorize(attrs_all) if len(attrs_all) \
        else (np.zeros(0, np.int64), np.zeros(0, object))

    for ai, attr in enumerate(attr_uniques):
        if attr not in target_attrs:
            continue
        pos = np.nonzero(attr_codes == ai)[0]
        rows = rows_all[pos]
        currents = curs_all[pos]

        corr_attrs = [c for c, _ in
                      pairwise_stats.get(attr, [])][:max_attrs_to_compute_domains]
        corr_attrs = [c for c in corr_attrs if freq.has_pair(c, attr)]
        if attr in continuous or not corr_attrs or not table.has_column(attr):
            yield _AttrGroup(attr, pos, rows, currents, empty_domain=True)
            continue

        single = freq.single(attr)[1:]  # [v_a], non-NULL value counts
        has_single = single > 0
        pair_tables, taus, corr_cols = [], [], []
        for c in corr_attrs:
            d_c = int(domain_stats[c])
            d_a = int(domain_stats[attr])
            taus.append(int(alpha * (n // max(d_c * d_a, 1))))
            pair_tables.append(freq.pair(c, attr))  # [V_c + 1, V_a + 1]
            corr_cols.append(table.column(c))
        yield _AttrGroup(attr, pos, rows, currents, empty_domain=False,
                         _ctx=(pair_tables, taus, corr_cols, has_single, n))


def _score_chunks(group: _AttrGroup, site: str):
    """Yields (chunk offset, big, tiny, contributed) for the group's cells:
    the integer accumulators run on the device over the correlates'
    resident code columns, one guarded ``site`` entry per chunk, and come
    back as int64 / bool host arrays."""
    pair_tables, taus, corr_cols, has_single, _ = group._ctx
    tables = [xfer.to_device(t, torch.int64) for t in pair_tables]
    hs = xfer.to_device(has_single, torch.bool)

    def launch(rows: torch.Tensor):
        big = torch.zeros((len(rows), int(hs.shape[0])), dtype=torch.int64,
                          device=rows.device)
        tiny = torch.zeros_like(big)
        contributed = torch.zeros_like(big, dtype=torch.bool)
        for table_c, tau, col in zip(tables, taus, corr_cols):
            codes_c = xfer.device_codes(col)[rows].long()
            gathered = table_c[codes_c + 1][:, 1:]    # [cells, v_a]
            valid = (codes_c != NULL_CODE)[:, None]
            active = (gathered > max(tau, 0)) & (gathered > 0) & valid \
                & hs[None, :]
            big += torch.where(active & (gathered >= 2), gathered - 1,
                               torch.zeros_like(gathered))
            tiny += (active & (gathered == 1)).long()
            contributed |= active
        return big.cpu().numpy(), tiny.cpu().numpy(), \
            contributed.cpu().numpy()

    for lo in range(0, len(group.rows), _CHUNK_CELLS):
        rows = xfer.to_device(group.rows[lo:lo + _CHUNK_CELLS], torch.int64)
        big, tiny, contributed = run_guarded(
            site, lambda rows=rows: launch(rows),
            evict=lambda: xfer.evict_device_codes(corr_cols))
        yield lo, big, tiny, contributed


def _combine_scores(big: np.ndarray, tiny: np.ndarray, contributed: np.ndarray,
                    n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    score = (big.astype(np.float64) + 0.1 * tiny.astype(np.float64)) / n_rows
    denom = score.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        prob = np.where(denom > 0, score / denom, 0.0)
    return prob, contributed


def compute_weak_label_mask(
        disc: DiscretizedTable,
        cells: Tuple[np.ndarray, np.ndarray, np.ndarray],
        continuous_attrs: Sequence[str],
        target_attrs: Sequence[str],
        freq: FreqStats,
        pairwise_stats: Dict[str, List[Tuple[str, float]]],
        domain_stats: Dict[str, int],
        max_attrs_to_compute_domains: int,
        alpha: float,
        beta: float) -> np.ndarray:
    """Weak-label demotion mask aligned with ``cells`` (rows int64[n],
    attributes object[n], current values object[n]): True where the cell's
    TOP domain value (highest posterior above beta, ties broken by the
    value's string order) equals its current value. With a provenance
    ledger active, each cell's candidate-domain size (the values kept above
    beta) is recorded."""
    assert max_attrs_to_compute_domains > 0
    table = disc.table
    led = active_ledger()
    # cells scored this run: the incremental A/B's proof that a delta run
    # scored the planned rows only
    counter_inc("domain.cells_scored", int(len(cells[0])))
    demote = np.zeros(len(cells[0]), dtype=bool)
    for group in _iter_attr_groups(
            disc, cells, continuous_attrs, target_attrs, freq,
            pairwise_stats, domain_stats, max_attrs_to_compute_domains,
            alpha):
        if group.empty_domain:
            if led is not None and len(group.rows):
                led.record_domain_sizes(
                    group.rows, group.attr,
                    np.zeros(len(group.rows), dtype=np.int64))
            continue  # empty domain -> never demoted
        vocab = table.column(group.attr).vocab
        vocab_str = np.array([str(v) for v in vocab], dtype=object)
        # rank of each vocab slot in string order: the argmin below picks
        # the lexicographically-smallest value among probability ties
        order = np.argsort(vocab_str.astype(str), kind="stable")
        vocab_rank = np.empty(len(vocab), dtype=np.int64)
        vocab_rank[order] = np.arange(len(vocab))
        n_rows = group._ctx[4]
        site = "domain.score" if led is not None else "domain.weak_label"
        for lo, big, tiny, contributed in _score_chunks(group, site):
            prob, contributed = _combine_scores(big, tiny, contributed, n_rows)
            keep = contributed & (prob > beta)
            if led is not None and len(prob):
                led.record_domain_sizes(group.rows[lo:lo + len(prob)],
                                        group.attr, keep.sum(axis=1))
            masked = np.where(keep, prob, -np.inf)
            best_p = masked.max(axis=1)
            has_domain = best_p > -np.inf
            ties = masked == best_p[:, None]
            rank_masked = np.where(ties, vocab_rank[None, :],
                                   np.iinfo(np.int64).max)
            top = rank_masked.argmin(axis=1)
            eq = vocab_str[top] == group.currents[lo:lo + len(prob)]
            demote[group.pos[lo:lo + len(prob)]] = has_domain & eq.astype(bool)
    return demote
