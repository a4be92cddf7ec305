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
  device;
* big/tiny recombine in f64 with numpy's reduction order (so a probability
  within one ulp of beta cannot flip), then the beta mask and the rank
  tie-break pick the top value.

Two routes compute them, as in the JAX package:

* **bucketed** (the default; ``DELPHI_DEVICE_TABLE`` / ``repair.device_table``
  select it): every int32-safe group's cells, cut into chunks of
  ``DELPHI_PLAN_CHUNK_CELLS`` cells, become pieces of the launch planner's
  ``domain.weak`` plan (persisted, merged, shape buckets keyed by the
  JAX package's (fused, k, va_pad, vc_pad)); each plan launch packs its
  real pieces' operands into one int32 upload (the plan's batch, row and
  value padding left out: eager PyTorch gains nothing from it) and runs K5
  (:mod:`delphi_tpu_torch.ops.kernels.domain_scores`) against the
  resident code matrix, behind the guarded seam at site ``domain.bucket``
  (evict re-uploads the codes; an OOM past its retries halves the batch).
  Without a provenance ledger K5 runs its weak-label mode: the f64
  combine in numpy's row-sum order, the beta mask and the rank tie-break
  on the card, and only (has_domain, top) per cell comes back (the JAX
  package's fused mode does this for its large groups, in XLA's order;
  the port does it for every piece, in numpy's, so its mask is the host
  route's bit for bit). With a ledger, which records each cell's domain
  size, K5 runs its integer mode and the host combines and picks;
* **legacy** (``DELPHI_DEVICE_TABLE=0``, and groups that are not int32
  safe): one int64 pass per group chunk, behind the guarded seam named by
  the route the JAX package takes: ``domain.score`` when a provenance
  ledger needs every cell's probabilities, ``domain.weak_label`` (its
  fused weak-label route) otherwise. The evict rung drops the correlates'
  cached device codes, which the retry uploads afresh.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.ops import xfer
from delphi_tpu_torch.ops.freq import FreqStats
from delphi_tpu_torch.ops.kernels import domain_scores as k_domain
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.parallel.resilience import ShrinkBatch, run_guarded
from delphi_tpu_torch.table import NULL_CODE, DiscretizedTable
from delphi_tpu_torch.utils import counter_inc

# the bucketed route's least padded piece (rows), and its cap on the
# stacked pair tables of one launch (int32 elements, about 1 GiB): the
# JAX package's constants, which name its plans' policy
_BUCKET_MIN_ROWS = 256
_BUCKET_TABLE_ELEMS = 1 << 28
# JAX: groups at least this large take its fused f64 route (a piece-shape
# flag of the plan; the port takes K5's weak-label mode for every piece of
# a run without a ledger)
_FUSED_MIN_ROWS = 65536


def _chunk_cells() -> int:
    """Error cells per device pass: the launch planner's cell budget
    (``DELPHI_PLAN_CHUNK_CELLS``, legacy ``DELPHI_DOMAIN_CHUNK_CELLS``)."""
    return planner.chunk_cells(default=1_000_000)


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
    """The legacy route: yields (chunk offset, prob, contributed) for the
    group's cells. The integer accumulators run on the device over the
    correlates' resident code columns, one guarded ``site`` entry per
    chunk, come back as int64 / bool host arrays and recombine on the
    host."""
    pair_tables, taus, corr_cols, has_single, n_rows = group._ctx
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

    chunk = _chunk_cells()
    for lo in range(0, len(group.rows), chunk):
        rows = xfer.to_device(group.rows[lo:lo + chunk], torch.int64)
        big, tiny, contributed = run_guarded(
            site, lambda rows=rows: launch(rows),
            evict=lambda: xfer.evict_device_codes(corr_cols))
        prob, contributed = _combine_scores(big, tiny, contributed, n_rows)
        yield lo, prob, contributed


def _combine_scores(big: np.ndarray, tiny: np.ndarray, contributed: np.ndarray,
                    n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Probabilities from the integer sums (int64, or f64 holding exact
    integers), in the host numpy route's order of operations."""
    score = (np.asarray(big, np.float64)
             + 0.1 * np.asarray(tiny, np.float64)) / n_rows
    denom = score.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        prob = np.where(denom > 0, score / denom, 0.0)
    return prob, contributed


# ---------------------------------------------------------------------------
# the bucketed route: shape-bucketed launches of K5 over the resident codes
# ---------------------------------------------------------------------------


def _int32_safe_group(group: _AttrGroup) -> bool:
    """K5 accumulates in int32: k * max pair count must stay under 2^31
    (the JAX package's guard); other groups take the legacy route."""
    pair_tables = group._ctx[0]
    max_count = max((int(t.max(initial=0)) for t in pair_tables), default=0)
    return len(pair_tables) * max(max_count, 1) < 2 ** 31


def _prep_group_operands(group: _AttrGroup) -> dict:
    """Host-side padded operands of one group, with the JAX package's
    padding: the value axis to a multiple of 32, the correlate tables'
    rows to a power of two (at least 8). ``v_a`` and ``vc`` (each
    table's rows) are the real extents."""
    pair_tables, taus, corr_cols, has_single, n = group._ctx
    k = len(corr_cols)
    v_a = int(has_single.shape[0])
    va_pad = -(-v_a // 32) * 32
    vc_max = max(int(t.shape[0]) for t in pair_tables)
    vc_pad = planner.pow2_pad(vc_max, floor=8)
    tables = np.zeros((k, vc_pad, va_pad + 1), np.int32)
    for i, t in enumerate(pair_tables):
        tables[i, :t.shape[0], :t.shape[1]] = t
    hs = np.zeros(va_pad, np.int32)
    hs[:v_a] = np.asarray(has_single, bool)
    return dict(k=k, v_a=v_a, va_pad=va_pad, vc_pad=vc_pad, n=n,
                vc=[int(t.shape[0]) for t in pair_tables], tables=tables,
                taus=np.asarray([max(int(t), 0) for t in taus], np.int32),
                hs=hs)


def _stack_all_codes(cols) -> torch.Tensor:
    """The distinct correlate columns' resident codes stacked into the
    [cols, rows] gather matrix."""
    return torch.stack([xfer.device_codes(c) for c in cols])


def _bucketed_run(jobs, weak: bool, beta: float,
                  phase: str = "domain.weak") -> Dict[int, list]:
    """Scores every (group, chunk) piece of ``jobs`` ((group index, group,
    fused, vocab ranks) quadruples) in the launch planner's shape-bucketed
    launches of K5, in its weak-label mode when ``weak`` (no ledger) and
    in its integer mode otherwise. Returns {group index: [(chunk offset,
    has_domain, top), ...]} (weak) or {group index: [(chunk offset, prob,
    contributed), ...]}, sorted by offset."""
    col_slot: Dict[int, int] = {}
    cols = []
    for _, g, _, _ in jobs:
        for c in g._ctx[2]:
            if id(c) not in col_slot:
                col_slot[id(c)] = len(cols)
                cols.append(c)
    # a holder: the evict rung re-uploads the codes and restacks in place
    codes_state = {"cols": cols, "all_codes": _stack_all_codes(cols)}

    chunk = _chunk_cells()
    out: Dict[int, list] = {j[0]: [] for j in jobs}
    ctx: Dict[int, tuple] = {}
    pieces = []
    for gi, g, fused, rank in jobs:
        prep = _prep_group_operands(g)
        cidx = np.asarray([col_slot[id(c)] for c in g._ctx[2]], np.int32)
        ctx[gi] = (g, prep, cidx, rank)
        pieces.append(planner.Piece(
            key=gi, size=len(g.rows),
            shape=(bool(fused), prep["k"], prep["va_pad"], prep["vc_pad"])))

    def bucket_cap(shape, rows_pad):
        # cells per launch bounded by the chunk, the duplicated pair
        # tables by _BUCKET_TABLE_ELEMS
        _, k, va_pad, vc_pad = shape
        per_tables = k * vc_pad * (va_pad + 1)
        return max(1, min(chunk // max(rows_pad, 1),
                          _BUCKET_TABLE_ELEMS // max(per_tables, 1)))

    plan = planner.plan_launches(
        phase, pieces, size_floor=_BUCKET_MIN_ROWS, chunk=chunk,
        batch_cap=bucket_cap, pad_batch=True, merge=True,
        policy_tag=f"elems={_BUCKET_TABLE_ELEMS}")
    plan.record()

    # every piece shares the table's row count (freq.n_rows)
    n_rows = float(jobs[0][1]._ctx[4])
    for launch in plan.launches:
        vc_pad = launch.shape[3]
        batch = []
        for span in launch.spans:
            g, prep, cidx, rank = ctx[span.key]
            batch.append((span.key, span.lo, k_domain.Piece(
                rows=g.rows[span.lo:span.lo + span.size], col_idx=cidx,
                taus=prep["taus"], vcs=prep["vc"], hs=prep["hs"][:prep["v_a"]],
                rank=rank, tables=prep["tables"])))
        with plan.launch_scope(launch):
            _launch_bucket(batch, vc_pad, codes_state, weak, beta, n_rows,
                           out)
    for gi in out:
        out[gi].sort(key=lambda t: t[0])
    return out


def _launch_bucket(batch, vc_pad, codes_state, weak, beta, n_rows,
                   out) -> None:
    """One guarded bucket launch. When an OOM outlasts its retries the
    resilience plane raises ShrinkBatch and the batch halves, recursively;
    results are assembled per piece, so a split launch gives the same
    results in more launches."""
    try:
        _launch_bucket_once(batch, vc_pad, codes_state, weak, beta, n_rows,
                            out)
    except ShrinkBatch:
        half = (len(batch) + 1) // 2
        for part in (batch[:half], batch[half:]):
            _launch_bucket(part, vc_pad, codes_state, weak, beta, n_rows,
                           out)


def _launch_bucket_once(batch, vc_pad, codes_state, weak, beta, n_rows,
                        out) -> None:
    # The plan (recorded by the caller) pads the batch to a power of two,
    # each piece to the launch's ``rows_pad`` and the values to ``va_pad``,
    # for XLA's executable cache. Eager PyTorch gains nothing from those
    # extents: K5 takes the batch's real pieces, their cells back to back
    # and values to the widest piece's, and only the real cells' results
    # come back to the host, in one copy. A shrink halves the batch the
    # same way.
    blob_np, layout = k_domain.pack([p for _, _, p in batch], vc_pad)
    b = len(batch)
    counter_inc("domain.bucket_launches")
    counter_inc("domain.bucket_pieces", b)

    def evict():
        # transfer-fault rung: re-upload the resident codes and restack
        xfer.evict_device_codes(codes_state["cols"])
        codes_state["all_codes"] = _stack_all_codes(codes_state["cols"])

    def launch():
        # one upload per launch: the operands travel as one int32 blob
        ops = k_domain.Operands(codes_state["all_codes"],
                                xfer.to_device(blob_np), layout)
        if weak:
            buf = k_domain.weak_label(ops, beta, n_rows)
        else:
            buf = k_domain.domain_scores(ops)
        return buf.cpu()

    buf = run_guarded("domain.bucket", launch, can_shrink=b > 1, evict=evict)
    counter_inc("domain.bytes_to_host", int(buf.numel()))
    at = 0
    if weak:
        has_domain, top = (t.numpy() for t in
                           k_domain.split_weak(buf, layout.cells))
        for (gi, lo, _), (m, _) in zip(batch, layout.extents):
            out[gi].append((lo, has_domain[at:at + m], top[at:at + m]))
            at += m
        return
    big, tiny, contributed = (t.numpy() for t in k_domain.split_scores(
        buf, layout.cells, layout.va))
    for (gi, lo, _), (m, v_a) in zip(batch, layout.extents):
        # row-major copies: numpy's row sum follows the memory order, and
        # the host route sums C-contiguous rows
        big_p, tiny_p, con_p = (np.ascontiguousarray(a[at:at + m, :v_a])
                                for a in (big, tiny, contributed))
        prob, contrib = _combine_scores(big_p, tiny_p, con_p, n_rows)
        out[gi].append((lo, prob, contrib))
        at += m


def _vocab_ranks(vocab) -> Tuple[np.ndarray, np.ndarray]:
    """(vocab strings, rank of each vocab slot in string order): the pick
    takes the lexicographically-smallest value among probability ties."""
    vocab_str = np.array([str(v) for v in vocab], dtype=object)
    order = np.argsort(vocab_str.astype(str), kind="stable")
    vocab_rank = np.empty(len(vocab), dtype=np.int64)
    vocab_rank[order] = np.arange(len(vocab))
    return vocab_str, vocab_rank


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
    groups = list(_iter_attr_groups(
        disc, cells, continuous_attrs, target_attrs, freq, pairwise_stats,
        domain_stats, max_attrs_to_compute_domains, alpha))
    ranks = {gi: _vocab_ranks(table.column(g.attr).vocab)
             for gi, g in enumerate(groups) if not g.empty_domain}
    # the bucketed route first, over every int32-safe group: K5's
    # weak-label mode without a ledger, its integer mode with one (the JAX
    # package's "fused" flag, a piece-shape key of its plan, marks the
    # large groups of a run without a ledger)
    bucketed: Dict[int, list] = {}
    if xfer.device_table_enabled():
        jobs = [(gi, g, led is None and len(g.rows) >= _FUSED_MIN_ROWS,
                 ranks[gi][1])
                for gi, g in enumerate(groups)
                if not g.empty_domain and _int32_safe_group(g)]
        if jobs:
            bucketed = _bucketed_run(jobs, weak=led is None, beta=beta)
    for gi, group in enumerate(groups):
        if group.empty_domain:
            if led is not None and len(group.rows):
                led.record_domain_sizes(
                    group.rows, group.attr,
                    np.zeros(len(group.rows), dtype=np.int64))
            continue  # empty domain -> never demoted
        vocab_str, vocab_rank = ranks[gi]
        chunks = bucketed.get(gi)
        if chunks is not None and led is None:
            # the weak-label mode's per-cell results (the JAX package's
            # fused pieces, domain.py:378-382)
            for lo, has_domain, top in chunks:
                eq = vocab_str[np.minimum(top, len(vocab_str) - 1)] \
                    == group.currents[lo:lo + len(top)]
                demote[group.pos[lo:lo + len(top)]] = \
                    has_domain & eq.astype(bool)
            continue
        if chunks is None:
            site = "domain.score" if led is not None else "domain.weak_label"
            chunks = _score_chunks(group, site)
        for lo, prob, contributed in chunks:
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
