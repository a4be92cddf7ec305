"""Error-detection scans over encoded tables.

Detectors return row-index arrays per attribute; :mod:`delphi_tpu_torch.
errors` shapes them into (row_id, attribute) frames.

What runs where:

* NULL scan: one mask over each column's device codes.
* RegEx scan: the regex runs once per vocabulary entry on the host; the
  verdicts broadcast through the device codes.
* Gaussian (IQR) outliers: every continuous attribute's q1/q3 in one
  batched f64 sort + numpy-order linear interpolation on the device; the
  fences then apply to every row on the device.
* Denial-constraint violations: rows are grouped by the EQ-predicate key
  and the remaining predicate is answered with group-level statistics on
  the device — equal-key counts by sort + two searchsorted passes,
  composite keys re-densified to ranks after each column, per-group f64
  extrema by ``scatter_reduce`` — O(n log n), not O(n²). One-tuple
  (all-constant) constraints match on the vocabulary on the host, and the
  mixed-residual conjunctions walk blocked pairs on the host, as in the
  JAX package.

Every result is an integer or a comparison of exact f64 values, so the
CPU tensors of the tests and the card give the same cells. Each device
step adds to its ``detect.*`` count in :data:`delphi_tpu_torch.utils.
counters`.
"""

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from delphi_tpu_torch.constraints import (AttrRef, Constant,
                                          DenialConstraints, Predicate)
from delphi_tpu_torch.device import get_device
from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.ops import xfer
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.parallel.resilience import ShrinkBatch, run_guarded
from delphi_tpu_torch.table import NULL_CODE, EncodedTable
from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()

CellIndex = Tuple[np.ndarray, str]  # (row indices, attribute)


def _rows(mask: torch.Tensor) -> np.ndarray:
    """Ascending row positions of a device mask, on the host."""
    return torch.nonzero(mask).reshape(-1).cpu().numpy()


def detect_null_cells(table: EncodedTable, target_attrs: Sequence[str]) \
        -> List[CellIndex]:
    """Ascending row positions of the NULL cells of every target column,
    found on the device over the column's resident codes."""
    # rows this pass walks: the incremental A/B's proof that a delta run
    # detected over the planned rows only
    counter_inc("detect.rows_scanned", table.n_rows)
    out = []
    for name in table.column_names:
        if name in target_attrs:
            rows = _rows(xfer.device_codes(table.column(name)) == NULL_CODE)
            if rows.size:
                out.append((rows, name))
    return out


def detect_regex_errors(table: EncodedTable, attr: str, regex: str,
                        target_attrs: Sequence[str]) -> List[CellIndex]:
    """Cells whose string value does NOT contain a match of ``regex`` (RLIKE
    partial-match semantics), plus NULLs."""
    if attr not in target_attrs or not regex or not regex.strip():
        return []
    try:
        compiled = re.compile(regex)
    except re.error:
        _logger.warning(f"Invalid regex found: {regex}")
        return []
    col = table.column(attr)
    # Evaluate on the vocab (distinct values), then broadcast through codes.
    vocab_ok = xfer.to_device(np.array(
        [compiled.search(str(v)) is not None for v in col.vocab] + [False],
        dtype=bool))
    # NULL (-1) reads the appended False: non-matching
    codes = xfer.device_codes(col).long()
    rows = _rows(~vocab_ok[torch.where(codes >= 0, codes, len(col.vocab))])
    return [(rows, attr)] if rows.size else []


APPROX_PERCENTILE_SAMPLE = 100_000


def _device_values(col) -> torch.Tensor:
    """A numeric column's f64 values (NaN for NULL) on the device."""
    assert col.numeric is not None
    return xfer.to_device(np.asarray(col.numeric, dtype=np.float64))


def detect_outliers(table: EncodedTable, continuous_attrs: Sequence[str],
                    target_attrs: Sequence[str],
                    approx: bool = False) -> List[CellIndex]:
    """Box-and-whisker outliers per continuous attribute: flag values
    outside [q1 - 1.5*IQR, q3 + 1.5*IQR]. With ``approx``, columns larger
    than ``APPROX_PERCENTILE_SAMPLE`` estimate q1/q3 from a seeded random
    sample (the same draw as the JAX package's); the fences still apply to
    every row. Every attribute's quartiles come from one batched launch."""
    attrs = [a for a in continuous_attrs if a in target_attrs]
    pools = []
    for attr in attrs:
        values = _device_values(table.column(attr))
        valid = ~torch.isnan(values)
        pool = values[valid]
        if not pool.numel():
            continue
        if approx and len(pool) > APPROX_PERCENTILE_SAMPLE:
            # with-replacement index draw: O(sample) work and memory
            rng = np.random.RandomState(42)
            pool = pool[xfer.to_device(
                rng.randint(0, len(pool), APPROX_PERCENTILE_SAMPLE))]
        pools.append((attr, values, valid, pool))
    if not pools:
        return []

    # the batch layout of the launch planner (one shape bucket, every pool
    # padded to the longest), as the JAX package's device route records it
    plan = planner.plan_launches(
        "detect.percentile",
        [planner.Piece(key=i, size=len(p[3])) for i, p in enumerate(pools)],
        pad_to_max=True, persist=False)
    plan.record()
    with plan.launch_scope(plan.launches[0]):
        qs = percentile_batch([p[3] for p in pools],
                              (25.0, 75.0)).cpu().numpy()
    out = []
    for i, (attr, values, valid, _) in enumerate(pools):
        q1, q3 = float(qs[i, 0]), float(qs[i, 1])
        lower = q1 - 1.5 * (q3 - q1)
        upper = q3 + 1.5 * (q3 - q1)
        _logger.info(f"Non-outlier values in {attr} should be in [{lower}, {upper}]")
        rows = _rows(valid & ((values < lower) | (values > upper)))
        if rows.size:
            out.append((rows, attr))
    return out


def percentile_batch(pools: Sequence[torch.Tensor],
                     percents: Sequence[float]) -> torch.Tensor:
    """``np.percentile(pool, percents)`` (linear method) of every NaN-free
    f64 pool, bit for bit, as one sort of the pools padded with +inf to
    ``[len(pools), longest]``: a row's real values sort ahead of its
    padding, so its order statistics are its own. The lerp is numpy's
    (``a + d*g`` below g = 0.5, ``b - d*(1-g)`` above), one elementwise op
    at a time so that no multiply-add fuses. Returns f64
    ``[len(pools), len(percents)]``.

    Runs behind the guarded seam (site ``detect.percentile``): when an OOM
    outlasts its retries, the ladder's shrink rung halves the pools and
    each half runs on its own, recursively, with the same values (every
    row's order statistics are its own)."""
    counter_inc("detect.percentile")

    def guarded(block: Sequence[torch.Tensor]) -> torch.Tensor:
        try:
            return run_guarded(
                "detect.percentile",
                lambda: _percentiles(block, percents),
                can_shrink=len(block) > 1)
        except ShrinkBatch:
            half = (len(block) + 1) // 2
            return torch.cat([guarded(block[:half]), guarded(block[half:])])

    return guarded(list(pools))


def _percentiles(pools: Sequence[torch.Tensor],
                 percents: Sequence[float]) -> torch.Tensor:
    dev = pools[0].device
    sizes = torch.tensor([len(p) for p in pools], dtype=torch.int64,
                         device=dev)
    longest = max(len(p) for p in pools)
    padded = torch.full((len(pools), longest), float("inf"),
                        dtype=torch.float64, device=dev)
    for i, p in enumerate(pools):
        padded[i, :len(p)] = p
    srt = torch.sort(padded, dim=1).values
    q = torch.tensor([float(p) / 100.0 for p in percents],
                     dtype=torch.float64, device=dev)
    last = (sizes - 1)[:, None]
    virtual = last.to(torch.float64) * q[None, :]
    prev = torch.floor(virtual).to(torch.int64)
    nxt = prev + 1
    # numpy's bounds rule: at or past the last value both neighbours are
    # the last value and the weight counts from index -1
    above = virtual >= last.to(torch.float64)
    prev = torch.where(above, last, prev)
    nxt = torch.where(above, last, nxt)
    gamma = virtual - torch.where(above, torch.full_like(prev, -1), prev) \
        .to(torch.float64)
    a = torch.gather(srt, 1, prev)
    b = torch.gather(srt, 1, nxt)
    diff = b - a
    low = a + diff * gamma
    high = b - diff * (1 - gamma)
    return torch.where(gamma >= 0.5, high, low)


def _shared_codes(table: EncodedTable, left: str, right: str) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Codes for two columns in a shared dictionary, so cross-attribute
    equality can compare codes directly (NULL stays -1); the columns' own
    codes when ``left == right``."""
    cl, cr = table.column(left), table.column(right)
    if left == right:
        return cl.codes, cr.codes
    vocab = {}
    for v in cl.vocab:
        vocab.setdefault(v, len(vocab))
    for v in cr.vocab:
        vocab.setdefault(v, len(vocab))
    map_l = np.array([vocab[v] for v in cl.vocab], dtype=np.int64)
    map_r = np.array([vocab[v] for v in cr.vocab], dtype=np.int64)

    def remap(codes: np.ndarray, m: np.ndarray) -> np.ndarray:
        out = np.full(codes.shape, NULL_CODE, dtype=np.int64)
        valid = codes != NULL_CODE
        out[valid] = m[codes[valid]]
        return out

    return remap(cl.codes, map_l), remap(cr.codes, map_r)


def _comparable_values(table: EncodedTable, attr: str) -> np.ndarray:
    """Values under SQL comparison semantics: numeric columns compare
    numerically (NaN for NULL), string columns lexicographically."""
    col = table.column(attr)
    if col.is_numeric:
        assert col.numeric is not None
        return col.numeric
    # Lexicographic: map each value to its rank in the sorted vocab.
    order = np.argsort(col.vocab.astype(str), kind="stable")
    rank = np.empty(len(col.vocab), dtype=np.float64)
    rank[order] = np.arange(len(col.vocab), dtype=np.float64)
    out = np.full(table.n_rows, np.nan)
    valid = col.codes != NULL_CODE
    out[valid] = rank[col.codes[valid]]
    return out


def _one_tuple_violations(table: EncodedTable, preds: Sequence[Predicate]) \
        -> np.ndarray:
    """Rows satisfying ALL constant predicates (the EXISTS collapses to a
    per-row filter for one-tuple constraints); host numpy, matched per
    vocabulary entry."""
    mask = np.ones(table.n_rows, dtype=bool)
    for p in preds:
        assert isinstance(p.left, AttrRef) and isinstance(p.right, Constant)
        col = table.column(p.left.name)
        value_strings = np.array(
            [str(v) for v in col.vocab], dtype=object)
        literal = p.right.literal
        vocab_match = value_strings == literal
        m = np.zeros(table.n_rows, dtype=bool)
        valid = col.codes != NULL_CODE
        m[valid] = vocab_match[col.codes[valid]]
        if p.sign == "EQ":
            mask &= m
        elif p.sign == "IQ":
            mask &= ~m  # null-safe: NULL <=> const is false, so NOT(...) true
        else:
            # LT/GT against constants: compare on string values like Spark
            # would after implicit casts; numeric columns compare numerically.
            if col.is_numeric:
                try:
                    lit_v = float(literal)
                except ValueError:
                    return np.zeros(table.n_rows, dtype=bool)
                assert col.numeric is not None
                with np.errstate(invalid="ignore"):
                    cmp = col.numeric < lit_v if p.sign == "LT" else col.numeric > lit_v
                cmp = np.where(np.isnan(col.numeric), False, cmp)
            else:
                # evaluate per DISTINCT value, broadcast through codes
                # (NULLs never satisfy an order comparison)
                vocab_cmp = np.array(
                    [(str(v) < literal) if p.sign == "LT" else (str(v) > literal)
                     for v in col.vocab], dtype=bool)
                cmp = np.zeros(table.n_rows, dtype=bool)
                valid = col.codes != NULL_CODE
                cmp[valid] = vocab_cmp[col.codes[valid]]
            mask &= cmp
    return mask


def _record_padded_extents(*sizes: int) -> None:
    """Records the launch planner's ``detect`` extent of each input array
    of a device step, as the JAX package does where it pads them (its jit
    compiles one program per padded length). Eager PyTorch gains nothing
    from padding, so the port's arrays stay unpadded."""
    for n in sizes:
        planner.padded_extent("detect", n, floor=8)


def _sorted_count(keys2: torch.Tensor, keys1: torch.Tensor) -> torch.Tensor:
    """#``keys2`` entries equal to each ``keys1`` entry (int64), as one sort
    and two searchsorted passes: O(n log n), no dense (group x value)
    table to size."""
    counter_inc("detect.sorted_count")
    _record_padded_extents(len(keys2), len(keys1))

    def count() -> torch.Tensor:
        s = torch.sort(keys2).values
        return torch.searchsorted(s, keys1, right=True) \
            - torch.searchsorted(s, keys1, right=False)

    return run_guarded("detect.sorted_count", count)


def _rank(keys: torch.Tensor) -> torch.Tensor:
    """Each key's rank in the sorted keys (equal keys share the rank of
    their first occurrence): comparable ids in [0, len)."""
    counter_inc("detect.rank")
    _record_padded_extents(len(keys))

    def rank() -> torch.Tensor:
        return torch.searchsorted(torch.sort(keys).values, keys,
                                  right=False)

    return run_guarded("detect.rank", rank)


def _fused_ranks(halves: Sequence[Tuple[np.ndarray, np.ndarray]],
                 inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fuses multi-column join keys into collision-free int64 rank keys on
    the device. ``halves`` lists (first[n], second[n]) host code-array pairs
    (NULL code -1 allowed); the two halves concatenate and fuse column by
    column, re-densifying after each column to the key's rank among the 2n
    keys. Ranks stay below 2n, so ``rank * stride + code`` stays far inside
    int64 however many columns fuse. ``inv``: a rank array of an earlier
    call to fuse on top of (the loop-invariant prefix of the
    inclusion-exclusion keys). Returns the [2n] ranks: first half, then
    second; equal groups share a rank, which is sparse, not dense."""
    for first, second in halves:
        both = np.concatenate([first, second]).astype(np.int64) + 1
        key = xfer.to_device(both)
        if inv is not None:
            stride = int(both.max(initial=-1)) + 2
            key = inv * stride + key
        inv = _rank(key)
    assert inv is not None
    return inv


def _group_extrema(values: torch.Tensor, groups: torch.Tensor,
                   n_groups: int, want_max: bool) -> torch.Tensor:
    """Per-group max/min of f64 ``values`` with NaN entries excluded (an
    empty group reads -inf for max, +inf for min); groups is int64[n] in
    [0, n_groups)."""
    counter_inc("detect.group_extrema")
    _record_padded_extents(len(values), len(groups))
    init = float("-inf") if want_max else float("inf")

    def extrema() -> torch.Tensor:
        safe = torch.where(torch.isnan(values),
                           torch.full_like(values, init), values)
        ext = torch.full((n_groups,), init, dtype=torch.float64,
                         device=values.device)
        return ext.scatter_reduce(0, groups, safe,
                                  reduce="amax" if want_max else "amin")

    return run_guarded("detect.group_extrema", extrema)


def _two_tuple_violations(table: EncodedTable, preds: Sequence[Predicate]) \
        -> np.ndarray:
    """Left-tuple rows r1 with some r2 satisfying the conjunction.

    EQ predicates form the join key; the remaining predicates are answered
    with per-group statistics on the device (one IQ or order residual, or
    any number of IQ residuals), falling back to in-group pairwise
    evaluation on the host for mixed residuals.
    """
    eq = [p for p in preds if p.sign == "EQ" and p.is_cross_tuple]
    rest = [p for p in preds if not (p.sign == "EQ" and p.is_cross_tuple)]
    n = table.n_rows

    # Join keys: left rows keyed by left-attr codes, right rows by right-attr
    # codes, in shared dictionaries (null-safe: NULL code is a key value).
    if len(eq) == 1:
        # Single EQ key (the common FD-style constraint): dictionary codes
        # are already dense group ids.
        p = eq[0]
        assert isinstance(p.left, AttrRef) and isinstance(p.right, AttrRef)
        c1, c2 = _shared_codes(table, p.left.name, p.right.name)
        if c2 is c1:
            g1 = g2 = xfer.device_codes(table.column(p.left.name)).long() + 1
        else:
            g1 = xfer.to_device(c1.astype(np.int64) + 1)  # NULL -> group 0
            g2 = xfer.to_device(c2.astype(np.int64) + 1)
        n_groups = int(max(c1.max(initial=-1), c2.max(initial=-1))) + 2 \
            if n else 0
    elif eq:
        # Composite join key: rank keys from iterated sort/searchsorted
        # passes over the 2n-key block (right half first).
        halves = []
        for p in eq:
            assert isinstance(p.left, AttrRef) and isinstance(p.right, AttrRef)
            c1, c2 = _shared_codes(table, p.left.name, p.right.name)
            halves.append((c2, c1))
        ranks = _fused_ranks(halves)
        g2, g1 = ranks[:n], ranks[n:]
        n_groups = 2 * n  # rank-key bound (keys are sparse, not dense)
    else:
        g1 = g2 = torch.zeros(n, dtype=torch.int64, device=get_device())
        n_groups = 1 if n else 0

    if not rest:
        # Violation iff the right-side group is non-empty (self matches).
        return (_sorted_count(g2, g1) > 0).cpu().numpy()

    if len(rest) == 1:
        p = rest[0]
        assert isinstance(p.left, AttrRef) and isinstance(p.right, AttrRef)
        if p.sign == "IQ":
            # r1 violates iff some group member carries a right-value
            # different from r1's left-value: #group - #matching > 0. NULL
            # takes part as an ordinary key value. The stride covers BOTH
            # columns' codes: a left-only shared-dictionary value with
            # a1 > a2.max() must not alias into the next group's keys.
            a1, a2 = _shared_codes(table, p.left.name, p.right.name)
            stride = int(max(a1.max(initial=-1), a2.max(initial=-1))) + 2
            f2 = g2 * stride + xfer.to_device(a2.astype(np.int64) + 1)
            f1 = g1 * stride + xfer.to_device(a1.astype(np.int64) + 1)
            return ((_sorted_count(g2, g1) - _sorted_count(f2, f1)) > 0) \
                .cpu().numpy()
        if p.sign in ("LT", "GT"):
            # r1 violates iff r1.left < max(group right) (LT) / > min (GT);
            # NULLs never satisfy an order comparison.
            v1 = xfer.to_device(_comparable_values(table, p.left.name)
                                .astype(np.float64))
            v2 = xfer.to_device(_comparable_values(table, p.right.name)
                                .astype(np.float64))
            bound = _group_extrema(v2, g2, n_groups,
                                   want_max=(p.sign == "LT"))[g1]
            cmp = v1 < bound if p.sign == "LT" else v1 > bound
            return (cmp & ~torch.isnan(v1) & ~torch.isinf(bound)) \
                .cpu().numpy()
        raise AssertionError(f"unexpected predicate sign: {p.sign}")

    if all(p.sign == "IQ" for p in rest):
        return _all_iq_violations(table, rest, g1, g2, n)
    return _blocked_pairwise_violations(
        table, rest, g1.cpu().numpy(), g2.cpu().numpy(), n, n_groups)


def _all_iq_violations(table: EncodedTable, rest: Sequence[Predicate],
                       g1: torch.Tensor, g2: torch.Tensor, n: int) \
        -> np.ndarray:
    """k IQ residuals by inclusion-exclusion, O(2^k * n) with k tiny.

    r1 violates iff some group member j has a_p2[j] != a_p1[r1] for EVERY
    predicate p. Counting the complement directly:

        |{j : all differ}| = sum over S subseteq preds of
                             (-1)^|S| * |{j : a_p2[j] == a_p1[r1] for p in S}|

    and each term is one equal-key count over a fused (group, S-attrs) rank
    key on the device. NULL codes take part as ordinary key values, which
    reproduces the pairwise null-safe semantics (NULL == NULL counts as a
    match, NULL != value as a mismatch)."""
    pairs = [_shared_codes(table, p.left.name, p.right.name)  # type: ignore[union-attr]
             for p in rest]
    k = len(pairs)
    total = torch.zeros(n, dtype=torch.int64, device=g1.device)
    # the base group key is loop-invariant: rank it once, then fuse each
    # subset's attribute columns on top of it
    base = _rank(torch.cat([g2, g1]))
    for s_bits in range(1 << k):
        # halves concat (first, second) = (right-tuple, left-tuple):
        # counts over the right side, evaluated at the left rows
        halves = [(pairs[b][1], pairs[b][0])
                  for b in range(k) if s_bits >> b & 1]
        inv = _fused_ranks(halves, base) if halves else base
        term = _sorted_count(inv[:n], inv[n:])
        if bin(s_bits).count("1") % 2:
            total -= term
        else:
            total += term
    return (total > 0).cpu().numpy()


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (the intra-segment rank array)."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    starts = ends - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def _blocked_pairwise_violations(table: EncodedTable, rest: Sequence[Predicate],
                                 g1: np.ndarray, g2: np.ndarray, n: int,
                                 n_groups: int,
                                 pair_budget: int = 1 << 23) -> np.ndarray:
    """Mixed residual conjunctions (IQ with LT/GT, multiple order preds):
    exact in-group pairwise evaluation on the host, generated and evaluated
    as flat vectorized blocks of (left_row, right_row) pairs — worst-case
    O(sum of group sizes squared) like the reference self-join, with
    bounded memory via `pair_budget`. Only group identity reaches the
    result: blocks walk left rows in row order, whatever the ids are."""
    # per-predicate arrays, one build total (shared codes for EQ/IQ,
    # comparison ranks for LT/GT)
    pred_arrays = []
    for p in rest:
        assert isinstance(p.left, AttrRef) and isinstance(p.right, AttrRef)
        if p.sign in ("EQ", "IQ"):
            lc, rc = _shared_codes(table, p.left.name, p.right.name)
            pred_arrays.append((p.sign, lc.astype(np.float64), rc.astype(np.float64)))
        else:
            lv = _comparable_values(table, p.left.name)
            rv = _comparable_values(table, p.right.name)
            pred_arrays.append((p.sign, lv, rv))

    # right-side rows sorted by group; per-group segment starts
    order2 = np.argsort(g2, kind="stable")
    grp_count = np.bincount(g2, minlength=n_groups) if n else \
        np.zeros(0, dtype=np.int64)
    grp_start = np.concatenate([[0], np.cumsum(grp_count)[:-1]]) \
        if n_groups else np.zeros(0, dtype=np.int64)

    out = np.zeros(n, dtype=bool)
    cnt_per_left = grp_count[g1] if n else np.zeros(0, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(cnt_per_left)])
    block_lo = 0
    while block_lo < n:
        # widest left-row block whose total pair count fits the budget
        target = cum[block_lo] + pair_budget
        block_hi = int(np.searchsorted(cum, target, side="right")) - 1
        block_hi = max(block_hi, block_lo + 1)
        rows = np.arange(block_lo, block_hi)
        counts = cnt_per_left[rows]
        if counts.sum() == 0:
            block_lo = block_hi
            continue
        pair_left = np.repeat(rows, counts)
        intra = _segment_arange(counts)
        pair_right = order2[grp_start[g1[pair_left]] + intra]
        ok = np.ones(len(pair_left), dtype=bool)
        with np.errstate(invalid="ignore"):
            for sign, lo_a, ro_a in pred_arrays:
                lv = lo_a[pair_left]
                rv = ro_a[pair_right]
                if sign == "EQ":
                    ok &= lv == rv
                elif sign == "IQ":
                    ok &= lv != rv
                elif sign == "LT":
                    ok &= lv < rv  # NaN comparisons are False, like the
                else:              # reference's NULL order semantics
                    ok &= lv > rv
        out[pair_left[ok]] = True
        block_lo = block_hi
    return out


def detect_constraint_violations(table: EncodedTable,
                                 constraints: DenialConstraints,
                                 target_attrs: Sequence[str]) -> List[CellIndex]:
    """For each constraint, flags every referenced target attribute of every
    violating left-tuple row."""
    counter_inc("detect.rows_scanned", table.n_rows)
    out: List[CellIndex] = []
    for preds in constraints.predicates:
        attrs = []
        for p in preds:
            for r in p.references:
                if r in target_attrs and r not in attrs:
                    attrs.append(r)
        if not attrs:
            continue
        if all(isinstance(p.right, Constant) for p in preds):
            mask = _one_tuple_violations(table, preds)
        else:
            mask = _two_tuple_violations(table, preds)
        rows = np.nonzero(mask)[0]
        if rows.size:
            led = active_ledger()
            if led is not None:
                # the ledger's detector label spells which constraint
                # flagged the cell, as the predicate conjunction
                label = "constraint[" \
                    + "&".join(f"{p.sign}({p.left},{p.right})"
                               for p in preds) + "]"
                rids = table.row_id_values[rows]
                for a in attrs:
                    led.record_detection(label, rows, a, rids)
            for a in attrs:
                out.append((rows, a))
    return out
