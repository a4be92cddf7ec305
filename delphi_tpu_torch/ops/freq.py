"""Frequency statistics over encoded tables, on the device.

* singleton value counts per attribute: one ``torch.bincount`` over a
  column-offset fused key;
* pair co-occurrence count matrices per candidate attribute pair: the
  pairs of each launch of the launch planner's ``freq.pairs`` plan in ONE
  call of kernel K1 (:mod:`delphi_tpu_torch.ops.kernels.pair_counts`);
* the number of distinct (x, y) value pairs, for candidate-pair pruning:
  sort the fused key and count transitions.

NULL is a first-class value (slot 0), matching SQL GROUP BY semantics.
Each device step runs behind the resilience plane's guarded seam (sites
``freq.singles``, ``freq.pairs_pallas`` and ``freq.distinct``, as in the
JAX package; the JAX package enters ``freq.pairs_pallas`` once per pair,
the port once per K1 call).
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from delphi_tpu_torch.ops import xfer
from delphi_tpu_torch.ops.kernels import pair_counts as k_pair_counts
from delphi_tpu_torch.parallel import planner
from delphi_tpu_torch.parallel.resilience import run_guarded
from delphi_tpu_torch.table import EncodedTable

Pair = Tuple[str, str]

# The [pairs, rows] work budget of one pair-count launch (int32 elements);
# DELPHI_PAIR_BUDGET / repair.pair.budget tune it per deployment, as in
# the JAX package.
_PAIR_KEYS_PER_LAUNCH = 2.5e8


def _pair_keys_per_launch() -> float:
    """The pair budget: ``DELPHI_PAIR_BUDGET`` beats the
    ``repair.pair.budget`` session conf; both fall back to
    ``_PAIR_KEYS_PER_LAUNCH``."""
    env = os.environ.get("DELPHI_PAIR_BUDGET")
    if env:
        return float(env)
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.pair.budget")
    if conf:
        return float(conf)
    return float(_PAIR_KEYS_PER_LAUNCH)


@dataclass
class FreqStats:
    """Singleton and pairwise frequency stats for a discretized table.

    Count slot 0 is the NULL group. ``threshold_count`` reproduces the
    reference's `HAVING cnt > int(n_rows * attr_freq_ratio_threshold)`
    filter: filtered views zero out failing groups. The host dictionaries
    hold copies of the counts; ``pair_buffer`` (K1's flat int32 output,
    cut by ``pair_offsets`` in the order of ``pair_slots``) and
    ``single_buffer`` (``[attrs, single_stride]`` int32) stay on the device
    for the entropy kernel.
    """

    n_rows: int
    attrs: List[str]
    vocab_sizes: Dict[str, int]
    singles: Dict[str, np.ndarray]              # [V_a + 1] raw counts
    pairs: Dict[Pair, np.ndarray]               # [V_x + 1, V_y + 1] raw counts
    threshold_count: int = 0
    pair_buffer: torch.Tensor = None            # type: ignore[assignment]
    pair_offsets: np.ndarray = None             # type: ignore[assignment]
    pair_slots: Dict[Pair, int] = field(default_factory=dict)
    single_buffer: torch.Tensor = None          # type: ignore[assignment]
    single_slots: Dict[str, int] = field(default_factory=dict)

    def _filter(self, counts: np.ndarray) -> np.ndarray:
        if self.threshold_count <= 0:
            return counts
        return np.where(counts > self.threshold_count, counts, 0)

    def filter_device(self, counts: torch.Tensor) -> torch.Tensor:
        """``_filter`` on a device count buffer."""
        if self.threshold_count <= 0:
            return counts
        return torch.where(counts > self.threshold_count, counts,
                           torch.zeros_like(counts))

    def single(self, attr: str, filtered: bool = True) -> np.ndarray:
        c = self.singles[attr]
        return self._filter(c) if filtered else c

    def has_pair(self, x: str, y: str) -> bool:
        return (x, y) in self.pairs or (y, x) in self.pairs

    def pair(self, x: str, y: str, filtered: bool = True) -> np.ndarray:
        """Pair count matrix oriented [V_x+1, V_y+1] regardless of the
        stored orientation."""
        if (x, y) in self.pairs:
            m = self.pairs[(x, y)]
        else:
            m = self.pairs[(y, x)].T
        return self._filter(m) if filtered else m

    def distinct_pair_count(self, x: str, y: str) -> int:
        return int(np.count_nonzero(self.pair(x, y, filtered=False)))


def compute_freq_stats(table: EncodedTable,
                       target_attrs: Sequence[str],
                       pair_attrs: Sequence[Pair],
                       attr_freq_ratio_threshold: float = 0.0) -> FreqStats:
    """Singleton counts for ``target_attrs`` and pair count matrices for
    ``pair_attrs`` (unordered pairs deduplicated, first orientation kept)."""
    assert 0.0 <= attr_freq_ratio_threshold <= 1.0

    attrs = list(dict.fromkeys(target_attrs))
    seen = set()
    pairs: List[Pair] = []
    for x, y in pair_attrs:
        key = frozenset((x, y))
        if key not in seen:
            seen.add(key)
            pairs.append((x, y))

    vocab_sizes = {c.name: c.domain_size for c in table.columns}
    needed = list(dict.fromkeys(attrs + [a for p in pairs for a in p]))
    name_to_idx = {a: i for i, a in enumerate(needed)}
    if needed:
        codes = torch.stack([xfer.device_codes(table.column(a))
                             for a in needed])           # [m, n] int32
    else:
        codes = torch.zeros((0, table.n_rows), dtype=torch.int32,
                            device=xfer.get_device())

    # singles: one bincount over keys offset per column
    stride = max((vocab_sizes[a] for a in needed), default=0) + 1

    def singles_counts() -> torch.Tensor:
        col_base = torch.arange(len(needed), device=codes.device,
                                dtype=torch.int64)[:, None] * stride
        return torch.bincount((codes.long() + 1 + col_base).reshape(-1),
                              minlength=len(needed) * stride).to(torch.int32)

    single_buffer = run_guarded("freq.singles", singles_counts)
    singles_np = single_buffer.cpu().numpy().reshape(len(needed), stride)
    singles = {a: singles_np[name_to_idx[a], : vocab_sizes[a] + 1]
               for a in needed}

    pair_idx = [(name_to_idx[x], name_to_idx[y]) for x, y in pairs]
    vocab = [vocab_sizes[a] for a in needed]
    if pair_idx:
        # the pairs group by the launch planner's `freq.pairs` plan, whose
        # cap bounds the [pairs, rows] work of a launch by the pair budget
        # (one launch at the default budget up to 250 pairs of 1M rows);
        # each plan launch is one K1 call behind one guarded entry
        n_rows = int(table.n_rows)
        per_launch = max(1, int(_pair_keys_per_launch() // max(n_rows, 1)))
        v_pad = max(vocab)
        pair_plan = planner.plan_launches(
            "freq.pairs",
            [planner.Piece(key=i, size=1, shape=(v_pad, n_rows))
             for i in range(len(pair_idx))],
            batch_cap=per_launch, persist=False)
        pair_plan.record()
        flats, offsets = [], np.zeros(1, dtype=np.int64)
        for launch in pair_plan.launches:
            group = [pair_idx[span.key] for span in launch.spans]
            with pair_plan.launch_scope(launch):
                g_flat, g_off = run_guarded(
                    "freq.pairs_pallas",
                    lambda group=group: k_pair_counts.pair_counts(
                        codes, group, vocab))
            flats.append(g_flat)
            offsets = np.concatenate([offsets, offsets[-1] + g_off[1:]])
        flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    else:
        # no pair, no launch and no seam entry, as in the JAX package
        flat, offsets = k_pair_counts.pair_counts(codes, pair_idx, vocab)
    flat_np = flat.cpu().numpy()
    pair_mats: Dict[Pair, np.ndarray] = {}
    for p, (x, y) in enumerate(pairs):
        pair_mats[(x, y)] = flat_np[offsets[p]:offsets[p + 1]].reshape(
            vocab_sizes[x] + 1, vocab_sizes[y] + 1)

    return FreqStats(
        n_rows=table.n_rows,
        attrs=attrs,
        vocab_sizes=vocab_sizes,
        singles=singles,
        pairs=pair_mats,
        threshold_count=int(table.n_rows * attr_freq_ratio_threshold),
        pair_buffer=flat,
        pair_offsets=offsets,
        pair_slots={p: i for i, p in enumerate(pairs)},
        single_buffer=single_buffer.reshape(len(needed), stride),
        single_slots=name_to_idx,
    )


class PairDistinctCounter:
    """Exact #distinct (x, y) value pairs per attribute pair (NULLs
    included), used for candidate-pair pruning without materializing pair
    matrices: the fused key sorts on the device and the transitions are
    counted."""

    def __init__(self, table: EncodedTable) -> None:
        self._table = table
        self._cache: Dict[frozenset, int] = {}

    @property
    def n_rows(self) -> int:
        return self._table.n_rows

    def _count(self, x: str, y: str) -> int:
        if self._table.n_rows == 0:
            return 0
        cx = xfer.device_codes(self._table.column(x))
        cy = xfer.device_codes(self._table.column(y))
        stride = self._table.column(y).domain_size + 1

        def count() -> int:
            key = (cx.long() + 1) * stride + (cy.long() + 1)
            s = torch.sort(key).values
            return int(1 + (s[1:] != s[:-1]).sum().item())

        return run_guarded("freq.distinct", count)

    def distinct_pair_count(self, x: str, y: str) -> int:
        key = frozenset((x, y))
        if key not in self._cache:
            self._cache[key] = self._count(x, y)
        return self._cache[key]
