"""Constraint dependency expansion for the delta planner.

A denial constraint couples rows: re-examining only the changed rows would
miss violations a changed row introduces (or resolves) against unchanged
partners. For every two-tuple constraint, rows sharing the constraint's
full cross-tuple EQ key form an equivalence class — two rows can only
violate the constraint together when every cross-tuple EQ predicate holds,
i.e. when they agree on ALL key attributes (the same grouping the
violation kernel in :mod:`delphi_tpu_torch.ops.detect` exploits). So the dirty
neighborhood of a changed row is exactly its EQ-key group, per constraint:
any group containing a dirty row is pulled into the plan wholesale, and
groups with no dirty member keep their prior decisions.

Rows carrying a NULL in a key attribute never satisfy the EQ predicates,
so they pair with nobody and are not pulled in through that constraint.
Constraints with no usable EQ key (no cross-tuple EQ predicate, or an
asymmetric ``EQ(t1.a, t2.b)``) couple arbitrary row pairs; they expand to
every row — the conservative answer that keeps the plan correct.
"""

from typing import List, Sequence

import numpy as np

from delphi_tpu_torch.constraints import Predicate
from delphi_tpu_torch.table import EncodedTable

__all__ = ["expand_dirty_rows", "constraint_eq_keys"]


def constraint_eq_keys(preds: Sequence[Predicate]) -> List[str]:
    """The cross-tuple EQ key attributes of one constraint, or an empty
    list when the constraint has no row-grouping key (one-tuple, no
    cross-tuple EQ, or asymmetric EQ)."""
    if all(not p.is_cross_tuple for p in preds):
        return []  # one-tuple: row-local, expansion not needed
    keys: List[str] = []
    for p in preds:
        if not p.is_cross_tuple or p.sign != "EQ":
            continue
        if str(p.left) != str(p.right):
            return []  # asymmetric EQ: not an equivalence relation
        if str(p.left) not in keys:
            keys.append(str(p.left))
    return keys


def expand_dirty_rows(table: EncodedTable,
                      constraints: Sequence[Sequence[Predicate]],
                      dirty_rows: np.ndarray) -> np.ndarray:
    """Expands a dirty row-position set through the constraint graph.

    Returns the sorted union of ``dirty_rows`` and every row sharing a full
    cross-tuple EQ key with a dirty row under any constraint. The expansion
    is one pass (groups are equivalence classes per constraint, so pulled
    rows cannot pull further rows through the SAME constraint; a pulled row
    is itself re-examined, not re-written, so cross-constraint chaining is
    not needed for plan correctness)."""
    dirty_rows = np.asarray(dirty_rows, dtype=np.int64)
    if not len(dirty_rows) or not constraints:
        return np.unique(dirty_rows)
    n = table.n_rows
    planned = np.zeros(n, dtype=bool)
    planned[dirty_rows] = True

    for preds in constraints:
        two_tuple = any(p.is_cross_tuple for p in preds)
        if not two_tuple:
            continue
        keys = constraint_eq_keys(preds)
        if not keys:
            # no usable grouping key: the constraint couples arbitrary row
            # pairs, so any dirty row taints every row
            planned[:] = True
            break
        keys = [k for k in keys if table.has_column(k)]
        if not keys:
            continue
        key_codes = table.codes(keys)
        groupable = (key_codes >= 0).all(axis=1)
        if not groupable.any():
            continue
        _, inverse = np.unique(key_codes[groupable], axis=0,
                               return_inverse=True)
        group_of = np.full(n, -1, dtype=np.int64)
        group_of[np.nonzero(groupable)[0]] = inverse
        dirty_groups = np.unique(group_of[planned & groupable])
        if len(dirty_groups):
            planned |= groupable & np.isin(group_of, dirty_groups)

    return np.nonzero(planned)[0].astype(np.int64)
