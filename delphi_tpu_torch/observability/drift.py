"""The population stability index, as the JAX package's drift module
computes it. The incremental planner and the streaming plane gate model
reuse and background retrains on it. The rest of the drift gate (the
cross-run scorecard comparison) is queue 1 item 10 of ``ROADMAP.md``.

Rule of thumb: a PSI under 0.1 is no meaningful change, 0.1 to 0.25 a
moderate shift, over 0.25 a different distribution.
"""

import math
from typing import List, Optional, Sequence

from delphi_tpu_torch.utils import counter_inc

_EPS = 1e-6


def _normalize(counts: Sequence[float]) -> Optional[List[float]]:
    """None when the vector carries no mass: empty, all zero, or holding
    NaN or inf (checked first, since ``NaN <= 0`` is False)."""
    total = float(sum(counts))
    if not math.isfinite(total) or total <= 0:
        return None
    return [c / total for c in counts]


def population_stability_index(current: Sequence[float],
                               baseline: Sequence[float]) -> float:
    """PSI over two aligned count vectors; empty bins are smoothed with a
    small epsilon so they do not blow up the log ratio. Two vectors without
    mass diverge by 0 (and count ``drift.bins_empty``)."""
    p = _normalize(current)
    q = _normalize(baseline)
    if p is None or q is None:
        counter_inc("drift.bins_empty")
        return 0.0
    psi = 0.0
    for pi, qi in zip(p, q):
        pi = max(pi, _EPS)
        qi = max(qi, _EPS)
        psi += (pi - qi) * math.log(pi / qi)
    return psi
