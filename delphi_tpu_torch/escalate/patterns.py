"""Tier A: learned pattern repair.

Generalizes :class:`delphi_tpu_torch.regex_repair.RegexStructureRepair` from a
user-supplied pattern to INDUCED ones: each attribute's high-confidence
clean values (the cells the masking pass did NOT null) are tokenized into
runs of digits, runs of letters, and separator literals; when one run
structure covers a supermajority of the clean values, it becomes a pattern
string in the restricted grammar that ``regex_repair`` already lexes —

* a run whose literal text varies across values -> a PATTERN token
  (``[0-9]{m,n}`` / ``[A-Za-z]{m,n}`` with the observed length range),
* a run whose literal text is identical across values -> a CONSTANT token
  (the salvage relaxes it to ``.{1,len}`` and rebuilds it verbatim, which
  is exactly what repairs a corrupted separator or unit suffix),

anchored ``^...$``. The induced repairer is then applied to the routed
cells whose current value breaks the structure; values already matching
are left for the joint tier (their problem is semantic, not syntactic).

Induction is pure host-side string work over at most a few thousand clean
spellings per attribute — the expensive escalation math lives in tier B.
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple

from delphi_tpu_torch.regex_repair import RegexStructureRepair

#: fraction of clean values that must share one run structure
MIN_SUPPORT = 0.9
#: minimum clean values before induction is even attempted
MIN_CLEAN = 4
#: clean spellings sampled per attribute (deterministic head — the encoded
#: column's first-appearance order, not a random draw)
MAX_CLEAN = 4096

_DIGITS = frozenset("0123456789")
_LETTERS = frozenset("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
#: non-alphanumeric chars the restricted CONSTANT grammar can express
_SEPARATORS = frozenset(" _%-")


def _runs(value: str) -> Optional[List[Tuple[str, str]]]:
    """Maximal same-class runs of ``value`` as ``(class, text)`` with class
    ``D`` (digits), ``L`` (letters) or ``S`` (separators); ``None`` when the
    value contains a char the restricted grammar cannot express."""
    out: List[Tuple[str, str]] = []
    i, n = 0, len(value)
    while i < n:
        ch = value[i]
        if ch in _DIGITS:
            cls, charset = "D", _DIGITS
        elif ch in _LETTERS:
            cls, charset = "L", _LETTERS
        elif ch in _SEPARATORS:
            cls, charset = "S", _SEPARATORS
        else:
            return None
        j = i + 1
        while j < n and value[j] in charset:
            j += 1
        out.append((cls, value[i:j]))
        i = j
    return out


def induce_pattern(clean_values: Sequence[str]) -> Optional[str]:
    """One restricted-grammar pattern string covering the majority run
    structure of ``clean_values``, or ``None`` when no structure reaches
    :data:`MIN_SUPPORT` (free-text attributes must never induce — a pattern
    that "repairs" prose would be a corruption engine)."""
    vals = [v for v in clean_values[:MAX_CLEAN] if v]
    if len(vals) < MIN_CLEAN:
        return None
    groups: Dict[Tuple[str, ...], List[List[Tuple[str, str]]]] = {}
    total = 0
    for v in vals:
        runs = _runs(v)
        if runs is None:
            continue
        total += 1
        # separators key by literal (the grammar cannot express a varying
        # separator); digit/letter runs key by class only
        key = tuple(c if c != "S" else f"S:{t}" for c, t in runs)
        groups.setdefault(key, []).append(runs)
    if total < MIN_CLEAN:
        return None
    key, members = max(groups.items(), key=lambda kv: (len(kv[1]), kv[0]))
    if len(members) / total < MIN_SUPPORT:
        return None
    n_runs = len(members[0])
    parts: List[str] = []
    has_pattern = has_constant = False
    for slot in range(n_runs):
        cls = members[0][slot][0]
        texts = {m[slot][1] for m in members}
        if cls == "S" or len(texts) == 1:
            parts.append(next(iter(texts)))
            has_constant = True
        else:
            lens = [len(m[slot][1]) for m in members]
            char_class = "[0-9]" if cls == "D" else "[A-Za-z]"
            parts.append(f"{char_class}{{{min(lens)},{max(lens)}}}")
            has_pattern = True
    # a constants-only pattern can only reproduce one literal string, and a
    # patterns-only one has no structure to salvage around — neither repairs
    if not (has_pattern and has_constant):
        return None
    return "^" + "".join(parts) + "$"


class InducedPatternRepair:
    """An induced pattern plus its strict form: ``repair`` returns a value
    only for cells that BREAK the structure and whose salvage lands back
    inside it."""

    def __init__(self, pattern: str) -> None:
        self.pattern = pattern
        self._salvage = RegexStructureRepair(pattern)
        self._strict = re.compile(pattern)

    def matches(self, value: Optional[str]) -> bool:
        return value is not None and self._strict.fullmatch(value) is not None

    def repair(self, value: Optional[str]) -> Optional[str]:
        if value is None or self.matches(value):
            return None
        out = self._salvage(value)
        if out is None or out == value or not self.matches(out):
            return None
        return out


def induce_for_attributes(clean_values: Dict[str, Sequence[str]]) \
        -> Dict[str, InducedPatternRepair]:
    """Per-attribute induced repairers (attributes with no stable structure
    simply don't appear)."""
    out: Dict[str, InducedPatternRepair] = {}
    for attr in sorted(clean_values):
        pattern = induce_pattern(list(clean_values[attr]))
        if pattern is None:
            continue
        try:
            out[attr] = InducedPatternRepair(pattern)
        except Exception:
            continue  # induced string outside the grammar: skip, never raise
    return out
