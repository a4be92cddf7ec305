"""Regex-structure repair: salvage dirty strings using a restricted regex.

The pattern is lexed into (Pattern | Constant | Other) tokens with
maximal-munch semantics, then a salvage regex is built where pattern tokens
become capture groups and constant tokens are relaxed to `.{1,len}`; on a
match, the canonical string is rebuilt from the captured pattern groups
plus the literal constants.

Example: pattern "^[0-9]{1,3} patients$" repairs "32 patixxts" to
"32 patients".
"""

import re
from enum import Enum
from typing import List, Optional, Tuple


class RegexTokenType(Enum):
    PATTERN = "pattern"
    CONSTANT = "constant"
    OTHER = "other"


# Token classes from RegexBase.g4 (restricted regex grammar)
_RANGE_RE = re.compile(
    r"(?:\[(?:[A-Za-z0-9]|[A-Za-z0-9]-[A-Za-z0-9])+\]|[A-Za-z0-9])"
    r"\{(?:\d+|,\d+|\d+,|\d+,\d+)\}")
_PATTERN_RE = re.compile(r"\[(?:[A-Za-z0-9]|[A-Za-z0-9]-[A-Za-z0-9])+\]")
_CONSTANT_RE = re.compile(r"[A-Za-z0-9 _%-]+")
_SINGLE_TOKENS = {"*", "+", "?", "|", ".", "^", "$"}


def tokenize(pattern: str) -> List[Tuple[RegexTokenType, str]]:
    """Lexes the restricted grammar; raises ValueError on unsupported syntax."""
    tokens: List[Tuple[RegexTokenType, str]] = []
    i = 0
    n = len(pattern)
    while i < n:
        candidates: List[Tuple[int, RegexTokenType, str]] = []
        m = _RANGE_RE.match(pattern, i)
        if m:
            candidates.append((len(m.group(0)), RegexTokenType.PATTERN, m.group(0)))
        m = _PATTERN_RE.match(pattern, i)
        if m:
            # a bare character class with no quantifier: lexes as PATTERN but
            # the reference's visitor drops it (RegexStructureRepair.scala:46-57)
            candidates.append((len(m.group(0)), RegexTokenType.OTHER, m.group(0)))
        m = _CONSTANT_RE.match(pattern, i)
        if m:
            candidates.append((len(m.group(0)), RegexTokenType.CONSTANT, m.group(0)))
        if pattern[i] in _SINGLE_TOKENS:
            candidates.append((1, RegexTokenType.OTHER, pattern[i]))
        if not candidates:
            raise ValueError(f"token recognition error at: '{pattern[i]}'")
        length, tpe, text = max(candidates, key=lambda c: c[0])
        tokens.append((tpe, text))
        i += length
    return tokens


def parse(pattern: str) -> List[Tuple[RegexTokenType, str]]:
    """Token stream as the reference visitor produces it: quantified character
    classes -> Pattern, literal runs -> Constant, anchors -> Other; everything
    else contributes nothing."""
    out: List[Tuple[RegexTokenType, str]] = []
    tokens = tokenize(pattern)
    for idx, (tpe, text) in enumerate(tokens):
        if tpe == RegexTokenType.PATTERN or tpe == RegexTokenType.CONSTANT:
            out.append((tpe, text))
        elif text == "^" and idx == 0:
            out.append((RegexTokenType.OTHER, text))
        elif text == "$" and idx == len(tokens) - 1:
            out.append((RegexTokenType.OTHER, text))
        # other operators (* + ? | .) and bare classes carry no structure
    return out


class RegexStructureRepair:
    """Callable: dirty string -> Optional[repaired string]."""

    def __init__(self, pattern: str) -> None:
        self.pattern = pattern
        token_seq = parse(pattern)
        self._tokens = token_seq
        self.num_patterns = sum(1 for t, _ in token_seq if t == RegexTokenType.PATTERN)
        parts = []
        for tpe, text in token_seq:
            if tpe == RegexTokenType.PATTERN:
                parts.append(f"({text})")
            elif tpe == RegexTokenType.CONSTANT:
                parts.append(f".{{1,{len(text)}}}")
            else:
                parts.append(text)
        self._salvage = re.compile("".join(parts))

    def __call__(self, s: Optional[str]) -> Optional[str]:
        if s is None:
            return None
        m = self._salvage.search(s)
        if not m:
            return None
        assert len(m.groups()) == self.num_patterns, \
            f"Illegal pattern found: {self.pattern}"
        out = []
        g = 0
        for tpe, text in self._tokens:
            if tpe == RegexTokenType.PATTERN:
                g += 1
                out.append(m.group(g))
            elif tpe == RegexTokenType.CONSTANT:
                out.append(text)
        return "".join(out)
