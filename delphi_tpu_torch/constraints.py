"""Denial-constraint parsing into a typed predicate IR.

Pure-Python replacement of the reference's regex-based parser
(`DenialConstraints.scala:66-225`), HoloClean syntax:

* two-tuple:  ``t1&t2&EQ(t1.a,t2.a)&IQ(t1.b,t2.b)``
* one-tuple:  ``t1&EQ(t1.Sex,"Female")&EQ(t1.Relationship,"Husband")``
* FD sugar:   ``X->Y`` (expands to EQ(X,X) & IQ(Y,Y))

A parsed constraint is a conjunction of :class:`Predicate` objects; the
violation scans in :mod:`delphi_tpu_torch.ops.detect` compile them to vectorized
group/compare operations instead of SQL self-joins.
"""

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

OP_SIGNS = ("EQ", "IQ", "LT", "GT")

_IDENT_RE = re.compile(r"^[a-zA-Z]+[a-zA-Z0-9]*$")


@dataclass(frozen=True)
class AttrRef:
    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Constant:
    value: str

    def __str__(self) -> str:
        return self.value

    @property
    def literal(self) -> str:
        """The constant with surrounding quotes stripped."""
        v = self.value
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
            return v[1:-1]
        return v


Expr = Union[AttrRef, Constant]


@dataclass(frozen=True)
class Predicate:
    """sign in {EQ, IQ, LT, GT}; left binds to tuple t1, right to t2
    (or to a constant for one-tuple constraints)."""

    sign: str
    left: Expr
    right: Expr

    @property
    def references(self) -> List[str]:
        refs = []
        for e in (self.left, self.right):
            if isinstance(e, AttrRef) and e.name not in refs:
                refs.append(e.name)
        return refs

    @property
    def is_cross_tuple(self) -> bool:
        return isinstance(self.left, AttrRef) and isinstance(self.right, AttrRef)


@dataclass
class DenialConstraints:
    predicates: List[List[Predicate]]  # one conjunction per constraint
    references: List[str]

    @property
    def is_empty(self) -> bool:
        return not self.predicates


EMPTY_CONSTRAINTS = DenialConstraints([], [])


def _parse_two_tuple(t1: str, t2: str, terms: List[str]) -> List[Predicate]:
    pattern = re.compile(
        rf"({'|'.join(OP_SIGNS)})\s*\(\s*{re.escape(t1)}\.(.*)\s*,\s*{re.escape(t2)}\.(.*)\s*\)")
    preds = []
    bad = []
    for term in terms:
        m = pattern.fullmatch(term)
        if m:
            preds.append(Predicate(m.group(1), AttrRef(m.group(2).strip()),
                                   AttrRef(m.group(3).strip())))
        else:
            bad.append(term)
    if bad:
        raise ValueError(f"Illegal predicates found: {', '.join(bad)}")
    return preds


def _parse_one_tuple(t1: str, terms: List[str]) -> List[Predicate]:
    pattern = re.compile(
        rf"({'|'.join(OP_SIGNS)})\s*\(\s*{re.escape(t1)}\.(.*)\s*,\s*(.*)\)")
    preds = []
    bad = []
    for term in terms:
        m = pattern.fullmatch(term)
        if m:
            preds.append(Predicate(m.group(1), AttrRef(m.group(2).strip()),
                                   Constant(m.group(3).strip())))
        else:
            bad.append(term)
    if bad:
        raise ValueError(f"Illegal predicates found: {', '.join(bad)}")
    return preds


def parse(stmt: str) -> List[Predicate]:
    """Parses the `t1&t2&PRED&...` / `t1&PRED&...` forms
    (DenialConstraints.scala:128-182)."""
    parts = [p.strip() for p in stmt.split("&")]
    if len(parts) >= 2 and _IDENT_RE.match(parts[0]) and _IDENT_RE.match(parts[1]):
        terms = parts[2:]
        if len(terms) < 2:
            raise ValueError(
                f"At least two predicate candidates should be given, "
                f"but {len(terms)} candidates found: {stmt}")
        return _parse_two_tuple(parts[0], parts[1], terms)
    if parts and _IDENT_RE.match(parts[0]):
        terms = parts[1:]
        if len(terms) < 2:
            raise ValueError(
                f"At least two predicate candidates should be given, "
                f"but {len(terms)} candidates found: {stmt}")
        return _parse_one_tuple(parts[0], terms)
    if any(parts):
        raise ValueError(f"Failed to parse an input string: '{stmt}'")
    return []


def parse_alt(stmt: str) -> List[Predicate]:
    """Parses the `X->Y` FD sugar (DenialConstraints.scala:185-195)."""
    parts = [p.strip() for p in stmt.split("->") if p.strip()]
    if len(parts) == 2:
        x, y = parts
        return [Predicate("EQ", AttrRef(x), AttrRef(x)),
                Predicate("IQ", AttrRef(y), AttrRef(y))]
    if parts:
        raise ValueError(f"Failed to parse an input string: '{stmt}'")
    return []


def load_constraint_stmts_from_file(path: Optional[str]) -> List[str]:
    if path and path.strip():
        try:
            with open(path) as f:
                return [line.rstrip("\n") for line in f]
        except OSError:
            _logger.warning(f"Failed to load constrains from '{path}'")
            return []
    return []


def load_constraint_stmts_from_string(s: Optional[str]) -> List[str]:
    if s:
        return [p.strip() for p in s.split(";") if p.strip()]
    return []


def parse_and_verify_constraints(stmts: Sequence[str], input_name: str,
                                 table_attrs: Sequence[str]) -> DenialConstraints:
    """Parses each statement (falling back to FD sugar), then drops
    constraints that reference non-existent attributes
    (DenialConstraints.scala:82-119)."""
    parsed: List[List[Predicate]] = []
    for stmt in stmts:
        try:
            try:
                preds = parse(stmt)
            except ValueError:
                preds = parse_alt(stmt)
            if preds:
                parsed.append(preds)
        except ValueError:
            _logger.warning(f"Illegal constraint format found: {stmt}")

    refs: List[str] = []
    for preds in parsed:
        for p in preds:
            for r in p.references:
                if r not in refs:
                    refs.append(r)

    attr_set = set(table_attrs)
    absent = [r for r in refs if r not in attr_set]
    if absent:
        _logger.warning(
            f"Non-existent constraint attributes found in '{input_name}': "
            f"{', '.join(absent)}")
        kept = [preds for preds in parsed
                if all(r in attr_set for p in preds for r in p.references)]
        if not kept:
            return EMPTY_CONSTRAINTS
        return DenialConstraints(kept, [r for r in refs if r in attr_set])

    return DenialConstraints(parsed, refs)
