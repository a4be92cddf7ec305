"""Fault injection at the durable store's sites, and the fingerprint digest
the snapshot manifests share with the JAX package.

A fault plan (``DELPHI_FAULT_PLAN``, else the session conf
``repair.fault.plan``) is read as the JAX package reads it: comma-separated
``site:nth:kind`` triples (or rank-scoped ``rank:site:nth:kind``), ``site``
an ``fnmatch`` pattern over site names and ``nth`` the 1-based count of
entries into that site. Each entry fires once.

The port injects at the store's sites only (``store.*``,
:data:`delphi_tpu_torch.parallel.store.STORE_SITES`), with two kinds:

* ``torn_write``: the store truncates the destination at a deterministic
  offset and the writer believes it succeeded; the tear shows at the next
  validated read;
* ``crash``: the process exits with code 23 after the temporary file is
  written and before the rename lands.

Every other entry (another site, another kind, a rank scope) belongs to
the guarded-launch plane of queue 1 item 8 of ``ROADMAP.md``:
:func:`check_fault_plan` raises ``NotImplementedError`` for it before a
run does any work, so no entry of a plan is silently ignored.
"""

import fnmatch
import hashlib
import json
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

from delphi_tpu_torch.utils import counter_inc, setup_logger

_logger = setup_logger()

PLANES_ITEM = "queue 1 item 8 of ROADMAP.md, execution planes"

# the JAX package's fault taxonomy and injection kinds: a plan naming any
# other kind is malformed in both packages
FAULT_KINDS = ("init_timeout", "oom", "transfer", "compile", "transient",
               "rank_loss", "store_corrupt")
SPECIAL_INJECT_KINDS = frozenset({"stall", "rank_death", "crash"})
STORE_INJECT_KINDS = frozenset({"torn_write"})
_PLAN_KINDS = frozenset(FAULT_KINDS) | {"fatal"} | SPECIAL_INJECT_KINDS \
    | STORE_INJECT_KINDS

#: the kinds the port injects, at ``store.*`` sites only
LIVE_KINDS = frozenset({"torn_write", "crash"})

_PLAN_RE = re.compile(r"^\s*([^:\s]+)\s*:\s*(\d+)\s*:\s*([a-z_]+)\s*$")
_PLAN_RANK_RE = re.compile(r"^\s*([^:\s]+)\s*:\s*([^:\s]+)\s*:"
                           r"\s*(\d+)\s*:\s*([a-z_]+)\s*$")

_INJECT_MESSAGES = {
    "torn_write": ("durable store write torn mid-flight "
                   "(injected at {site} call {n})"),
}


class FaultInjected(BaseException):
    """An injected fault. BaseException, as in the JAX package: no
    ``except Exception`` fallback may absorb it."""

    def __init__(self, kind: str, site: str, n: int) -> None:
        self.kind = kind
        super().__init__(_INJECT_MESSAGES.get(
            kind, "injected " + kind + " fault at {site} call {n}")
            .format(site=site, n=n))


def fingerprint_digest(fingerprint: Dict[str, Any]) -> str:
    """Stable hex digest of a fingerprint dict: canonical JSON (sorted keys,
    non-JSON leaves stringified) through sha1, equal to the JAX package's
    for equal dicts."""
    canonical = json.dumps(fingerprint, sort_keys=True, default=str)
    return hashlib.sha1(canonical.encode("utf-8", "replace")).hexdigest()


def parse_fault_plan(text: str) -> Tuple[Tuple[Any, ...], ...]:
    """The JAX package's grammar: ``(site, nth, kind)`` per triple, with the
    rank pattern as a fourth element for ``rank:site:nth:kind``. Raises
    ``ValueError`` on a malformed entry or an unknown kind."""
    entries = []
    for part in text.split(","):
        if not part.strip():
            continue
        m = _PLAN_RE.match(part)
        rank_pat = None
        if m is None:
            m4 = _PLAN_RANK_RE.match(part)
            if not m4:
                raise ValueError(
                    f"DELPHI_FAULT_PLAN: bad triple {part!r} "
                    "(expected site:nth:kind or rank:site:nth:kind)")
            rank_pat, pat, nth, kind = (m4.group(1), m4.group(2),
                                        int(m4.group(3)), m4.group(4))
        else:
            pat, nth, kind = m.group(1), int(m.group(2)), m.group(3)
        if kind not in _PLAN_KINDS:
            raise ValueError(
                f"DELPHI_FAULT_PLAN: unknown fault kind {kind!r} "
                f"(one of {', '.join(FAULT_KINDS)}, fatal, "
                f"{', '.join(sorted(SPECIAL_INJECT_KINDS))})")
        if nth < 1:
            raise ValueError("DELPHI_FAULT_PLAN: nth is 1-based")
        entries.append((pat, nth, kind) if rank_pat is None
                       else (pat, nth, kind, rank_pat))
    return tuple(entries)


def _fault_plan_text() -> Tuple[str, str]:
    """(plan text, where it was read): the environment first, then the
    session conf."""
    env = os.environ.get("DELPHI_FAULT_PLAN")
    if env is not None:
        return env, "DELPHI_FAULT_PLAN"
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.fault.plan")
    return (str(conf) if conf else ""), "the session conf repair.fault.plan"


def _live(entry: Tuple[Any, ...]) -> bool:
    return len(entry) == 3 and entry[0].startswith("store.") \
        and entry[2] in LIVE_KINDS


def check_fault_plan() -> None:
    """Raises ``NotImplementedError`` naming queue 1 item 8 for the first
    entry of the active plan that the port does not inject (any site
    outside ``store.*``, any kind but ``torn_write`` and ``crash``, any
    rank scope), and ``ValueError`` for a malformed plan. An entry whose
    pattern matches no store site can never fire: each check logs and
    counts it (``resilience.plan.unmatched``), where the JAX package warns
    once per plan. An empty or unset plan passes."""
    from delphi_tpu_torch.parallel.store import STORE_SITES
    text, source = _fault_plan_text()
    for entry in parse_fault_plan(text):
        spelled = ":".join(str(f) for f in (entry[3:] + entry[:3]))
        if not _live(entry):
            raise NotImplementedError(
                f"fault plan entry {spelled!r} ({source}) is not ported to "
                "delphi_tpu_torch yet: the port injects torn_write and "
                f"crash at store.* sites only ({PLANES_ITEM})")
        if not any(fnmatch.fnmatchcase(site, entry[0])
                   for site in STORE_SITES):
            counter_inc("resilience.plan.unmatched")
            _logger.warning(
                f"{source}: fault plan entry {spelled!r} matches no store "
                f"site and will never fire (sites: "
                f"{', '.join(sorted(STORE_SITES))})")


def _entry_hit(entry: Tuple[Any, ...], site: str, n: int) -> Optional[str]:
    """The kind to fire when plan ``entry`` matches this (site, entry
    count), else None. Rank-scoped entries never fire here: the run
    refused them before it started."""
    pat, nth, kind = entry[0], entry[1], entry[2]
    if len(entry) > 3 or nth != n or not fnmatch.fnmatchcase(site, pat):
        return None
    return kind


_plan_lock = threading.Lock()
_plan_state: Dict[str, Any] = {"text": None, "entries": (), "fired": set(),
                               "calls": {}}


def reset_fault_state() -> None:
    """Forgets fired entries and per-site entry counts (tests that replay a
    plan in one process)."""
    with _plan_lock:
        _plan_state.update(text=None, entries=(), fired=set(), calls={})


def _maybe_inject(site: str) -> None:
    """The injection point of one store site: counts the entry and fires
    the first unfired plan entry that matches it. ``crash`` exits the
    process with code 23; every other kind raises :class:`FaultInjected`
    (the store catches ``torn_write`` itself)."""
    text, _ = _fault_plan_text()
    with _plan_lock:
        if text != _plan_state["text"]:
            _plan_state.update(text=text,
                               entries=parse_fault_plan(text) if text else (),
                               fired=set(), calls={})
        entries = _plan_state["entries"]
        if not entries:
            return
        n = _plan_state["calls"].get(site, 0) + 1
        _plan_state["calls"][site] = n
        hit = None
        for i, entry in enumerate(entries):
            if i in _plan_state["fired"]:
                continue
            kind = _entry_hit(entry, site, n)
            if kind is not None:
                _plan_state["fired"].add(i)
                hit = kind
                break
    if hit is None:
        return
    counter_inc("resilience.injected")
    _logger.warning(f"fault plan: injecting {hit} at {site} (call {n})")
    if hit == "crash":
        # mid-write process death: the temporary file is on disk, the
        # rename has not landed
        os._exit(23)
    raise FaultInjected(hit, site, n)
