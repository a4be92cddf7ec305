"""Tier C: the external repair-adapter interface. HARD OFF BY DEFAULT.

An adapter is an arbitrary external repairer (an LLM endpoint, a human
review queue, a vendor API) behind a two-line contract: ``repair(batch)``
takes a list of request dicts and returns one proposed value (or ``None``)
per request. Because the adapter is the one tier whose behavior this repo
cannot vouch for, it is fenced three ways:

* **allow flag** — :func:`resolve_adapter` is the ONLY construction path
  (a static guard test enforces this), and its first act is the
  :func:`adapter_allowed` check: unless ``DELPHI_ESCALATE_ADAPTER`` (or the
  per-request ``repair.escalate.adapter`` option) is explicitly set to a
  non-false value, it returns ``None`` and no adapter code runs at all;
* **call budget** — ``DELPHI_ESCALATE_ADAPTER_CALLS`` caps ``repair``
  invocations per run (a proxy for tokens/dollars), on top of the router's
  per-cell budget;
* **provenance** — every adapter decision lands in the ledger under its
  own reason, so an audit can always separate adapter output from the
  statistical pipeline's.

The built-in ``mock`` adapter is deterministic (mode imputation over the
clean values the orchestrator hands it) so tests and the bench A/B can
exercise the full tier-C path without any external dependency.
"""

import importlib
import os
from typing import Any, Dict, List, Optional

from delphi_tpu_torch.utils import setup_logger

_logger = setup_logger()

_FALSY = frozenset({"", "0", "false", "no", "off"})

#: adapter ``repair()`` invocations allowed per run (env override below)
DEFAULT_ADAPTER_CALLS = 8


class RepairAdapter:
    """External-repairer contract. ``batch`` items carry ``row_id``,
    ``attribute``, ``current_value``, ``row`` (the cell's decoded row as an
    attribute->value dict) and ``candidates`` (clean ``(value, count)``
    pairs sorted most-frequent-first, value ascending on ties). Return one
    proposed spelling or ``None`` per item, same order."""

    name = "adapter"

    def repair(self, batch: List[Dict[str, Any]]) -> List[Optional[str]]:
        raise NotImplementedError


class MockAdapter(RepairAdapter):
    """Deterministic stand-in: proposes each cell's most frequent clean
    value (lexicographically smallest on ties) when it differs from the
    current value."""

    name = "mock"

    def repair(self, batch: List[Dict[str, Any]]) -> List[Optional[str]]:
        out: List[Optional[str]] = []
        for req in batch:
            cands = req.get("candidates") or []
            top = str(cands[0][0]) if cands else None
            out.append(top if top is not None
                       and top != req.get("current_value") else None)
        return out


def adapter_spec(model: Any = None) -> str:
    """The raw adapter setting, same precedence as every other escalation
    knob: per-model option first (serve sets it per request), then env,
    then session conf."""
    if model is not None and model._opt_escalate_adapter.key in model.opts:
        return str(model._get_option_value(*model._opt_escalate_adapter))
    env = os.environ.get("DELPHI_ESCALATE_ADAPTER")
    if env is not None:
        return env
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.escalate.adapter")
    return str(conf) if conf is not None else ""


def adapter_allowed(model: Any = None) -> bool:
    """True only when the operator EXPLICITLY enabled the adapter tier.
    Absent, empty, or any false spelling -> off; there is no default-on
    path anywhere."""
    return adapter_spec(model).strip().lower() not in _FALSY


def adapter_call_limit() -> int:
    try:
        return max(0, int(os.environ.get(
            "DELPHI_ESCALATE_ADAPTER_CALLS", str(DEFAULT_ADAPTER_CALLS))))
    except ValueError:
        return DEFAULT_ADAPTER_CALLS


def resolve_adapter(model: Any = None) -> Optional[RepairAdapter]:
    """The single gatekeeper: ``None`` unless :func:`adapter_allowed`.
    ``mock`` (or a bare truthy flag) resolves to :class:`MockAdapter`;
    ``module:Class`` imports an external implementation — a bad spec
    disables the tier with a warning rather than failing the run."""
    if not adapter_allowed(model):
        return None
    spec = adapter_spec(model).strip()
    if spec.lower() in {"mock", "1", "true", "yes", "on"}:
        return MockAdapter()
    if ":" in spec:
        mod_name, _, cls_name = spec.partition(":")
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name)
            adapter = cls()
            if not callable(getattr(adapter, "repair", None)):
                raise TypeError(f"{spec} has no repair() method")
            return adapter
        except Exception as e:
            _logger.warning(
                f"escalation adapter '{spec}' failed to load ({e}); "
                f"tier C disabled for this run")
            return None
    _logger.warning(f"unrecognized escalation adapter spec '{spec}'; "
                    f"tier C disabled for this run")
    return None
