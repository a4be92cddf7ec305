"""The unified launch planner: one dispatch policy for every device phase.

The port of the JAX package's ``parallel/planner.py``. Callers hand
:func:`plan_launches` a list of :class:`Piece` work items and get back a
deterministic :class:`LaunchPlan`:

* pieces are split into spans of at most ``chunk`` units,
* each span pads to the next power of two (``size_floor``-bounded),
* same-shape spans group into buckets; a bucket splits into launches of at
  most ``batch_cap`` spans, optionally pow2-padding the batch axis,
* per-launch pad waste is counted (the ``launch.*`` counters and gauges in
  :mod:`delphi_tpu_torch.utils`).

Plans are pure data, and for the same pieces and policy their signatures
and payloads equal the JAX package's, so a plan store written by either
package loads in the other. When a plan store is armed
(``DELPHI_PLAN_DIR``, or :func:`set_plan_store`) plans persist per table
fingerprint through the durable store (site ``store.plan``, schema
``launch_plan``): a warm run with an unchanged piece set loads the stored
grouping instead of replanning.

``DELPHI_PLAN=0`` pins the planner to the legacy grouping (no bucket
merging, no persistence). With planning on, the only further transform is
a bounded same-shape bucket merge that is inert for numerics (padding rows
and slots are masked or sliced off at every call site).

Differences from the JAX package: :meth:`LaunchPlan.launch_scope` is a
null context (the launch-cost ledger it feeds comes with queue 1 item 10
of ``ROADMAP.md``), so the cost veto behind ``DELPHI_PLAN_COST`` raises
``NotImplementedError``; and no plan carries a shard tag (the row-shard
plane is item 9).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from delphi_tpu_torch.utils import counter_inc, gauge_set

# ---------------------------------------------------------------------------
# pow2 helpers: the one place launch padding math lives
# ---------------------------------------------------------------------------


def pow2_pad(n: int, floor: int = 1) -> int:
    """Next power of two >= max(n, 1), raised to ``floor``."""
    return max(int(floor), 1 << max(int(n) - 1, 0).bit_length())


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (int(n).bit_length() - 1)


def round_chunks(n_rounds: int, chunk: int) -> List[int]:
    """Split ``n_rounds`` boosting rounds into fixed-size chunks plus one
    remainder — the GBDT boost-chunk policy (two compiled variants max)."""
    q, r = divmod(max(int(n_rounds), 1), int(chunk))
    return [int(chunk)] * q + ([r] if r else [])


# ---------------------------------------------------------------------------
# planner knobs: DELPHI_PLAN_* spellings, with one-time deprecation warnings
# for the legacy per-phase spellings they absorb.
# ---------------------------------------------------------------------------

_DEPRECATED_WARNED: set = set()


def _deprecated_env(legacy: str, replacement: str) -> Optional[str]:
    val = os.environ.get(legacy)
    if val is not None and legacy not in _DEPRECATED_WARNED:
        _DEPRECATED_WARNED.add(legacy)
        warnings.warn(
            f"{legacy} is deprecated; use {replacement} (the unified "
            f"launch-planner knob) instead", DeprecationWarning, stacklevel=3)
    return val


def planning_enabled() -> bool:
    """DELPHI_PLAN=0 pins the planner to the legacy grouping (A/B control):
    no bucket merging, no plan persistence."""
    return os.environ.get("DELPHI_PLAN", "1").lower() not in (
        "0", "false", "no", "off")


def plan_cost_enabled() -> bool:
    """``DELPHI_PLAN_COST`` as the JAX package reads it (1/true/yes/on)."""
    return os.environ.get("DELPHI_PLAN_COST", "").strip().lower() in (
        "1", "true", "yes", "on")


def merge_factor() -> int:
    """Max padded-size ratio a same-shape bucket merge may bridge
    (DELPHI_PLAN_MERGE; 0 disables merging; default 8)."""
    try:
        return int(os.environ.get("DELPHI_PLAN_MERGE", "8"))
    except ValueError:
        return 8


def chunk_cells(default: int = 1_000_000) -> int:
    """Cell budget per launch for chunked phases (domain scoring).
    ``DELPHI_PLAN_CHUNK_CELLS`` wins; the legacy per-phase spelling
    ``DELPHI_DOMAIN_CHUNK_CELLS`` is honored with a deprecation warning."""
    val = os.environ.get("DELPHI_PLAN_CHUNK_CELLS")
    if val is None:
        val = _deprecated_env("DELPHI_DOMAIN_CHUNK_CELLS",
                              "DELPHI_PLAN_CHUNK_CELLS")
    try:
        return max(1, int(val)) if val is not None else int(default)
    except ValueError:
        return int(default)


def cv_instance_cap(default: int = 16) -> int:
    """Max CV instances fused per gbdt.cv_chunk launch.
    ``DELPHI_PLAN_CV_INSTANCE_CAP`` wins; the legacy spelling
    ``DELPHI_CV_INSTANCE_CAP`` is honored with a deprecation warning."""
    val = os.environ.get("DELPHI_PLAN_CV_INSTANCE_CAP")
    if val is None:
        val = _deprecated_env("DELPHI_CV_INSTANCE_CAP",
                              "DELPHI_PLAN_CV_INSTANCE_CAP")
    try:
        return max(1, int(val)) if val is not None else int(default)
    except ValueError:
        return int(default)


# ---------------------------------------------------------------------------
# plan data model
# ---------------------------------------------------------------------------

Key = Union[int, str]
Shape = Tuple[Any, ...]


@dataclass(frozen=True)
class Piece:
    """One unit of work offered to the planner.

    ``key`` must be JSON-stable (int or str) — it is how a persisted plan
    reattaches to live work. ``size`` is the extent along the padded axis
    (rows, cells…). ``shape`` is everything else that determines the
    compiled variant (mode, vocab pads, depth…): spans only share a launch
    when their shapes are equal.
    """

    key: Key
    size: int
    shape: Shape = ()


@dataclass(frozen=True)
class Span:
    """A contiguous slice [lo, lo+size) of one piece, assigned to a launch."""

    key: Key
    lo: int
    size: int


@dataclass(frozen=True)
class Launch:
    """One batched device dispatch: ``spans`` padded to ``padded_size``
    along the work axis and ``batch_pad`` along the batch axis."""

    shape: Shape
    padded_size: int
    batch_pad: int
    spans: Tuple[Span, ...]

    @property
    def useful_units(self) -> int:
        return sum(s.size for s in self.spans)

    @property
    def padded_units(self) -> int:
        return self.padded_size * self.batch_pad


@dataclass
class LaunchPlan:
    """Deterministic grouping of pieces into padded batched launches."""

    phase: str
    launches: List[Launch]
    signature: str
    cached: bool = False
    merged_buckets: int = 0
    _recorded: bool = field(default=False, repr=False)

    @property
    def n_launches(self) -> int:
        return len(self.launches)

    @property
    def n_buckets(self) -> int:
        return len({(l.shape, l.padded_size) for l in self.launches})

    @property
    def useful_units(self) -> int:
        return sum(l.useful_units for l in self.launches)

    @property
    def padded_units(self) -> int:
        return sum(l.padded_units for l in self.launches)

    @property
    def pad_waste_ratio(self) -> float:
        padded = self.padded_units
        return 0.0 if padded <= 0 else 1.0 - self.useful_units / padded

    def record(self) -> "LaunchPlan":
        """Emit the ``launch.*`` observability family for this plan (global
        and per-phase). Idempotent per plan object so call sites can record
        unconditionally next to execution."""
        if self._recorded:
            return self
        self._recorded = True
        for scope in ("launch", f"launch.phase.{self.phase}"):
            counter_inc(f"{scope}.plans")
            counter_inc(f"{scope}.launches", self.n_launches)
            counter_inc(f"{scope}.buckets", self.n_buckets)
            counter_inc(f"{scope}.pieces", sum(len(l.spans) for l in self.launches))
            counter_inc(f"{scope}.padded_units", self.padded_units)
            counter_inc(f"{scope}.useful_units", self.useful_units)
            gauge_set(f"{scope}.pad_waste_ratio", round(self.pad_waste_ratio, 6))
        if self.merged_buckets:
            counter_inc("launch.merged_buckets", self.merged_buckets)
        return self

    def launch_scope(self, launch: "Launch"):
        """Execution scope for ONE launch of this plan. Call sites wrap the
        device dispatch: ``with plan.launch_scope(launch): ...``. A null
        context: the launch-cost ledger it feeds in the JAX package comes
        with queue 1 item 10 of ROADMAP.md."""
        return nullcontext()

    # -- persistence (pure-data round trip) --------------------------------

    def to_payload(self) -> Dict[str, Any]:
        return {
            "signature": self.signature,
            "merged_buckets": self.merged_buckets,
            "launches": [
                {"shape": list(l.shape), "padded": l.padded_size,
                 "batch_pad": l.batch_pad,
                 "spans": [[s.key, s.lo, s.size] for s in l.spans]}
                for l in self.launches],
        }

    @classmethod
    def from_payload(cls, phase: str, payload: Dict[str, Any]) -> "LaunchPlan":
        launches = [
            Launch(shape=tuple(l["shape"]), padded_size=int(l["padded"]),
                   batch_pad=int(l["batch_pad"]),
                   spans=tuple(Span(key=s[0], lo=int(s[1]), size=int(s[2]))
                               for s in l["spans"]))
            for l in payload["launches"]]
        return cls(phase=phase, launches=launches,
                   signature=payload["signature"], cached=True,
                   merged_buckets=int(payload.get("merged_buckets", 0)))


# ---------------------------------------------------------------------------
# plan store: per-fingerprint JSON files under <root>/, armed by
# DELPHI_PLAN_DIR or set_plan_store. Plans reattach by span key; any
# signature mismatch (piece set, sizes, shapes, or policy knobs changed) is
# a miss and the phase replans.
# ---------------------------------------------------------------------------


class PlanStore:
    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._mem: Dict[str, Dict[str, Any]] = {}

    def _path(self, fingerprint: str) -> str:
        return os.path.join(self.root, f"{fingerprint}.json")

    def _doc(self, fingerprint: str) -> Dict[str, Any]:
        with self._lock:
            doc = self._mem.get(fingerprint)
        if doc is not None:
            return doc
        from delphi_tpu_torch.parallel import store as dstore
        doc, _status = dstore.read_json(
            self._path(fingerprint), schema="launch_plan",
            site="store.plan", root=self.root)
        if not isinstance(doc, dict):
            # missing, quarantined-corrupt, or legacy garbage: a plan-cache
            # miss either way — the phase replans and overwrites
            doc = {"version": 1, "phases": {}}
        with self._lock:
            self._mem[fingerprint] = doc
        return doc

    def load(self, fingerprint: str, phase: str) -> Optional[Dict[str, Any]]:
        return self._doc(fingerprint).get("phases", {}).get(phase)

    def save(self, fingerprint: str, phase: str,
             payload: Dict[str, Any]) -> None:
        doc = self._doc(fingerprint)
        with self._lock:
            doc.setdefault("phases", {})[phase] = payload
            body = json.dumps(doc, sort_keys=True) + "\n"
        from delphi_tpu_torch.parallel import store as dstore
        try:
            # durable-store seam: envelope + fsync + rename + dir fsync —
            # the pre-seam writer skipped fsync entirely, so a crash could
            # land rename metadata with no data behind it
            dstore.write_bytes(self._path(fingerprint), body.encode("utf-8"),
                               schema="launch_plan", site="store.plan",
                               root=self.root)
        except OSError:
            pass  # persistence is best-effort; planning already succeeded
        gauge_set("serve.warm_plans", self.n_plans())

    def n_plans(self) -> int:
        # launch-cost ledgers (ledger.<fp>.json, written by the JAX
        # package's trace plane) live beside the plans but are not plans
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.endswith(".json")
                       and not n.startswith("ledger."))
        except OSError:
            return 0

    def fingerprints(self) -> List[str]:
        try:
            return sorted(n[:-5] for n in os.listdir(self.root)
                          if n.endswith(".json")
                          and not n.startswith("ledger."))
        except OSError:
            return []


_store: Optional[PlanStore] = None
_env_store: Optional[PlanStore] = None
_tls = threading.local()


def set_plan_store(root: Optional[str]) -> Optional[PlanStore]:
    """Arm (or disarm, with None) the process plan store."""
    global _store
    _store = PlanStore(root) if root else None
    return _store


def get_plan_store() -> Optional[PlanStore]:
    """The armed store; falls back to DELPHI_PLAN_DIR when none was armed
    programmatically."""
    global _env_store
    if _store is not None:
        return _store
    root = os.environ.get("DELPHI_PLAN_DIR")
    if root:
        if _env_store is None or _env_store.root != root:
            _env_store = PlanStore(root)
        return _env_store
    return None


def current_fingerprint() -> Optional[str]:
    return getattr(_tls, "fingerprint", None)


@contextmanager
def plan_fingerprint(fingerprint: Optional[str]):
    """Scope all plan_launches calls on this thread to one table
    fingerprint (``run()`` derives a table-level one when a plan store is
    armed and none is active)."""
    prev = getattr(_tls, "fingerprint", None)
    _tls.fingerprint = fingerprint
    try:
        yield
    finally:
        _tls.fingerprint = prev


def table_plan_fingerprint(name: str, n_rows: int,
                           columns: Sequence[str]) -> str:
    """Cheap table-level fingerprint for plan persistence. Collisions are
    harmless: the plan signature re-validates piece sets on load."""
    body = json.dumps([str(name), int(n_rows), list(map(str, columns))])
    return hashlib.sha1(body.encode("utf-8")).hexdigest()


def stored_launch_shapes(fingerprint: Optional[str],
                         phase: str) -> List[Tuple[Shape, int, int]]:
    """(shape, padded_size, batch_pad) triples of the persisted plans for
    ``phase`` — the compile plane prewarms exactly these variants. A phase
    that plans per work group persists under ``phase[i]`` keys; this
    aggregates them. Empty when no store, no fingerprint, or nothing
    stored."""
    store = get_plan_store()
    if store is None or not fingerprint:
        return []
    doc_phases = store._doc(fingerprint).get("phases", {})
    out: List[Tuple[Shape, int, int]] = []
    for name, payload in sorted(doc_phases.items()):
        # `phase[i]` = per-work-group plans; `phase@r<k>of<w>` = the JAX
        # package's per-rank plans of its shard plane
        if name != phase and not name.startswith(phase + "[") \
                and not name.startswith(phase + "@"):
            continue
        out.extend((tuple(l["shape"]), int(l["padded"]), int(l["batch_pad"]))
                   for l in payload.get("launches", []))
    return out


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _signature(phase: str, pieces: Sequence[Piece],
               policy: Dict[str, Any]) -> str:
    body = json.dumps(
        {"phase": phase, "policy": policy,
         "pieces": [[p.key, int(p.size), list(p.shape)] for p in pieces]},
        sort_keys=True, default=str)
    return hashlib.sha1(body.encode("utf-8")).hexdigest()


def plan_launches(
    phase: str,
    pieces: Sequence[Piece],
    *,
    size_floor: int = 1,
    chunk: Optional[int] = None,
    batch_cap: Optional[Union[int, Callable[[Shape, int], int]]] = None,
    batch_width: Optional[int] = None,
    pad_batch: bool = False,
    pad_to_max: bool = False,
    merge: bool = False,
    policy_tag: str = "",
    fingerprint: Optional[str] = None,
    persist: bool = True,
) -> LaunchPlan:
    """Group ``pieces`` into a deterministic :class:`LaunchPlan`.

    * ``chunk``     — split pieces into spans of at most this many units
    * ``size_floor``— minimum padded span size (recompilation bound)
    * ``batch_cap`` — max spans per launch; int, or callable
                      ``(shape, padded_size) -> int`` for memory-derived caps
    * ``batch_width``— fixed launch width (freq's repeat-pad chunking):
                      implies cap = width and batch_pad = width
    * ``pad_batch`` — pow2-pad the batch axis (else exact span count)
    * ``pad_to_max``— pad every span in a shape bucket to the longest span
                      (percentile pools) instead of per-span pow2
    * ``merge``     — allow the bounded same-shape bucket merge (only when
                      planning is enabled; never increases launch count)
    * ``policy_tag``— extra caller knob state folded into the signature so
                      stale persisted plans invalidate

    Every piece is covered exactly once; plan order is the deterministic
    first-occurrence order of (shape, padded_size) buckets over pieces.
    """
    enabled = planning_enabled()
    policy = {
        "floor": int(size_floor), "chunk": chunk, "width": batch_width,
        "pad_batch": bool(pad_batch), "pad_to_max": bool(pad_to_max),
        "merge": bool(merge and enabled), "merge_factor": merge_factor(),
        "enabled": enabled, "tag": policy_tag,
        "cap": batch_cap if isinstance(batch_cap, int) else None,
    }
    if policy["merge"] and plan_cost_enabled():
        # DELPHI_PLAN_COST=1 makes the JAX package's merges consult its
        # launch-cost ledger, which the port does not have yet
        raise NotImplementedError(
            "the launch planner's cost veto (DELPHI_PLAN_COST) is not "
            "ported to delphi_tpu_torch yet (queue 1 item 10 of "
            "ROADMAP.md, observability)")
    sig = _signature(phase, pieces, policy)

    store_phase = phase
    fp = fingerprint if fingerprint is not None else current_fingerprint()
    store = get_plan_store() if (persist and enabled) else None
    if store is not None and fp:
        stored = store.load(fp, store_phase)
        if stored and stored.get("signature") == sig:
            counter_inc("launch.plan_cache.hits")
            return LaunchPlan.from_payload(phase, stored)

    plan = _compute_plan(phase, pieces, sig, policy, batch_cap)

    if store is not None and fp:
        counter_inc("launch.replans")
        store.save(fp, store_phase, plan.to_payload())
    return plan


def _compute_plan(phase: str, pieces: Sequence[Piece], sig: str,
                  policy: Dict[str, Any],
                  batch_cap: Optional[Union[int, Callable[[Shape, int], int]]],
                  ) -> LaunchPlan:
    size_floor = policy["floor"]
    chunk = policy["chunk"]
    batch_width = policy["width"]

    # 1. chunk pieces into spans (piece order, then offset order)
    spans: List[Tuple[Span, Shape]] = []
    for p in pieces:
        if p.size <= 0:
            continue
        step = int(chunk) if chunk else p.size
        for lo in range(0, p.size, step):
            spans.append((Span(key=p.key, lo=lo,
                               size=min(step, p.size - lo)), p.shape))

    # 2. bucket by (shape, padded span size) in first-occurrence order
    buckets: Dict[Tuple[Shape, int], List[Span]] = {}
    if policy["pad_to_max"]:
        longest: Dict[Shape, int] = {}
        for s, shape in spans:
            longest[shape] = max(longest.get(shape, 0), s.size)
        for s, shape in spans:
            buckets.setdefault((shape, longest[shape]), []).append(s)
    else:
        for s, shape in spans:
            buckets.setdefault(
                (shape, pow2_pad(s.size, size_floor)), []).append(s)

    def cap_of(shape: Shape, padded: int) -> int:
        if batch_width is not None:
            return int(batch_width)
        if batch_cap is None:
            return 1 << 62
        if callable(batch_cap):
            return max(1, int(batch_cap(shape, padded)))
        return max(1, int(batch_cap))

    def launches_of(bucket_map: Dict[Tuple[Shape, int], List[Span]]) -> int:
        return sum(-(-len(members) // cap_of(shape, padded))
                   for (shape, padded), members in bucket_map.items())

    # 3. bounded same-shape merge: fold a bucket into the next-larger
    # padded size of the same shape when the total ratio stays within
    # merge_factor AND the merged grouping does not launch more often.
    merged_buckets = 0
    if policy["merge"] and policy["merge_factor"] > 0:
        factor = policy["merge_factor"]
        by_shape: Dict[Shape, List[int]] = {}
        for shape, padded in buckets:
            by_shape.setdefault(shape, []).append(padded)
        remap: Dict[Tuple[Shape, int], int] = {}
        for shape, sizes in by_shape.items():
            sizes = sorted(set(sizes))
            step_up = {a: b for a, b in zip(sizes, sizes[1:])}
            for p in sizes:
                t = p
                while t in step_up and step_up[t] // p <= factor:
                    t = step_up[t]
                if t != p:
                    remap[(shape, p)] = t
        if remap:
            candidate: Dict[Tuple[Shape, int], List[Span]] = {}
            for (shape, padded), members in buckets.items():
                target = remap.get((shape, padded), padded)
                candidate.setdefault((shape, target), []).extend(members)
            if launches_of(candidate) <= launches_of(buckets):
                merged_buckets = len(buckets) - len(candidate)
                buckets = candidate

    # 4. split buckets into launches of at most cap spans
    launches: List[Launch] = []
    for (shape, padded), members in buckets.items():
        cap = cap_of(shape, padded)
        for s in range(0, len(members), cap):
            group = members[s:s + cap]
            if batch_width is not None:
                b_pad = int(batch_width)
            elif policy["pad_batch"]:
                b_pad = pow2_pad(len(group))
            else:
                b_pad = len(group)
            launches.append(Launch(shape=shape, padded_size=padded,
                                   batch_pad=b_pad, spans=tuple(group)))

    return LaunchPlan(phase=phase, launches=launches, signature=sig,
                      merged_buckets=merged_buckets)


def padded_extent(phase: str, n: int, floor: int = 8,
                  shape: Shape = ()) -> int:
    """Single-extent convenience: the padded size the planner would assign
    one piece of ``n`` units (pow2, floored). Used by phases whose launch
    is a single padded array rather than a batch."""
    plan = plan_launches(phase, [Piece(key=0, size=max(int(n), 1),
                                       shape=shape)],
                         size_floor=floor, persist=False)
    plan.record()
    return plan.launches[0].padded_size


def plan_cv_slab_widths(n_instances: int, cap: int,
                        single_target: bool) -> List[int]:
    """Distinct launch widths the GBDT CV slab policy will use for
    ``n_instances`` fused instances — the compile plane enumerates prewarm
    variants from this instead of its former per-phase heuristic."""
    if n_instances <= 0:
        return []
    plan = plan_launches(
        "gbdt.cv", [Piece(key=i, size=1) for i in range(int(n_instances))],
        batch_cap=int(cap), pad_batch=not single_target, persist=False)
    return sorted({l.batch_pad for l in plan.launches})
