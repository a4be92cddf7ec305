"""Device time from ``torch.profiler`` records.

The port's counterpart of the JAX package's ``utils/profiling.py``, which
parses the ``*.xplane.pb`` of a ``jax.profiler`` trace. Here the records
come from ``torch.profiler`` (Kineto over CUPTI, shipped inside torch):
each kernel, memcpy and memset the card ran, and each
``record_function`` range the host opened (``phase_span`` opens one per
phase, ``LaunchPlan.launch_scope`` one per planned launch) with its
device-side shadow. They are
normalized to :class:`DeviceEvent` records in memory, so the run report
and the launch-cost ledger join them without reading the exported trace
back:

* busy time: the union of the kernel, memcpy and memset intervals;
* top kernels: device time summed per kernel name;
* per-range time: busy intervals overlapping a range's windows, and the
  top kernels inside them.

:class:`DeviceUtilization` keeps the JAX class's ``start()`` /
``stop(wall)`` contract and answer keys (``device_busy_frac``,
``device_busy_s``, ``top_kernels``, ``profile_error``). A run on the CPU
has no device records: it answers ``device_busy_frac: None`` with an
error string, as the JAX class answers "no device planes in trace".

A session that is not the process's first can lose the records of its
first launches, while the process's first session keeps them
(``python3 chip_smoke.py --profile-probe`` counts them on a card; the
port's ``PERF.md`` has its numbers). So a session on the card opens with
a primer (:data:`PRIMER`): launches of a one-element kernel, each waited
for, that take that loss ahead of the profiled work. Its records are
dropped from what
:func:`stop_profiler` returns, and when none of them survived the loss may
reach past the primer: the returned :class:`ProfileEvents` then say
``complete=False``, which the run report and :class:`DeviceUtilization`
pass on.
"""

import bisect
import os
import tempfile
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

KERNEL = "kernel"
MEMCPY = "memcpy"
MEMSET = "memset"
ANNOTATION = "annotation"
#: the device-side shadow of a host range: the span of the card's work
#: launched inside it, on the card's clock; it occupies nothing
DEVICE_RANGE = "device_range"
#: kinds that occupy the card
DEVICE_KINDS = (KERNEL, MEMCPY, MEMSET)

# Kineto's activity types -> the kinds above
_ACTIVITY_KINDS = {"kernel": KERNEL, "gpu_memcpy": MEMCPY,
                   "gpu_memset": MEMSET, "user_annotation": ANNOTATION,
                   "gpu_user_annotation": DEVICE_RANGE}

# How many top kernels (by total device time) measurement reports, as in
# the JAX package.
DEFAULT_TOP_KERNELS = 3

Interval = Tuple[int, int]

#: the ``record_function`` range that opens a profile on the card
PRIMER = "profiler.primer"
#: its launches, each waited for and followed by a short idle gap, as the
#: spaced launches that a later session loses are
PRIMER_LAUNCHES = 64
PRIMER_GAP_S = 0.001
#: what a profile whose primer kept no record reports
INCOMPLETE = "the profile lost the device records of its first launches"


class DeviceEvent(NamedTuple):
    """One normalized profiler record: a kernel, memcpy or memset on the
    card, or a host ``record_function`` range; nanoseconds on the
    profiler's one clock."""
    name: str
    kind: str
    start_ns: int
    end_ns: int


def _kind_of(activity: Optional[str], on_device: bool, user_annotation: bool,
             name: str) -> Optional[str]:
    if activity is not None:
        return _ACTIVITY_KINDS.get(str(activity))
    if on_device:
        if user_annotation:
            return DEVICE_RANGE
        if name.startswith("Memcpy"):
            return MEMCPY
        if name.startswith("Memset"):
            return MEMSET
        return KERNEL
    return ANNOTATION if user_annotation else None


def events_from_kineto(raw: Iterable[Any]) -> List[DeviceEvent]:
    """Normalizes Kineto events (``prof.profiler.kineto_results.events()``,
    objects with ``name()``, ``device_type()``, ``start_ns()``,
    ``duration_ns()``, ``is_user_annotation()`` and, on torch 2.13 but not
    2.11, ``activity_type()``); host operator records are dropped."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out: List[DeviceEvent] = []
    for ev in raw:
        activity = ev.activity_type() if hasattr(ev, "activity_type") \
            else None
        if activity is not None and str(activity) not in _ACTIVITY_KINDS:
            continue
        name = ev.name()
        kind = _kind_of(activity, ev.device_type() == cuda,
                        bool(ev.is_user_annotation()), name)
        if kind is None:
            continue
        start = int(ev.start_ns())
        out.append(DeviceEvent(name, kind, start,
                               start + int(ev.duration_ns())))
    return out


class ProfileEvents(list):
    """A session's normalized records; ``complete`` is False when the
    session's primer kept none of its records, so that the loss at the
    session's start may have taken the profiled work's first records."""
    complete = True


def profiler_events(prof: Any) -> List[DeviceEvent]:
    """The normalized records of a stopped ``torch.profiler.profile``."""
    return events_from_kineto(prof.profiler.kineto_results.events())


def prime(torch: Any) -> None:
    """Runs the primer on the current card inside a started profile."""
    from torch.profiler import record_function
    x = torch.zeros(1, device=torch.device("cuda",
                                           torch.cuda.current_device()))
    with record_function(PRIMER):
        for _ in range(PRIMER_LAUNCHES):
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(PRIMER_GAP_S)


def drop_primer(events: Iterable[DeviceEvent]) -> ProfileEvents:
    """``events`` without the primer's range, its device-side shadow and
    the device records inside the shadow (on the card's clock: the host's
    range can end a few microseconds after the card's clock has passed the
    next launch). ``complete`` says whether the primer kept any device
    record: a session whose primer lost every record has no shadow of it.
    A session without a primer is complete."""
    events = list(events)
    out = ProfileEvents(e for e in events if e.name != PRIMER)
    if not any(e.name == PRIMER and e.kind == ANNOTATION for e in events):
        return out
    shadow = annotation_windows(events, [PRIMER], DEVICE_RANGE).get(PRIMER)
    if not shadow:
        out.complete = False
        return out
    lo, hi = shadow[0][0], shadow[-1][1]

    def inside(e: DeviceEvent) -> bool:
        return e.kind in DEVICE_KINDS and lo <= e.start_ns and e.end_ns <= hi

    out = ProfileEvents(e for e in out if not inside(e))
    out.complete = any(inside(e) for e in events)
    return out


def start_profiler() -> Any:
    """A started ``torch.profiler.profile`` over host activity and, when a
    card is present, CUDA activity; on a card this process already uses,
    the primer has run in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        prime(torch)
    return prof


def stop_profiler(prof: Any) -> ProfileEvents:
    """Stops ``prof`` (after the card's queued work) and returns its
    normalized records without the primer's."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    return drop_primer(profiler_events(prof))


def export_trace(prof: Any, directory: str, name: str) -> str:
    """Writes the stopped profile once to ``directory`` as a Chrome trace
    and returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def merge_intervals(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[Interval] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Total overlap between two sorted, merged interval lists."""
    total = 0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_intervals(events: Iterable[DeviceEvent]) -> List[Interval]:
    """The merged intervals in which the card ran a kernel, memcpy or
    memset."""
    return merge_intervals((e.start_ns, e.end_ns) for e in events
                           if e.kind in DEVICE_KINDS)


def annotation_windows(events: Iterable[DeviceEvent],
                       names: Iterable[str],
                       kind: str = ANNOTATION) -> Dict[str, List[Interval]]:
    """Per range name, the merged windows of the host ranges of that name
    (``kind=DEVICE_RANGE``: of their device-side shadows, on the card's
    clock)."""
    wanted = set(names)
    windows: Dict[str, List[Interval]] = {}
    for e in events:
        if e.kind == kind and e.name in wanted:
            windows.setdefault(e.name, []).append((e.start_ns, e.end_ns))
    return {name: merge_intervals(iv) for name, iv in windows.items()}


def busy_and_top_kernels(events: Iterable[DeviceEvent],
                         top_k: int = DEFAULT_TOP_KERNELS) \
        -> Tuple[float, List[Tuple[str, float]]]:
    """(busy seconds: the union of kernel, memcpy and memset intervals,
    [(kernel name, total seconds)] of the ``top_k`` kernels by device
    time)."""
    events = list(events)
    busy_ns = sum(e - s for s, e in device_intervals(events))
    per_kernel: Dict[str, int] = {}
    for e in events:
        if e.kind == KERNEL:
            per_kernel[e.name] = per_kernel.get(e.name, 0) \
                + (e.end_ns - e.start_ns)
    top = sorted(per_kernel.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
    return busy_ns / 1e9, [(n, t / 1e9) for n, t in top]


def phase_kernels(events: Iterable[DeviceEvent],
                  windows: Dict[str, List[Interval]],
                  top_k: int = DEFAULT_TOP_KERNELS) \
        -> Dict[str, List[Tuple[str, float]]]:
    """Per range name, the ``top_k`` kernels by device seconds inside its
    (merged) windows: a kernel that straddles a window's edge is credited
    with its part inside."""
    kernels = sorted((e for e in events if e.kind == KERNEL),
                     key=lambda e: e.start_ns)
    starts = [k.start_ns for k in kernels]
    longest = max((k.end_ns - k.start_ns for k in kernels), default=0)
    out: Dict[str, List[Tuple[str, float]]] = {}
    for name, wins in sorted(windows.items()):
        per: Dict[str, int] = {}
        for lo_ns, hi_ns in wins:
            for k in kernels[bisect.bisect_left(starts, lo_ns - longest):
                             bisect.bisect_left(starts, hi_ns)]:
                ov = min(hi_ns, k.end_ns) - max(lo_ns, k.start_ns)
                if ov > 0:
                    per[k.name] = per.get(k.name, 0) + ov
        top = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
        out[name] = [(n, t / 1e9) for n, t in top]
    return out


def kernel_durations_ns(events: Iterable[DeviceEvent],
                        names: Iterable[str]) -> List[int]:
    """Device nanoseconds of each kernel record whose name contains one of
    ``names``, in launch order."""
    names = tuple(names)
    return [e.end_ns - e.start_ns
            for e in sorted(events, key=lambda e: e.start_ns)
            if e.kind == KERNEL and any(n in e.name for n in names)]


class DeviceUtilization:
    """Samples device busy time over a measured region.

    Usage::

        util = DeviceUtilization()
        util.start()
        ...workload...
        extra = util.stop(wall_seconds)   # dict for the bench JSON
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 keep_trace: bool = False,
                 top_kernels: int = DEFAULT_TOP_KERNELS) -> None:
        self._trace_dir = trace_dir
        self._keep = keep_trace or trace_dir is not None
        self._top_kernels = top_kernels
        self._prof: Any = None

    def start(self) -> None:
        try:
            self._prof = start_profiler()
        except Exception:
            self._prof = None

    def stop(self, wall_seconds: float) -> Dict[str, Any]:
        if self._prof is None:
            return {"device_busy_frac": None,
                    "profile_error": "trace did not start"}
        prof, self._prof = self._prof, None
        try:
            events = stop_profiler(prof)
            out: Dict[str, Any] = {}
            if self._keep:
                directory = self._trace_dir \
                    or tempfile.mkdtemp(prefix="delphi_trace_")
                export_trace(prof, directory, "device_utilization")
                out["trace_dir"] = directory
            if not any(e.kind in DEVICE_KINDS for e in events):
                out.update({"device_busy_frac": None,
                            "profile_error": "no device records in trace"})
                return out
            if not getattr(events, "complete", True):
                out["profile_error"] = INCOMPLETE
            busy_s, top = busy_and_top_kernels(events, self._top_kernels)
            frac = min(1.0, busy_s / wall_seconds) if wall_seconds > 0 \
                else 0.0
            out.update({
                "device_busy_frac": round(frac, 4),
                "device_busy_s": round(busy_s, 3),
                "top_kernels": [
                    {"name": n[:120], "total_s": round(t, 4)}
                    for n, t in top],
            })
            return out
        except Exception as e:
            return {"device_busy_frac": None,
                    "profile_error": f"{type(e).__name__}: {e}"}

