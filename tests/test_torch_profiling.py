"""The port's device-time join (``delphi_tpu_torch/utils/profiling.py``,
``observability/report.py``) and run recorder on synthetic profiler
records, the cases of the JAX package's ``tests/test_profiling.py`` and
``tests/test_run_report.py``: busy time is the union of kernel, memcpy and
memset intervals (annotations occupy nothing), per-phase device time is
the overlap of those intervals with a span's merged ranges, top kernels
rank by summed device time, every value against a hand-computed one and
the interval helpers against the JAX package's on seeded intervals.
Kineto records are classified by their activity type (or, on a torch
without one, by device and name); a profile on the CPU has no device
records, so ``DeviceUtilization`` answers ``device_busy_frac: None`` with
an error. The registry's reservoir sampling and cross-process merge equal
the JAX package's on the same observations.
"""

import random
import threading

import pytest
import torch

from delphi_tpu.observability import registry as j_registry
from delphi_tpu.observability import report as j_report
from delphi_tpu_torch import observability as obs
from delphi_tpu_torch.observability import registry, report, spans
from delphi_tpu_torch.utils import phase_span, profile_trace, profiling
from delphi_tpu_torch.utils.profiling import (ANNOTATION, DEVICE_RANGE,
                                              KERNEL, MEMCPY, MEMSET,
                                              DeviceEvent)

US = 1000  # nanoseconds


def _ev(name, kind, start_us, end_us):
    return DeviceEvent(name, kind, start_us * US, end_us * US)


# a run of two phases: "attr stats" [0, 100) us, "domain" [100, 250) us
# and again [400, 450) us; kernels, a copy and a memset on the card
EVENTS = [
    _ev("attr stats", ANNOTATION, 0, 100),
    _ev("domain", ANNOTATION, 100, 250),
    _ev("domain", ANNOTATION, 400, 450),
    _ev("repair.run", ANNOTATION, 0, 500),
    _ev("attr stats", DEVICE_RANGE, 9, 41),         # occupies nothing
    _ev("pair_counts_kernel", KERNEL, 10, 30),
    _ev("entropy_kernel", KERNEL, 25, 40),          # overlaps the first
    _ev("Memcpy HtoD (Pageable -> Device)", MEMCPY, 90, 110),  # straddles
    _ev("domain_scores_kernel", KERNEL, 200, 260),  # runs past its range
    _ev("Memset (Device)", MEMSET, 300, 310),       # in no phase's range
    _ev("domain_scores_kernel", KERNEL, 420, 430),
]


def test_busy_time_unions_overlapping_device_records():
    # [10,40) + [90,110) + [200,260) + [300,310) + [420,430) = 130 us
    busy_s, top = profiling.busy_and_top_kernels(EVENTS)
    assert busy_s == pytest.approx(130e-6)
    # kernel sums: domain 70, pair 20, entropy 15; copies are no kernels
    assert top == [("domain_scores_kernel", pytest.approx(70e-6)),
                   ("pair_counts_kernel", pytest.approx(20e-6)),
                   ("entropy_kernel", pytest.approx(15e-6))]


def test_top_kernels_honor_top_k_and_tie_order():
    events = [_ev(n, KERNEL, i * 10, i * 10 + 5)
              for i, n in enumerate("dcba")]
    assert [n for n, _ in profiling.busy_and_top_kernels(events, 2)[1]] \
        == ["a", "b"]
    assert profiling.busy_and_top_kernels([], 3) == (0.0, [])


def test_annotation_windows_merge_ranges_of_one_name():
    got = profiling.annotation_windows(EVENTS, {"domain", "attr stats",
                                                "absent"})
    assert got == {"attr stats": [(0, 100 * US)],
                   "domain": [(100 * US, 250 * US), (400 * US, 450 * US)]}
    nested = [_ev("x", ANNOTATION, 0, 10), _ev("x", ANNOTATION, 5, 20),
              _ev("x", KERNEL, 0, 50)]
    assert profiling.annotation_windows(nested, ["x"]) == \
        {"x": [(0, 20 * US)]}
    # the device-side shadows, on the card's clock
    assert profiling.annotation_windows(EVENTS, ["attr stats"],
                                        kind=DEVICE_RANGE) == \
        {"attr stats": [(9 * US, 41 * US)]}


def test_attribute_device_time_joins_ranges_and_device_records():
    got = report.attribute_device_time(EVENTS, {"attr stats", "domain",
                                                "repair.run"})
    # attr stats: [10,40) 30 + [90,100) 10 = 40 us; domain: [100,110) 10 +
    # [200,250) 50 + [420,430) 10 = 70 us; the root: all 130 us
    assert got["per_phase"] == {"attr stats": pytest.approx(40e-6),
                                "domain": pytest.approx(70e-6),
                                "repair.run": pytest.approx(130e-6)}
    assert got["device_busy_s"] == pytest.approx(130e-6)
    assert got["top_kernels"][0]["name"] == "domain_scores_kernel"
    # kernels inside each phase's ranges, the straddling one clipped
    # ([200,260) counts 50 us inside [100,250)), the copy not a kernel
    per = {p: [(k["name"], k["total_s"]) for k in ks]
           for p, ks in got["per_phase_kernels"].items()}
    assert per["attr stats"] == [("pair_counts_kernel", 20e-6),
                                 ("entropy_kernel", 15e-6)]
    assert per["domain"] == [("domain_scores_kernel", 60e-6)]


@pytest.mark.parametrize("events,names", [
    ([], {"attr stats"}),
    ([e for e in EVENTS if e.kind == ANNOTATION], {"attr stats"}),
    (EVENTS, {"no such phase"}),
    (None, {"attr stats"}),
])
def test_attribute_device_time_is_none_without_a_join(events, names):
    assert report.attribute_device_time(events, names) is None


def test_interval_helpers_equal_jax():
    rng = random.Random(7)
    for _ in range(200):
        a = [(s, s + rng.randint(0, 40)) for s in
             (rng.randint(0, 500) for _ in range(rng.randint(0, 12)))]
        b = [(s, s + rng.randint(0, 40)) for s in
             (rng.randint(0, 500) for _ in range(rng.randint(0, 12)))]
        ma, mb = profiling.merge_intervals(a), profiling.merge_intervals(b)
        assert ma == j_report._merge_intervals(a)
        assert profiling.overlap_ns(ma, mb) == j_report._overlap_ns(ma, mb)
    assert profiling.merge_intervals([(5, 9), (0, 3), (2, 6)]) == [(0, 9)]
    assert profiling.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_kernel_durations_in_launch_order():
    got = profiling.kernel_durations_ns(EVENTS, ["domain_scores",
                                                 "pair_counts"])
    assert got == [20 * US, 60 * US, 10 * US]


class _Kineto:
    """A stand-in for torch's ``_KinetoEvent``."""

    def __init__(self, name, activity, device, start, dur, user=False):
        self._v = (name, activity, device, start, dur, user)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _OldKineto(_Kineto):
    """A torch without ``activity_type``."""

    activity_type = None

    def __getattribute__(self, item):
        if item == "activity_type":
            raise AttributeError(item)
        return object.__getattribute__(self, item)


CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def test_kineto_records_classify_by_activity_type():
    raw = [_Kineto("attr stats", "user_annotation", CPU, 0, 100, True),
           _Kineto("attr stats", "gpu_user_annotation", CUDA, 5, 90, True),
           _Kineto("aten::add", "cpu_op", CPU, 10, 5),
           _Kineto("cudaLaunchKernel", "cuda_runtime", CPU, 11, 3),
           _Kineto("k", "kernel", CUDA, 20, 30),
           _Kineto("Memcpy DtoH", "gpu_memcpy", CUDA, 60, 4),
           _Kineto("Memset", "gpu_memset", CUDA, 70, 2)]
    assert profiling.events_from_kineto(raw) == [
        DeviceEvent("attr stats", ANNOTATION, 0, 100),
        DeviceEvent("attr stats", DEVICE_RANGE, 5, 95),
        DeviceEvent("k", KERNEL, 20, 50),
        DeviceEvent("Memcpy DtoH", MEMCPY, 60, 64),
        DeviceEvent("Memset", MEMSET, 70, 72)]


def test_kineto_records_without_activity_type_classify_by_device():
    raw = [_OldKineto("attr stats", None, CPU, 0, 100, True),
           _OldKineto("attr stats", None, CUDA, 5, 90, True),
           _OldKineto("aten::add", None, CPU, 10, 5),
           _OldKineto("k", None, CUDA, 20, 30),
           _OldKineto("Memcpy HtoD", None, CUDA, 60, 4),
           _OldKineto("Memset (Device)", None, CUDA, 70, 2)]
    assert [e.kind for e in profiling.events_from_kineto(raw)] == \
        [ANNOTATION, DEVICE_RANGE, KERNEL, MEMCPY, MEMSET]


def test_device_utilization_on_the_cpu_has_no_device_records(tmp_path):
    util = profiling.DeviceUtilization(trace_dir=str(tmp_path / "t"))
    util.start()
    torch.ones(64).sum()
    out = util.stop(0.5)
    assert out["device_busy_frac"] is None
    assert "no device records" in out["profile_error"]
    assert out["trace_dir"] == str(tmp_path / "t")
    assert list((tmp_path / "t").glob("*.pt.trace.json"))


def test_device_utilization_reports_a_start_failure(monkeypatch):
    def boom():
        raise RuntimeError("no profiler")
    monkeypatch.setattr(profiling, "start_profiler", boom)
    util = profiling.DeviceUtilization()
    util.start()
    assert util.stop(1.0) == {"device_busy_frac": None,
                              "profile_error": "trace did not start"}


def test_device_utilization_busy_fraction_from_records(monkeypatch):
    monkeypatch.setattr(profiling, "start_profiler", lambda: object())
    monkeypatch.setattr(profiling, "stop_profiler", lambda prof: EVENTS)
    util = profiling.DeviceUtilization(top_kernels=2)
    util.start()
    out = util.stop(0.0005)
    assert out["device_busy_frac"] == pytest.approx(0.26)
    assert out["device_busy_s"] == 0.0
    assert [k["name"] for k in out["top_kernels"]] == \
        ["domain_scores_kernel", "pair_counts_kernel"]


# a primer ahead of EVENTS: its range [-60, -2) us, its shadow [-58, -4)
# us on the card's clock
PRIMER_EVENTS = [
    _ev(profiling.PRIMER, ANNOTATION, -60, -2),
    _ev(profiling.PRIMER, DEVICE_RANGE, -58, -4),
    _ev("vectorized_elementwise_kernel<add>", KERNEL, -58, -57),
    _ev("vectorized_elementwise_kernel<add>", KERNEL, -5, -4),
]
# the primer lost its first launch: the shadow spans the second alone
LATE_PRIMER = [PRIMER_EVENTS[0], _ev(profiling.PRIMER, DEVICE_RANGE, -5, -4),
               PRIMER_EVENTS[3]]


@pytest.mark.parametrize("kept,complete", [
    (PRIMER_EVENTS, True),            # every primer record kept
    (LATE_PRIMER, True),              # the loss ended inside the primer
    (PRIMER_EVENTS[:1], False),       # the primer lost every device record
])
def test_drop_primer_removes_its_records_and_judges_the_loss(kept, complete):
    # the first launch after the primer, on the card before the host's
    # range has ended: inside the range, past the shadow
    after = [_ev("vectorized_elementwise_kernel<mul>", KERNEL, -3, -2)]
    got = profiling.drop_primer(kept + after + EVENTS)
    assert list(got) == after + EVENTS
    assert got.complete is complete
    assert report.attribute_device_time(got, {"attr stats"})["complete"] \
        is complete


def test_drop_primer_without_a_primer_keeps_every_record():
    got = profiling.drop_primer(EVENTS)
    assert list(got) == EVENTS and got.complete is True
    assert report.attribute_device_time(EVENTS, {"domain"})["complete"] \
        is True


def test_start_profiler_on_the_cpu_runs_no_primer():
    prof = profiling.start_profiler()
    torch.ones(64).sum()
    events = profiling.stop_profiler(prof)
    assert events.complete is True
    assert not any(e.name == profiling.PRIMER
                   for e in profiling.profiler_events(prof))


def test_device_utilization_flags_a_profile_that_lost_its_start(
        monkeypatch):
    monkeypatch.setattr(profiling, "start_profiler", lambda: object())
    monkeypatch.setattr(profiling, "stop_profiler",
                        lambda prof: profiling.drop_primer(
                            PRIMER_EVENTS[:1] + EVENTS))
    util = profiling.DeviceUtilization()
    util.start()
    out = util.stop(0.0005)
    assert out["profile_error"] == profiling.INCOMPLETE
    assert out["device_busy_frac"] == pytest.approx(0.26)


# -- the recorder, the registry and the report ---------------------------------

def test_phase_spans_record_a_tree_and_profile_ranges(tmp_path,
                                                      monkeypatch):
    """On the CPU: the span tree, one profiler range per phase, the
    recorder's trace directory; no device records, so no device time."""
    monkeypatch.setenv("DELPHI_PROFILE_DIR", str(tmp_path / "prof"))
    rec = obs.start_recording("run")
    try:
        with profile_trace("run"):
            with phase_span("outer"):
                with phase_span("inner"):
                    torch.ones(8).sum()
    finally:
        obs.stop_recording(rec)
    assert rec.trace_dir == str(tmp_path / "prof")
    names = {e.name for e in rec.device_events if e.kind == ANNOTATION}
    assert {"outer", "inner"} <= names
    doc = obs.build_run_report(rec)
    assert doc["spans"]["children"][0]["name"] == "outer"
    assert doc["spans"]["children"][0]["children"][0]["name"] == "inner"
    assert doc["device_time"] is None


def test_report_annotates_spans_with_unique_names(monkeypatch):
    rec = obs.start_recording("repair.run")
    try:
        for name in ("attr stats", "domain", "domain"):
            s = spans.span_enter(name)
            spans.span_exit(s)
    finally:
        obs.stop_recording(rec)
    rec.trace_dir, rec.device_events = "somewhere", EVENTS
    doc = obs.build_run_report(rec)
    kids = {c["name"]: c for c in doc["spans"]["children"]}
    assert kids["attr stats"]["device_s"] == pytest.approx(40e-6)
    # a repeated name gets only the per-phase total
    assert "device_s" not in kids["domain"]
    assert doc["device_time"]["per_phase"]["domain"] == pytest.approx(70e-6)
    assert doc["device_time"]["trace_dir"] == "somewhere"


def test_phase_span_stack_is_thread_local():
    from delphi_tpu_torch.utils import current_phase
    seen = []

    def worker():
        with phase_span("worker"):
            seen.append([current_phase().name])

    with phase_span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert current_phase().name == "main"
    assert seen == [["worker"]]
    assert current_phase() is None


def test_nested_recording_keeps_outer():
    outer = obs.start_recording("outer")
    try:
        assert obs.start_recording("inner") is None
        assert obs.current_recorder() is outer
    finally:
        obs.stop_recording(outer)
    assert obs.current_recorder() is None


def test_counters_feed_the_recorder_only_while_it_records():
    from delphi_tpu_torch.utils import (counter_inc, counters, gauge_set,
                                        histogram_observe)
    counter_inc("t.before")
    rec = obs.start_recording("feed")
    try:
        counter_inc("t.during", 3)
        gauge_set("t.gauge", 7)
        histogram_observe("t.hist", 0.5)
    finally:
        obs.stop_recording(rec)
    counter_inc("t.after")
    snap = rec.registry.snapshot()
    assert snap["counters"] == {"t.during": 3}
    assert snap["gauges"] == {"t.gauge": 7}
    assert snap["histograms"]["t.hist"]["count"] == 1
    assert counters["t.before"] == counters["t.after"] == 1


def test_histogram_reservoir_equals_jax():
    rng = random.Random(3)
    values = [rng.random() for _ in range(5000)]
    mine, theirs = registry.MetricsRegistry(), j_registry.MetricsRegistry()
    for v in values:
        mine.observe("lat", v)
        theirs.observe("lat", v)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.export_state() == theirs.export_state()


def test_merged_state_snapshots_equal_jax():
    states = []
    for r in range(3):
        reg = registry.MetricsRegistry()
        reg.inc("c", r + 1)
        reg.set_gauge("g", 10 - r)
        for v in range(r * 7, r * 7 + 600):
            reg.observe("h", float(v))
        states.append(reg.export_state())
    assert registry.merge_state_snapshots(states) \
        == j_registry.merge_state_snapshots(states)
    assert registry.state_snapshot(states[1]) \
        == j_registry.state_snapshot(states[1])
