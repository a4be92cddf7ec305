"""The port's resilience plane against the JAX package's, on the CPU: the
fault taxonomy, the backoff schedule, fault plans, the guarded seam's
retries and degradation ladder, the phase-scoped CPU latch, aborts, the
watchdog hook, the backend-init probe, request scopes, the phase
checkpoint store, and whole runs under the same fault plan in both
packages (equal frames, equal ``resilience.*`` counters, equal ledger
notes). Each case of ``tests/test_resilience.py`` has its counterpart
here."""

import logging
import os
import pathlib
import pickle
import re
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import observability as j_obs
from delphi_tpu.parallel import resilience as j_rz
from delphi_tpu_torch.ops import detect as t_detect
from delphi_tpu_torch.ops.kernels import build as t_build
from delphi_tpu_torch.parallel import resilience as t_rz
from delphi_tpu_torch.utils import counters, phase_span

_ENV = ("DELPHI_FAULT_PLAN", "DELPHI_RETRY_MAX", "DELPHI_RETRY_BASE_S",
        "DELPHI_CHECKPOINT_DIR", "DELPHI_STALL_ABORT",
        "DELPHI_INIT_DEADLINE_S", "DELPHI_PROVENANCE_PATH",
        "DELPHI_DEVICE_TABLE", "DELPHI_DOMAIN_DEVICE")


def _clear():
    for var in _ENV:
        os.environ.pop(var, None)
    for rz in (j_rz, t_rz):
        rz.reset_fault_state()
        rz.clear_abort()
        rz.clear_cpu_fallback()


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    """Every test starts and ends with no plan and no latch, in both
    packages, on the CPU with one intra-op thread."""
    _clear()
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    counters.clear()
    yield
    _clear()
    torch.set_num_threads(threads)
    T.set_device(None)


# -- classification -----------------------------------------------------------

_CASES = [
    (lambda rz: RuntimeError("RESOURCE_EXHAUSTED: out of memory while trying "
                             "to allocate 2147483648 bytes"), "oom"),
    (lambda rz: RuntimeError("XlaRuntimeError: RESOURCE_EXHAUSTED: Error "
                             "allocating device buffer"), "oom"),
    (lambda rz: RuntimeError("Allocation of 4096 exceeds free HBM memory"),
     "oom"),
    (lambda rz: RuntimeError("INTERNAL: failed to transfer buffer to "
                             "device 0"), "transfer"),
    (lambda rz: RuntimeError("TransferToDeviceStream failed"), "transfer"),
    (lambda rz: RuntimeError("UNAVAILABLE: connection to coordination "
                             "service lost"), "transient"),
    (lambda rz: ConnectionError("connection reset by peer"), "transient"),
    (lambda rz: RuntimeError("INVALID_ARGUMENT: XLA compilation failed for "
                             "module jit_kernel"), "compile"),
    (lambda rz: RuntimeError("Mosaic lowering failed"), "compile"),
    (lambda rz: RuntimeError("DEADLINE_EXCEEDED: backend initialization "
                             "timed out"), "init_timeout"),
    (lambda rz: rz.BackendInitTimeout("backend initialization timed out "
                                      "after 1.0s"), "init_timeout"),
    (lambda rz: rz.RankLost("peer 3 died"), "rank_loss"),
    (lambda rz: rz.StoreCorrupt("payload crc32 mismatch"), "store_corrupt"),
    (lambda rz: ValueError("bad shape (3, 4)"), None),
    (lambda rz: KeyError("attr"), None),
    (lambda rz: RuntimeError("something else entirely"), None),
    (lambda rz: rz.ShrinkBatch("domain.bucket"), None),
    (lambda rz: rz.RunAborted("run aborted: watchdog"), None),
    (lambda rz: rz.DeadlineExceeded("late"), None),
]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_classify_fault_equals_jax(case):
    make, kind = _CASES[case]
    assert j_rz.classify_fault(make(j_rz)) == kind
    assert t_rz.classify_fault(make(t_rz)) == kind


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1024.00 GiB"), "oom"),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    # a failed build or launch is never retried or sent down the ladder,
    # whatever its log says
    (t_build.KernelBuildError(
        "nvcc failed for pair_counts.cu:\nerror: compilation failed"), None),
    (t_build.KernelLaunchError(
        "pair_counts: CUDA launch failed (cudaError 2)"), None),
    # sticky CUDA errors poison the context: no retry cures them
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     None),
    (RuntimeError("CUDA error: device-side assert triggered"), None),
    (RuntimeError("CUDA error: unspecified launch failure"), None),
])
def test_classify_torch_spellings(exc, kind):
    assert t_rz.classify_fault(exc) == kind


def test_nvcc_log_would_classify_as_compile_without_its_class():
    """Why a build failure has a class of its own: its plain RuntimeError
    text matches the compile pattern, in both packages."""
    msg = "nvcc failed for x.cu:\nx.cu(3): error: compilation terminated"
    assert j_rz.classify_fault(RuntimeError(msg)) == "compile"
    assert t_rz.classify_fault(t_build.KernelBuildError(msg)) is None


def test_real_build_and_launch_errors_are_their_classes(monkeypatch):
    monkeypatch.setattr(t_build, "_library_path", lambda: "/nonexistent.so")
    monkeypatch.setattr(t_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(t_build.os.path, "exists", lambda _: False)
    with pytest.raises(t_build.KernelBuildError) as e:
        t_build.build()
    assert t_rz.classify_fault(e.value) is None
    with pytest.raises(t_build.KernelLaunchError) as e:
        t_build.check(700, "pair_counts")
    assert t_rz.classify_fault(e.value) is None


def test_injected_faults_classify_as_their_kind():
    for kind in t_rz.FAULT_KINDS:
        exc = t_rz.FaultInjected(kind, "some.site", 1)
        assert str(exc) == str(j_rz.FaultInjected(kind, "some.site", 1))
        assert t_rz.classify_fault(exc) == kind, kind
        assert j_rz.classify_fault(j_rz.FaultInjected(kind, "s", 1)) == kind
    assert t_rz.classify_fault(t_rz.FaultInjected("fatal", "s", 1)) is None
    assert t_rz._INJECT_MESSAGES == j_rz._INJECT_MESSAGES


# -- retry policy -------------------------------------------------------------

@pytest.mark.parametrize("max_retries,base_s,cap_s", [
    (2, 0.05, 5.0), (4, 0.1, 1.0), (6, 0.25, 3.0), (3, 0.0, 5.0)])
def test_backoff_schedule_equals_jax(max_retries, base_s, cap_s):
    jp = j_rz.RetryPolicy(max_retries, base_s, cap_s)
    tp = t_rz.RetryPolicy(max_retries, base_s, cap_s)
    for site in sorted(t_rz.KNOWN_SITES):
        assert [tp.backoff_s(site, i) for i in range(1, 9)] \
            == [jp.backoff_s(site, i) for i in range(1, 9)]
    sched = [tp.backoff_s("site.a", i) for i in range(1, 6)]
    for i, d in enumerate(sched, start=1):
        base = min(tp.cap_s, base_s * 2 ** (i - 1))
        assert 0.5 * base <= d <= base


def test_default_policy_env_and_conf_overrides():
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu_torch.session import get_session as t_session
    os.environ["DELPHI_RETRY_MAX"] = "7"
    os.environ["DELPHI_RETRY_BASE_S"] = "0.25"
    for rz in (j_rz, t_rz):
        pol = rz.default_policy()
        assert (pol.max_retries, pol.base_s) == (7, 0.25)
    os.environ["DELPHI_RETRY_MAX"] = "not a number"
    assert t_rz.default_policy().max_retries == 2
    os.environ.pop("DELPHI_RETRY_MAX")
    for sess in (j_session(), t_session()):
        sess.conf["repair.resilience.retry_max"] = "5"
    try:
        assert t_rz.default_policy().max_retries \
            == j_rz.default_policy().max_retries == 5
    finally:
        for sess in (j_session(), t_session()):
            sess.conf.pop("repair.resilience.retry_max", None)


# -- fault plans --------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "backend.init:1:init_timeout, domain.*:3:oom ,xfer.upload:2:fatal",
    "0:store.manifest:1:crash,1:freq.*:2:stall",
    "gbdt.*:1:rank_death,store.plan:4:torn_write",
    "",
])
def test_parsed_plans_equal_jax(text):
    assert t_rz.parse_fault_plan(text) == j_rz.parse_fault_plan(text)


@pytest.mark.parametrize("text,match", [
    ("no-colons-here", "bad triple"), ("site:1:meltdown", "unknown fault"),
    ("site:0:oom", "1-based")])
def test_malformed_plans_raise_as_in_jax(text, match):
    for rz in (j_rz, t_rz):
        with pytest.raises(ValueError, match=match):
            rz.parse_fault_plan(text)


def test_injection_counts_site_entries_and_fires_once():
    os.environ["DELPHI_FAULT_PLAN"] = "domain.*:2:oom"
    t_rz._maybe_inject("domain.score")
    with pytest.raises(t_rz.FaultInjected) as ei:
        t_rz._maybe_inject("domain.score")
    assert t_rz.classify_fault(ei.value) == "oom"
    t_rz._maybe_inject("domain.score")
    t_rz._maybe_inject("other.site")


def test_rank_scoped_entries_match_the_process_id(monkeypatch):
    os.environ["DELPHI_FAULT_PLAN"] = "1:xfer.upload:1:oom"
    t_rz._maybe_inject("xfer.upload")  # rank 0: no fire
    t_rz.reset_fault_state()
    monkeypatch.setenv("DELPHI_PROCESS_ID", "1")
    with pytest.raises(t_rz.FaultInjected):
        t_rz._maybe_inject("xfer.upload")


def test_special_kinds_act_instead_of_raising(monkeypatch):
    class Exited(BaseException):
        pass

    def fake_exit(code):
        exits.append(code)
        raise Exited()

    exits, stalls = [], []
    monkeypatch.setattr(t_rz.os, "_exit", fake_exit)
    monkeypatch.setattr(t_rz, "_stall_forever", lambda: stalls.append(1))
    os.environ["DELPHI_FAULT_PLAN"] = \
        "a.site:1:crash,a.site:2:rank_death,a.site:3:stall"
    for _ in range(2):
        with pytest.raises(Exited):
            t_rz._maybe_inject("a.site")
    t_rz._maybe_inject("a.site")
    assert exits == [23, 17] and stalls == [1]


def test_validate_fault_plan_flags_unmatched_patterns(caplog):
    triples = t_rz.parse_fault_plan("bogus.site:1:oom,xfer.*:1:oom")
    with caplog.at_level(logging.WARNING, logger="delphi_tpu_torch"):
        unmatched = t_rz.validate_fault_plan(triples)
        t_rz.validate_fault_plan(triples)
    assert unmatched == j_rz.validate_fault_plan(
        j_rz.parse_fault_plan("bogus.site:1:oom,xfer.*:1:oom")) \
        == ("bogus.site",)
    warns = [r for r in caplog.records if r.name == "delphi_tpu_torch"
             and "bogus.site" in r.getMessage()]
    assert len(warns) == 1
    assert counters["resilience.plan.unmatched"] == 1


def test_global_plan_arms_with_validation_warning(caplog):
    os.environ["DELPHI_FAULT_PLAN"] = "nonexistent.seam:1:oom"
    with caplog.at_level(logging.WARNING, logger="delphi_tpu_torch"):
        t_rz._maybe_inject("xfer.upload")
        t_rz._maybe_inject("xfer.upload")
    assert len([r for r in caplog.records
                if "nonexistent.seam" in r.getMessage()]) == 1


def test_validate_fault_plan_accepts_wildcards_over_known_sites():
    triples = t_rz.parse_fault_plan("domain.*:1:oom,backend.init:1:fatal")
    assert t_rz.validate_fault_plan(triples) == ()


def test_known_sites_equal_jax_and_cover_every_port_literal():
    """The same site registry as the JAX package, and every site literal
    the port passes to run_guarded or _maybe_inject lies in it."""
    assert t_rz.KNOWN_SITES == j_rz.KNOWN_SITES
    root = pathlib.Path(t_rz.__file__).resolve().parents[1]
    pats = (re.compile(r'run_guarded\(\s*\n?\s*"([^"]+)"'),
            re.compile(r'_maybe_inject\(\s*\n?\s*"([^"]+)"'),
            # a site chosen by route: site = "a" if ... else "b"
            re.compile(r'\bsite = "([^"]+)"'),
            re.compile(r'\bsite = "[^"]+" if [^\n]+ else "([^"]+)"'))
    found = set()
    for path in root.rglob("*.py"):
        text = path.read_text()
        for pat in pats:
            found.update(pat.findall(text))
    # the store's sites reach _maybe_inject through a variable
    from delphi_tpu_torch.parallel.store import STORE_SITES
    found.update(STORE_SITES)
    assert found <= set(t_rz.KNOWN_SITES), found - set(t_rz.KNOWN_SITES)
    for site in ("xfer.upload", "freq.singles", "freq.pairs_pallas",
                 "freq.distinct", "domain.score", "domain.weak_label",
                 "detect.percentile", "detect.rank", "detect.sorted_count",
                 "detect.group_extrema", "gbdt.cv_chunk", "gbdt.fit_chunk",
                 "escalate.joint", "backend.init"):
        assert site in found, site


# -- run_guarded: retries and the ladder --------------------------------------

def _fake_clock():
    slept = []
    return slept, slept.append


def test_run_guarded_retries_injected_fault_with_exact_backoff():
    os.environ["DELPHI_FAULT_PLAN"] = "s:1:transient,s:2:transient"
    schedules = []
    for rz in (j_rz, t_rz):
        slept, sleep = _fake_clock()
        calls = []
        pol = rz.RetryPolicy(max_retries=2, base_s=0.05)
        assert rz.run_guarded("s", lambda: calls.append(1) or 42,
                              policy=pol, sleep=sleep) == 42
        assert len(calls) == 1
        schedules.append(slept)
    assert schedules[0] == schedules[1] and len(schedules[1]) == 2


def test_run_guarded_reraises_unclassifiable_immediately():
    slept, sleep = _fake_clock()
    attempts = []

    def thunk():
        attempts.append(1)
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        t_rz.run_guarded("s", thunk, sleep=sleep)
    assert len(attempts) == 1 and slept == []


def test_run_guarded_never_retries_a_kernel_build_or_launch_failure():
    for exc in (t_build.KernelBuildError("nvcc failed: compilation error"),
                t_build.KernelLaunchError("CUDA launch failed (cudaError 2)"),
                RuntimeError("CUDA error: an illegal memory access")):
        attempts = []

        def thunk():
            attempts.append(1)
            raise exc

        with pytest.raises(type(exc)):
            t_rz.run_guarded("freq.pairs_pallas", thunk,
                             sleep=lambda s: None)
        assert len(attempts) == 1
        assert not t_rz.cpu_fallback_active()
    assert not any(k.startswith("resilience.") for k in counters)


@pytest.mark.parametrize("lib", ["jax", "torch"])
def test_run_guarded_ladder_order_shrink_then_evict_then_cpu(lib):
    rz = j_rz if lib == "jax" else t_rz
    events = []

    def thunk():
        events.append("attempt")
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    slept, sleep = _fake_clock()
    pol = rz.RetryPolicy(max_retries=1, base_s=0.0)
    with pytest.raises(rz.ShrinkBatch):
        rz.run_guarded("s", thunk, can_shrink=True,
                       evict=lambda: events.append("evict"),
                       policy=pol, sleep=sleep)
    assert events == ["attempt", "attempt"]
    events.clear()
    with pytest.raises(RuntimeError):
        rz.run_guarded("s", thunk, evict=lambda: events.append("evict"),
                       policy=pol, sleep=sleep)
    assert events == ["attempt", "attempt", "evict",
                      "attempt", "attempt",
                      "attempt", "attempt"]
    assert rz.cpu_fallback_active()


def test_cpu_fallback_latch_is_phase_scoped():
    # outside every phase it holds until cleared, as in the JAX package
    assert t_rz._latch_cpu_fallback("s")
    assert t_rz.cpu_fallback_active()
    t_rz.clear_cpu_fallback()
    assert not t_rz.cpu_fallback_active()
    # inside a phase it holds until that phase ends, inner phases included
    with phase_span("attr stats"):
        assert t_rz._latch_cpu_fallback("s")
        with phase_span("inner"):
            assert t_rz.cpu_fallback_active()
        assert t_rz.cpu_fallback_active()
    assert not t_rz.cpu_fallback_active()
    with phase_span("repair model training"):
        assert not t_rz.cpu_fallback_active()


def test_cpu_rung_latches_only_on_a_cpu_run(monkeypatch):
    """The ladder's last rung latches where the run's device is the CPU
    (as the JAX package does) and is refused on the card: the classified
    fault re-raises, counted and noted, with nothing latched."""
    from delphi_tpu_torch import device
    import delphi_tpu_torch.observability.provenance as t_prov

    def thunk():
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")

    pol = t_rz.RetryPolicy(max_retries=1, base_s=0.0)
    assert not t_rz._run_on_card()
    monkeypatch.setattr(device, "get_device",
                        lambda: torch.device("cuda", 0))
    assert t_rz._run_on_card()
    led = t_prov.ProvenanceLedger(":memory:")
    with t_prov.scoped_ledger(led), pytest.raises(RuntimeError):
        t_rz.run_guarded("freq.pairs_pallas", thunk, policy=pol,
                         sleep=lambda s: None)
    assert not t_rz.cpu_fallback_active()
    assert counters["resilience.degrade.cpu_refused"] == 1
    assert counters["resilience.faults.oom"] == 2
    assert "resilience.degrade.cpu_fallback" not in counters
    assert [(n["note"], n["detail"]) for n in led.notes()] == [
        ("resilience.cpu_refused", "freq.pairs_pallas: oom")]
    monkeypatch.undo()
    T.set_device("cpu")
    counters.clear()
    with pytest.raises(RuntimeError):
        t_rz.run_guarded("freq.pairs_pallas", thunk, policy=pol,
                         sleep=lambda s: None)
    assert t_rz.cpu_fallback_active()
    assert counters["resilience.degrade.cpu_fallback"] == 1
    assert "resilience.degrade.cpu_refused" not in counters


@pytest.mark.parametrize("site,n_faults", [("freq.pair*", 3),
                                           ("gbdt.fit_chunk", 3),
                                           ("domain.weak_label", 6),
                                           ("domain.bucket", 6)])
def test_whole_run_reraises_where_the_card_refuses_the_cpu_rung(
        monkeypatch, site, n_faults):
    """The refusal at each kind of guarded site a run on the card enters
    (K1, a fit chunk, and a domain launch with its evict rung: a bucketed
    one, K5's, and a legacy chunk under ``DELPHI_DEVICE_TABLE=0``), with
    the device check answering as on the card: the run re-raises the
    injected OOM, counts one refusal and latches nothing, and the next run
    returns the unfaulted frame."""
    monkeypatch.setattr(t_rz, "_run_on_card", lambda: True)
    if site == "domain.weak_label":
        monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    base, _, _ = _planned_run(T, "", False)
    plan = ",".join(f"{site}:{n}:oom" for n in range(1, n_faults + 1))
    with pytest.raises(t_rz.FaultInjected) as exc:
        _planned_run(T, plan, False)
    assert t_rz.classify_fault(exc.value) == "oom"
    assert counters["resilience.degrade.cpu_refused"] == 1
    assert counters["resilience.faults.oom"] == n_faults
    assert "resilience.degrade.cpu_fallback" not in counters
    assert not t_rz.cpu_fallback_active()
    again, _, _ = _planned_run(T, "", False)
    pd.testing.assert_frame_equal(again, base)


def test_run_guarded_raises_run_aborted_at_entry():
    t_rz.request_abort("watchdog stall")
    with pytest.raises(t_rz.RunAborted):
        t_rz.run_guarded("s", lambda: 1)
    t_rz.clear_abort()
    assert t_rz.run_guarded("s", lambda: 1) == 1


def test_provenance_ledger_records_degradation_notes():
    import delphi_tpu_torch.observability.provenance as t_prov
    import delphi_tpu.observability.provenance as j_prov
    notes = []
    for rz, prov in ((j_rz, j_prov), (t_rz, t_prov)):
        led = prov.ProvenanceLedger(":memory:")
        with prov.scoped_ledger(led):
            def thunk():
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

            with pytest.raises(rz.ShrinkBatch):
                rz.run_guarded("domain.score", thunk, can_shrink=True,
                               policy=rz.RetryPolicy(max_retries=0),
                               sleep=lambda s: None)
        notes.append([(n["note"], n["detail"]) for n in led.notes()])
    assert notes[0] == notes[1] == [("resilience.shrink",
                                     "domain.score: oom")]


# -- watchdog checkpoint-and-abort --------------------------------------------

class _FakeRecorder:
    current_phase = "training"
    transition_count = 7

    def active_spans(self):
        return ["repair.run", "training"]


def test_on_watchdog_stall_writes_marker_and_arms_abort(tmp_path):
    os.environ["DELPHI_CHECKPOINT_DIR"] = str(tmp_path)
    t_rz.on_watchdog_stall(_FakeRecorder(), 123.4)
    assert t_rz.abort_requested() is not None
    marker = tmp_path / "stall_abort.json"
    from delphi_tpu.parallel import store as j_store
    data, status = j_store.read_json(
        str(marker), schema="marker", site="store.checkpoint",
        root=str(tmp_path))
    assert status == "ok"
    assert data["idle_s"] == 123.4 and data["transition_count"] == 7


def test_on_watchdog_stall_disabled_without_dir_or_flag():
    t_rz.on_watchdog_stall(_FakeRecorder(), 99.0)
    assert t_rz.abort_requested() is None


def test_stall_abort_flag_overrides(tmp_path):
    os.environ["DELPHI_CHECKPOINT_DIR"] = str(tmp_path)
    os.environ["DELPHI_STALL_ABORT"] = "0"
    t_rz.on_watchdog_stall(_FakeRecorder(), 99.0)
    assert t_rz.abort_requested() is None
    os.environ.pop("DELPHI_CHECKPOINT_DIR")
    os.environ["DELPHI_STALL_ABORT"] = "1"
    t_rz.on_watchdog_stall(_FakeRecorder(), 99.0)
    assert t_rz.abort_requested() is not None


# -- backend-init probe -------------------------------------------------------

def test_probe_backend_times_out_on_wedged_probe():
    with pytest.raises(t_rz.BackendInitTimeout) as e:
        t_rz.probe_backend(deadline_s=0.05, probe=lambda: time.sleep(10))
    assert t_rz.classify_fault(e.value) == "init_timeout"


def test_probe_backend_returns_devices_and_propagates_errors():
    assert t_rz.probe_backend(deadline_s=5.0, probe=lambda: 1) == 1

    def broken():
        raise RuntimeError("UNAVAILABLE: tunnel down")

    with pytest.raises(RuntimeError, match="tunnel down"):
        t_rz.probe_backend(deadline_s=5.0, probe=broken)
    assert t_rz.probe_backend(deadline_s=0, probe=lambda: 1) == 1


def test_probe_backend_honors_fault_plan():
    os.environ["DELPHI_FAULT_PLAN"] = "backend.init:1:init_timeout"
    with pytest.raises(t_rz.FaultInjected) as ei:
        t_rz.probe_backend(deadline_s=5.0, probe=lambda: 1)
    assert t_rz.classify_fault(ei.value) == "init_timeout"
    assert t_rz.probe_backend(deadline_s=5.0, probe=lambda: 1) == 1


def test_init_deadline_reads_env_then_conf():
    from delphi_tpu_torch.session import get_session
    assert t_rz.init_deadline_s() == j_rz.init_deadline_s() == 180.0
    get_session().conf["repair.init.deadline_s"] = "7"
    try:
        assert t_rz.init_deadline_s() == 7.0
        os.environ["DELPHI_INIT_DEADLINE_S"] = "3"
        assert t_rz.init_deadline_s() == 3.0
    finally:
        get_session().conf.pop("repair.init.deadline_s", None)


# -- phase checkpoint store ---------------------------------------------------

def test_phase_checkpoint_roundtrip_and_stale_fingerprint(tmp_path):
    store = t_rz.PhaseCheckpointStore(str(tmp_path), {"content": "abc"})
    assert store.load("detect") is None
    payload = {"cells": pd.DataFrame({"a": [1, 2]}), "stats": np.arange(3),
               "t": torch.arange(4)}
    store.save("detect", payload)
    loaded = store.load("detect")
    pd.testing.assert_frame_equal(loaded["cells"], payload["cells"])
    np.testing.assert_array_equal(loaded["stats"], payload["stats"])
    assert torch.equal(loaded["t"], payload["t"])
    stale = t_rz.PhaseCheckpointStore(str(tmp_path), {"content": "xyz"})
    assert stale.load("detect") is None
    assert counters["resilience.checkpoint.stale"] == 1
    assert store.digest == j_rz.fingerprint_digest({"content": "abc"})


def test_phase_checkpoint_ignores_corrupt_and_wrong_version_files(tmp_path):
    store = t_rz.PhaseCheckpointStore(str(tmp_path), {"content": "abc"})
    path = tmp_path / "phase_detect.pkl"
    path.write_bytes(b"not a pickle")
    assert store.load("detect") is None
    with open(path, "wb") as f:
        pickle.dump({"version": 999, "fingerprint": {"content": "abc"},
                     "payload": 1}, f)
    assert store.load("detect") is None


def test_phase_checkpoint_save_never_raises(tmp_path):
    store = t_rz.PhaseCheckpointStore(
        str(tmp_path / "no" / "\0bad"), {"content": "abc"})
    store.save("detect", {"x": 1})


def test_truncated_checkpoint_counts_corrupt_and_recomputes(tmp_path):
    store = t_rz.PhaseCheckpointStore(str(tmp_path), {"content": "abc"})
    store.save("detect", {"cells": [1, 2, 3]})
    path = tmp_path / "phase_detect.pkl"
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // 2])
    counters.clear()
    assert store.load("detect") is None
    assert counters.get("resilience.checkpoint.corrupt") == 1
    assert counters.get("resilience.faults.store_corrupt") == 1
    assert "resilience.checkpoint.misses" not in counters
    assert (tmp_path / "quarantine").is_dir()


def test_checkpoint_dir_env_then_conf():
    from delphi_tpu_torch.session import get_session
    assert t_rz.checkpoint_dir() is None
    get_session().conf["repair.checkpoint.dir"] = " d1 "
    try:
        assert t_rz.checkpoint_dir() == "d1"
        os.environ["DELPHI_CHECKPOINT_DIR"] = "d2"
        assert t_rz.checkpoint_dir() == "d2"
    finally:
        get_session().conf.pop("repair.checkpoint.dir", None)


# -- request scopes -----------------------------------------------------------

def test_request_scope_plan_is_thread_local():
    scope = t_rz.RequestScope("r1", fault_plan="domain.score:1:oom")
    errors, fired = [], []

    def scoped():
        with t_rz.request_scope(scope):
            try:
                t_rz._maybe_inject("domain.score")
            except t_rz.FaultInjected as e:
                fired.append(e.kind)

    def unscoped():
        try:
            t_rz._maybe_inject("domain.score")
        except BaseException as e:  # failure evidence
            errors.append(e)

    threads = [threading.Thread(target=scoped),
               threading.Thread(target=unscoped)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fired == ["oom"] and errors == []


def test_request_scope_shadows_global_plan():
    os.environ["DELPHI_FAULT_PLAN"] = "xfer.upload:1:oom"
    with t_rz.request_scope(t_rz.RequestScope("r1")):
        t_rz._maybe_inject("xfer.upload")
    with pytest.raises(t_rz.FaultInjected):
        t_rz._maybe_inject("xfer.upload")


def test_scope_deadline_raises_at_seam():
    scope = t_rz.RequestScope("r1", deadline_s=0.0001)
    time.sleep(0.01)
    assert scope.expired()
    with t_rz.request_scope(scope):
        with pytest.raises(t_rz.DeadlineExceeded):
            t_rz.maybe_abort()
    t_rz.maybe_abort()


def test_deadline_exceeded_is_unclassifiable():
    assert t_rz.classify_fault(t_rz.DeadlineExceeded("late")) is None
    assert not isinstance(t_rz.DeadlineExceeded("late"), Exception)


def test_run_guarded_clips_backoff_to_scope_deadline():
    slept, sleep = _fake_clock()
    scope = t_rz.RequestScope("r1", fault_plan="s:1:transient",
                              deadline_s=5.0)
    pol = t_rz.RetryPolicy(max_retries=2, base_s=100.0, cap_s=100.0)
    with t_rz.request_scope(scope):
        with pytest.raises(t_rz.DeadlineExceeded):
            t_rz.run_guarded("s", lambda: 1, policy=pol, sleep=sleep)
    assert slept == []


def test_run_guarded_honors_scope_abort_between_attempts():
    scope = t_rz.RequestScope("r1",
                              fault_plan="s:1:transient,s:2:transient")
    slept = []

    def sleep_and_abort(s):
        slept.append(s)
        scope.request_abort("drain")

    pol = t_rz.RetryPolicy(max_retries=2, base_s=0.0)
    with t_rz.request_scope(scope):
        with pytest.raises(t_rz.RunAborted):
            t_rz.run_guarded("s", lambda: 1, policy=pol,
                             sleep=sleep_and_abort)
    assert len(slept) == 1


def test_scope_cpu_latch_does_not_leak():
    with t_rz.request_scope(t_rz.RequestScope("r1")):
        assert t_rz._latch_cpu_fallback("s")
        assert t_rz.cpu_fallback_active()
    assert not t_rz.cpu_fallback_active()
    assert not t_rz._cpu_latch["active"]


def test_scope_abort_does_not_touch_global_state():
    scope = t_rz.RequestScope("r1")
    scope.request_abort("drain")
    with t_rz.request_scope(scope):
        with pytest.raises(t_rz.RunAborted):
            t_rz.maybe_abort()
    assert t_rz.abort_requested() is None
    t_rz.maybe_abort()


def test_scoped_request_ignores_global_abort():
    t_rz.request_abort("watchdog stall")
    with t_rz.request_scope(t_rz.RequestScope("r1")):
        t_rz.maybe_abort()
    with pytest.raises(t_rz.RunAborted):
        t_rz.maybe_abort()


def test_scope_checkpoint_dir_override(tmp_path):
    os.environ["DELPHI_CHECKPOINT_DIR"] = str(tmp_path / "global")
    scope = t_rz.RequestScope("r1", checkpoint_dir=str(tmp_path / "scoped"))
    with t_rz.request_scope(scope):
        assert t_rz.checkpoint_dir() == str(tmp_path / "scoped")
    assert t_rz.checkpoint_dir() == str(tmp_path / "global")
    with t_rz.request_scope(t_rz.RequestScope("r2", checkpoint_dir="")):
        assert t_rz.checkpoint_dir() is None


# -- the shrink rung at a real site -------------------------------------------

def test_percentile_batch_under_forced_shrink_is_bit_identical():
    """Every launch of detect.percentile OOMs until its retries run out,
    so the pools halve down to single pools; the values equal the
    unfaulted batch's bit for bit and numpy's."""
    rng = np.random.RandomState(3)
    pools = [torch.as_tensor(rng.standard_normal(n) * 10 ** rng.randint(4))
             for n in (5, 17, 1, 64, 33)]
    want = t_detect.percentile_batch(pools, (25.0, 75.0))
    # 1 + 2 retries at the 5-pool launch, then at each half down to size 1
    os.environ["DELPHI_FAULT_PLAN"] = ",".join(
        f"detect.percentile:{i}:oom" for i in range(1, 10))
    got = t_detect.percentile_batch(pools, (25.0, 75.0))
    assert torch.equal(got, want)
    for i, p in enumerate(pools):
        np.testing.assert_array_equal(
            got[i].numpy(), np.percentile(p.numpy(), (25.0, 75.0)))
    assert counters["resilience.degrade.shrink"] >= 1
    assert counters["resilience.faults.oom"] == 9


# -- whole runs under the same plan in both packages --------------------------

def _table():
    rng = np.random.RandomState(0)
    n = 64
    df = pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "c0": rng.choice(["a", "b"], n),
        "c1": rng.choice(["p", "q", "r"], n),
        "c2": rng.choice(["0", "1", "2", "3"], n),
    })
    df.loc[df.index % 9 == 0, "c1"] = None
    return df


def _planned_run(lib, plan, ledger):
    """One NULL repair under ``plan``: (frame, resilience counters, ledger
    notes). The JAX side counts in its recorder's registry."""
    import delphi_tpu.observability.provenance as j_prov
    import delphi_tpu_torch.observability.provenance as t_prov
    os.environ["DELPHI_FAULT_PLAN"] = plan
    rz, prov = (j_rz, j_prov) if lib is J else (t_rz, t_prov)
    rz.reset_fault_state()
    counters.clear()
    led = prov.ProvenanceLedger(":memory:") if ledger else None
    rec = j_obs.start_recording("t") if lib is J else None
    try:
        with prov.scoped_ledger(led):
            frame = lib.delphi.repair.setInput(_table()).setRowId("tid") \
                .setErrorDetectors([lib.NullErrorDetector()]).run()
    finally:
        if rec is not None:
            j_obs.stop_recording(rec)
    got = rec.registry.snapshot()["counters"] if rec is not None \
        else dict(counters)
    notes = [(n["note"], n["detail"]) for n in led.notes()] if led else []
    return frame, {k: v for k, v in got.items()
                   if k.startswith("resilience.")}, notes


# plan -> (ledger on, JAX-only routing settings that make the JAX package
# enter the same site on the CPU)
PLANS = {
    "freq.pair*:1:oom": (False, {}),
    "gbdt.*:1:oom": (False, {}),
    "xfer.upload:1:transfer": (False, {}),
    "freq.pair*:1:oom,freq.pair*:2:oom,freq.pair*:3:oom": (True, {}),
    # the bucketed domain route, both packages' default since slice 9
    "domain.bucket:1:oom": (False, {}),
    "domain.bucket:1:transfer,domain.bucket:2:transfer,"
    "domain.bucket:3:transfer": (True, {}),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_same_plan_gives_equal_frames_counters_and_notes(plan, monkeypatch):
    ledger, jax_env = PLANS[plan]
    base, _, _ = _planned_run(T, "", False)
    for k, v in jax_env.items():
        monkeypatch.setenv(k, v)
    want = _planned_run(J, plan, ledger)
    for k in jax_env:
        monkeypatch.delenv(k)
    got = _planned_run(T, plan, ledger)
    pd.testing.assert_frame_equal(got[0], want[0])
    pd.testing.assert_frame_equal(got[0], base)
    assert got[1] == want[1]
    assert got[1].get("resilience.injected") == plan.count(":oom") \
        + plan.count(":transient") + plan.count(":transfer")
    # the JAX package counts pairs on the CPU under freq.pairs, its XLA
    # route; the port under freq.pairs_pallas, kernel K1's site
    assert got[2] == [(n, d.replace("freq.pairs:", "freq.pairs_pallas:"))
                      for n, d in want[2]]


@pytest.mark.parametrize("site,ledger", [("domain.score", True),
                                         ("domain.weak_label", False)])
def test_domain_plans_fire_in_the_port(site, ledger, monkeypatch):
    """On the legacy domain route (``DELPHI_DEVICE_TABLE=0``) the port
    scores domains under domain.score with a ledger and under
    domain.weak_label without one. On this table the JAX package's legacy
    route enters neither on the CPU (it scores chunks this small in numpy,
    outside the seam; PERF.md lists the difference), so the plan fires in
    the port alone. The frames stay equal."""
    monkeypatch.setenv("DELPHI_DEVICE_TABLE", "0")
    plan = f"{site}:1:transient"
    want = _planned_run(J, plan, ledger)
    got = _planned_run(T, plan, ledger)
    pd.testing.assert_frame_equal(got[0], want[0])
    assert want[1] == {}
    assert got[1] == {"resilience.injected": 1,
                      "resilience.faults.transient": 1,
                      "resilience.retries": 1}


def test_cpu_rung_stamps_the_ledger_and_clears_after_the_phase(
        monkeypatch):
    """Three OOMs at K1 latch the CPU for the rest of 'attr stats' only:
    training's guarded launches run with the latch clear."""
    import delphi_tpu_torch.observability.provenance as t_prov
    seen = []
    orig = t_rz.run_guarded

    def spy(site, thunk, **kw):
        seen.append((site, t_rz.cpu_fallback_active()))
        return orig(site, thunk, **kw)

    for mod in ("delphi_tpu_torch.models.gbdt", "delphi_tpu_torch.ops.freq"):
        monkeypatch.setattr(f"{mod}.run_guarded", spy)
    os.environ["DELPHI_FAULT_PLAN"] = \
        "freq.pair*:1:oom,freq.pair*:2:oom,freq.pair*:3:oom"
    led = t_prov.ProvenanceLedger(":memory:")
    with t_prov.scoped_ledger(led):
        T.delphi.repair.setInput(_table()).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]).run()
    assert counters["resilience.degrade.cpu_fallback"] == 1
    assert [(n["note"], n["detail"]) for n in led.notes()] == [
        ("resilience.cpu_fallback", "freq.pairs_pallas: oom")]
    gbdt = [latched for site, latched in seen if site.startswith("gbdt.")]
    assert gbdt and not any(gbdt)
    assert not t_rz.cpu_fallback_active()
