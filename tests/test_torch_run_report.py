"""The port's run report (``delphi_tpu_torch/observability``) against the
JAX package's on the CPU: the same seeded table (the gauntlet's
``missing_heavy`` shape at 2,000 rows, one GBDT config per target, the
pairwise-stats cap at 4 so both kernels run) goes through both packages
with ``DELPHI_METRICS_PATH`` set. The reports share the schema version and
kind, the span names and nesting, the histogram names and every counter
but the ones listed in :data:`COUNTERS_THAT_DIFFER` with their reason.
With provenance on the scorecards are equal (integer fields exactly,
confidences within the provenance tests' 1e-5); an escalation run's
``escalation`` section and an update delta's ``incremental`` section are
equal (but the snapshot directory's path). Neither package has device
time without a device. Each package's loader and ``report-diff`` read the
other's reports. The observability settings that ran in neither package
before this slice each return the frame of a run without them.
"""

import os
import re
import shutil
import traceback

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import observability as j_obs
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.observability import diff as j_diff
from delphi_tpu.session import get_session as j_session
from delphi_tpu_torch import observability as t_obs
from delphi_tpu_torch.observability import diff as t_diff
from delphi_tpu_torch.parallel.resilience import FaultInjected
from delphi_tpu_torch.session import get_session as t_session

N_ROWS = 2000
OPTIONS = {"model.hp.max_evals": "1",
           "error.max_attrs_to_compute_pairwise_stats": "4"}

# counter -> why the packages count it differently on the same run
COUNTERS_THAT_DIFFER = {
    "compile_cache.*": "jax's persistent compilation cache (its hits follow "
                       "what earlier tests compiled); eager PyTorch compiles "
                       "no executable, and the port's counts are its kernel "
                       "library's builds (deviation D3)",
    "domain.bytes_to_host": "the bytes K5 returns; the JAX package's XLA "
                            "program has no such count",
    # the transfer ledger (deviation D12; every upload reconciled in
    # test_transfer_ledger_matches_jax_but_the_deviation): the port uploads
    # the column codes in error detection, the JAX package in attr stats
    "transfer.phase.error_detection.*": "D12: the port's NULL scan reads "
                                        "the resident column codes",
    "transfer.phase.attr_stats.*": "D12: the JAX package uploads the column "
                                   "codes and its pair index here",
    "transfer.phase.cell_domain_analysis.bytes": "D12: one K5 blob against "
                                                 "the JAX package's operands",
    "transfer.phase.repair_model_training.*": "D12: the port's GBDT slabs "
                                              "go through the ledger",
    "transfer.phase.repairing.*": "D12: the port's predictions upload their "
                                  "bins and trees through the ledger",
    "transfer.calls": "D12: the sum of the phases above",
    "transfer.bytes": "D12: the sum of the phases above",
    "transfer.reuses": "D12: the port's attr stats reuse the codes its "
                       "NULL scan uploaded; the JAX package uploads them "
                       "there",
    "launch.ledger.records": "one record per executed planned launch, and "
                             "the launch counts of `entropy` and "
                             "`gbdt.cv[i]` differ (deviation D6)",
}

_ENV = ("DELPHI_METRICS_PATH", "DELPHI_METRICS_EVENTS", "DELPHI_PROFILE_DIR",
        "DELPHI_TRACE_DIR", "DELPHI_TRACE_SAMPLE", "DELPHI_PLAN_COST",
        "DELPHI_PHASE_HEARTBEAT", "DELPHI_PROVENANCE_PATH",
        "DELPHI_SNAPSHOT_BLOCK_ROWS", "DELPHI_PLAN_DIR")
_CONF = ("repair.metrics.path", "repair.metrics.events", "repair.profile.dir",
         "repair.provenance.path")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    for session in (t_session(), j_session()):
        for k in _CONF:
            if k in session.conf:
                monkeypatch.delitem(session.conf, k)
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def _model(lib, **extra):
    sc = generate_scenario("missing_heavy", N_ROWS, seed=0)
    m = lib.delphi.repair.setInput(sc.dirty).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()])
    for k, v in {**OPTIONS, **extra}.items():
        m = m.option(k, v)
    return m


def _reported(lib, path, model, monkeypatch):
    monkeypatch.setenv("DELPHI_METRICS_PATH", str(path))
    try:
        frame = model.run()
    finally:
        monkeypatch.delenv("DELPHI_METRICS_PATH")
    report = (J if lib is J else T).observability.load_run_report(str(path))
    assert report is not None and report["status"] == "ok"
    return frame, report


# each package's uploads during the plain reported run, by package name:
# (phase, bytes, calling module:function) per ledger entry
UPLOADS = {}


def _spy_uploads(lib, xfer, spans, mp):
    """Records every transfer-ledger entry of ``lib`` with its phase and
    the function outside ``ops/xfer.py`` that uploaded."""
    got = UPLOADS[lib.__name__] = []
    orig = xfer.record_transfer

    def record(nbytes, calls=1):
        # the outermost ops/xfer.py function, and the caller outside it
        entry, site = None, None
        for f in reversed(traceback.extract_stack()[:-1]):
            if f.filename.endswith(os.path.join("ops", "xfer.py")):
                entry = f.name
                continue
            site = f"{os.sep.join(f.filename.split(os.sep)[-2:])}:{f.name}"
            break
        rec = spans.current_recorder()
        got.append((rec.current_phase if rec else None, int(nbytes),
                    f"{entry} {site}"))
        return orig(nbytes, calls)

    mp.setattr(xfer, "record_transfer", record)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """(JAX report, port report, JAX frame, port frame, directory) of the
    plain reported run."""
    from delphi_tpu.observability import spans as j_spans
    from delphi_tpu.ops import xfer as j_xfer
    from delphi_tpu_torch.observability import spans as t_spans
    from delphi_tpu_torch.ops import xfer as t_xfer
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("run_report")
    for v in _ENV:
        mp.delenv(v, raising=False)
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _spy_uploads(J, j_xfer, j_spans, mp)
    _spy_uploads(T, t_xfer, t_spans, mp)
    try:
        jf, jr = _reported(J, root / "jax.json", _model(J), mp)
        tf, tr = _reported(T, root / "port.json", _model(T), mp)
    finally:
        torch.set_num_threads(threads)
        T.set_device(None)
        mp.undo()
    return jr, tr, jf, tf, root


def _differs(key):
    return any(key == k or (k.endswith("*") and key.startswith(k[:-1]))
               for k in COUNTERS_THAT_DIFFER)


def _tree(span):
    return (span["name"], [_tree(c) for c in span["children"]])


def test_frames_equal_and_reports_load(reports):
    jr, tr, jf, tf, _ = reports
    pd.testing.assert_frame_equal(tf, jf)
    assert len(tf) > 0


def test_schema_version_and_kind_equal(reports):
    jr, tr, *_ = reports
    assert tr["schema_version"] == jr["schema_version"] \
        == t_obs.REPORT_SCHEMA_VERSION == j_obs.REPORT_SCHEMA_VERSION
    assert tr["kind"] == jr["kind"] == t_obs.REPORT_KIND
    assert set(tr) == set(jr)


def test_span_names_and_nesting_equal(reports):
    jr, tr, *_ = reports
    assert _tree(tr["spans"]) == _tree(jr["spans"])
    names = [c["name"] for c in tr["spans"]["children"]]
    assert {"attr stats", "cell domain analysis",
            "repair model training"} <= set(names)


def test_counters_equal_but_the_listed_ones(reports):
    jr, tr, *_ = reports
    jc, tc = jr["metrics"]["counters"], tr["metrics"]["counters"]
    got = {k: v for k, v in tc.items() if not _differs(k)}
    want = {k: v for k, v in jc.items() if not _differs(k)}
    differ = {k: (got.get(k), want.get(k))
              for k in sorted(set(got) | set(want))
              if got.get(k) != want.get(k)}
    assert got == want, f"(port, jax): {differ}"
    assert got["detect.null_cells"] > 0 and "stats.pairs_pruned" in got
    # every listed key is one the packages really count differently
    for key in COUNTERS_THAT_DIFFER:
        seen = [k for k in set(jc) | set(tc)
                if key == k or (key.endswith("*")
                                and k.startswith(key[:-1]))]
        assert seen, key


def _ledger(counters):
    """The run's transfer counters: totals and {phase: (calls, bytes)}."""
    phases = {}
    for key, v in counters.items():
        m = re.fullmatch(r"transfer\.phase\.(.+)\.(calls|bytes)", key)
        if m:
            calls, nbytes = phases.get(m.group(1), (0, 0))
            phases[m.group(1)] = (calls + v, nbytes) if m.group(2) == "calls" \
                else (calls, nbytes + v)
    return counters.get("transfer.calls"), counters.get("transfer.bytes"), \
        phases


def test_transfer_ledger_matches_jax_but_the_deviation(reports):
    """Both reports carry the JAX package's transfer ledger: the totals,
    ``transfer.reuses`` and ``transfer.phase.<span>.calls|bytes`` under
    the recorder's span names, each package's counters the sum of its
    uploads. The uploads reconcile with the JAX package's as deviation
    D12 of ``ROADMAP.md`` says: the same column-code uploads (one per
    column, 4 bytes a row), in error detection on the port (its NULL scan
    reads the resident codes) and in attr stats in the JAX package (its
    CPU detection stays on the host); the JAX package's pair-index upload
    for its XLA pair counts (8 bytes a pair), which K1 takes in its
    parameter table; one domain upload each (the port's one K5 blob, of
    other bytes); and the port's GBDT uploads (slabs, bins, trees),
    which the JAX package makes outside its ledger."""
    jr, tr, *_ = reports
    jc, tc = jr["metrics"]["counters"], tr["metrics"]["counters"]
    sanitize = lambda s: re.sub(r"[^A-Za-z0-9_.-]+", "_", s)  # noqa: E731
    spans = set()
    stack = [tr["spans"]]
    while stack:
        span = stack.pop()
        spans.add(sanitize(span["name"]))
        stack.extend(span["children"])
    for counters, lib in ((jc, J), (tc, T)):
        ups = UPLOADS[lib.__name__]
        calls, nbytes, phases = _ledger(counters)
        assert (calls, nbytes) == (len(ups), sum(b for _, b, _ in ups))
        assert sum(c for c, _ in phases.values()) == calls
        assert sum(b for _, b in phases.values()) == nbytes
        want = {}
        for phase, b, _ in ups:
            c0, b0 = want.get(sanitize(phase), (0, 0))
            want[sanitize(phase)] = (c0 + 1, b0 + b)
        assert phases == want
        assert counters["transfer.reuses"] > 0
    assert set(_ledger(tc)[2]) <= spans

    def sites(lib, phase=None, site=None):
        return sorted(b for p, b, s in UPLOADS[lib.__name__]
                      if (phase is None or p == phase)
                      and (site is None or site in s))

    codes_t = sites(T, site="device_codes ")
    codes_j = sites(J, site="device_codes ")
    assert codes_t == codes_j == [4 * N_ROWS] * len(codes_j) and codes_j
    assert codes_t == sites(T, phase="error detection")
    pair_index = sites(J, site="to_device ops/freq.py:compute_freq_stats")
    assert len(pair_index) == 1 and pair_index[0] % 8 == 0
    assert sorted(codes_j + pair_index) == sites(J, phase="attr stats")
    assert not sites(T, phase="attr stats")
    assert len(sites(T, phase="cell domain analysis")) \
        == len(sites(J, phase="cell domain analysis")) == 1
    gbdt = [u for u in UPLOADS["delphi_tpu_torch"]
            if u[0] in ("repair model training", "repairing")]
    assert gbdt and all(s.startswith("to_device models/gbdt.py:")
                        for _, _, s in gbdt)
    assert len(UPLOADS["delphi_tpu_torch"]) == len(codes_t) + 1 + len(gbdt)
    assert len(UPLOADS["delphi_tpu"]) == len(codes_j) + 2


def test_gauge_and_histogram_names_equal(reports):
    jr, tr, *_ = reports
    jg = {k for k in jr["metrics"]["gauges"]
          if not k.startswith(("compile_cache.", "device."))}
    tg = {k for k in tr["metrics"]["gauges"] if not k.startswith("device.")}
    assert tg == jg
    assert set(tr["metrics"]["histograms"]) \
        == {k for k in jr["metrics"]["histograms"]
            if not k.startswith("compile_cache.")}
    for name in ("pipeline.input_rows", "detect.noisy_cells",
                 "stats.candidate_pairs", "repair.dirty_rows"):
        assert tr["metrics"]["gauges"][name] == jr["metrics"]["gauges"][name]


def test_device_time_null_on_both_without_a_device(reports):
    jr, tr, *_ = reports
    assert jr["device_time"] is None and tr["device_time"] is None
    assert tr["per_process"] is None and tr["dist"] is None
    assert tr["env"]["backend"] == "cpu" and tr["env"]["process_count"] == 1


def test_run_section_equal(reports):
    jr, tr, *_ = reports
    drop = ("elapsed_s",)
    assert {k: v for k, v in tr["run"].items() if k not in drop} \
        == {k: v for k, v in jr["run"].items() if k not in drop}
    assert tr["run"]["mode"] == "repair_candidates"


def _assert_cards_close(got, want):
    """Integer and string fields equal; floats (confidence sums, extrema,
    means) within the provenance tests' 1e-5."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_cards_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_cards_close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-5)
    else:
        assert got == want


def test_escalation_scorecards_and_section_equal(tmp_path, monkeypatch):
    """An escalation run with provenance on: equal frames, scorecards and
    ``escalation`` sections."""
    monkeypatch.setenv("DELPHI_PROVENANCE_PATH", ":memory:")
    out = []
    for lib in (J, T):
        m = _model(lib, **{"repair.escalate": "true"})
        out.append(_reported(lib, tmp_path / f"{lib.__name__}.json", m,
                             monkeypatch))
    (jf, jr), (tf, tr) = out
    pd.testing.assert_frame_equal(tf, jf)
    assert jr["scorecards"] and set(tr["scorecards"]) == set(jr["scorecards"])
    _assert_cards_close(tr["scorecards"], jr["scorecards"])
    assert tr["escalation"] == jr["escalation"]
    assert tr["escalation"]["requested"] is True
    assert tr["run"]["escalation"] == tr["escalation"]


def test_incremental_section_equal(tmp_path, monkeypatch):
    """An update delta (``c2`` rewritten in one 256-row block, as in
    ``tests/test_torch_incremental.py``): equal ``incremental`` sections
    but the snapshot directory."""
    monkeypatch.setenv("DELPHI_SNAPSHOT_BLOCK_ROWS", "256")
    base, _ = bench._incremental_frames(N_ROWS)
    updated = base.copy()
    rows = np.arange(512, 768)
    updated.loc[rows, "c2"] = [str((i * 3) % 5) for i in rows]
    dc = "t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)"
    sections = []
    for lib in (J, T):
        snap = str(tmp_path / f"snap_{lib.__name__}")

        def model(frame, lib=lib, snap=snap):
            return lib.delphi.repair.setInput(frame.copy()).setRowId("tid") \
                .setErrorDetectors([lib.NullErrorDetector(),
                                    lib.ConstraintErrorDetector(
                                        constraints=dc)]) \
                .option("repair.incremental", "true") \
                .option("repair.snapshot.dir", snap)

        model(base).run()
        _, report = _reported(lib, tmp_path / f"{lib.__name__}.json",
                              model(updated), monkeypatch)
        sections.append(report["incremental"])
    js, ts = sections
    assert ts["mode"] == "delta" and ts["rows_updated"] == 256
    assert ts["snapshot_dir"].endswith("snap_delphi_tpu_torch")
    drop = ("snapshot_dir",)
    assert {k: v for k, v in ts.items() if k not in drop} \
        == {k: v for k, v in js.items() if k not in drop}


# -- cross-loading -------------------------------------------------------------

def test_each_loader_reads_the_other_packages_report(reports):
    jr, tr, _, _, root = reports
    from_jax = t_obs.load_run_report(str(root / "jax.json"))
    from_port = j_obs.load_run_report(str(root / "port.json"))
    assert from_jax == jr and from_port == tr
    assert from_jax["env"]["backend"] == "cpu"


def test_upgrade_of_an_old_report_equals_jax():
    old = {"schema_version": 2, "kind": t_obs.REPORT_KIND, "status": "ok",
           "metrics": {"counters": {"a": 1}}, "spans": {"name": "r",
                                                        "children": []}}
    assert t_obs.upgrade_run_report(dict(old)) \
        == j_obs.upgrade_run_report(dict(old))


@pytest.mark.parametrize("direction", ["jax-port", "port-jax"])
def test_report_diff_reads_both_packages(reports, capsys, direction):
    jr, tr, _, _, root = reports
    a, b = ("jax.json", "port.json") if direction == "jax-port" \
        else ("port.json", "jax.json")
    argv = [str(root / a), str(root / b)]
    assert t_diff.main(argv) == 0
    got = capsys.readouterr().out
    assert j_diff.main(argv) == 0
    want = capsys.readouterr().out
    # equal metric deltas; the phase walls differ run to run
    assert got.split("phase wall time")[0] == want.split("phase wall time")[0]
    assert "counters (" in got
    base, cur = (jr, tr) if direction == "jax-port" else (tr, jr)
    assert t_diff.build_report_diff(base, cur)["metrics"] \
        == j_diff.build_report_diff(base, cur)["metrics"]


def test_report_diff_of_a_missing_file_exits_2(tmp_path, reports):
    _, _, _, _, root = reports
    assert t_diff.main([str(root / "jax.json"), str(tmp_path / "x.json")]) \
        == 2


# -- the settings that left the unported list -----------------------------------

# case -> (environment, session conf, check of (tmp dir, captured stderr))
SETTINGS = {
    "run report env": ({"DELPHI_METRICS_PATH": "r.json"}, {},
                       lambda d, err: (d / "r.json").exists()),
    "run report conf": ({}, {"repair.metrics.path": "r.json"},
                        lambda d, err: (d / "r.json").exists()),
    "plan cost": ({"DELPHI_PLAN_COST": "1"}, {}, None),
    "trace dir": ({"DELPHI_TRACE_DIR": "traces",
                   "DELPHI_METRICS_PATH": "r.json"}, {},
                  lambda d, err: any((d / "traces").glob("trace.*.json"))),
    "trace sample": ({"DELPHI_TRACE_SAMPLE": "0.5"}, {}, None),
    "profile dir env": ({"DELPHI_PROFILE_DIR": "prof"}, {},
                        lambda d, err: any((d / "prof").glob("*.json"))),
    "profile dir conf": ({}, {"repair.profile.dir": "prof"},
                         lambda d, err: any((d / "prof").glob("*.json"))),
    "metrics events env": ({"DELPHI_METRICS_EVENTS": "1",
                            "DELPHI_METRICS_PATH": "r.json"}, {},
                           lambda d, err: (d / "r.json.events.jsonl")
                           .read_text().count("span_enter") >= 4),
    "metrics events conf": ({"DELPHI_METRICS_PATH": "r.json"},
                            {"repair.metrics.events": "yes"},
                            lambda d, err: (d / "r.json.events.jsonl")
                            .exists()),
    "phase heartbeat": ({"DELPHI_PHASE_HEARTBEAT": "on"}, {},
                        lambda d, err: re.search(
                            r"^PHASE>> \S+ input validation$", err, re.M)
                        and re.search(r"^PHASE<< \S+ attr stats \(", err,
                                      re.M)),
}


def _tiny():
    return pd.DataFrame({
        "tid": range(60),
        "a": [f"a{i % 3}" for i in range(60)],
        "b": [None if i % 9 == 0 else f"b{i % 3}" for i in range(60)],
        "c": [f"c{i % 2}" for i in range(60)],
    })


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_observability_settings_return_the_plain_frame(
        case, tmp_path, monkeypatch, capfd):
    """Each setting (left ``UNPORTED`` in ``tests/test_torch_pipeline.py``
    with this slice) runs, detect-only and full, and returns the frame of
    a run without it; its artifact is where the JAX package puts it."""
    def run(detect_only):
        return T.delphi.repair.setInput(_tiny()).setRowId("tid") \
            .setErrorDetectors([T.NullErrorDetector()]) \
            .option("model.hp.max_evals", "1") \
            .run(detect_errors_only=detect_only)

    want = [run(d) for d in (True, False)]
    env, conf, check = SETTINGS[case]
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k, v in conf.items():
        monkeypatch.setitem(t_session().conf, k, v)
    capfd.readouterr()
    for detect_only, frame in zip((True, False), want):
        pd.testing.assert_frame_equal(run(detect_only), frame)
    err = capfd.readouterr().err
    assert len(want[0]) > 0
    if check is not None:
        assert check(tmp_path, err)
    if "r.json" in str(env) + str(conf):
        report = t_obs.load_run_report(str(tmp_path / "r.json"))
        assert report["status"] == "ok" and report["device_time"] is None


def test_profiled_cpu_run_reports_no_device_time(tmp_path, monkeypatch):
    """A profiled run on the CPU has no device records: the report's
    ``device_time`` stays null, the trace is written once."""
    monkeypatch.setenv("DELPHI_PROFILE_DIR", str(tmp_path / "prof"))
    frame, report = _reported(T, tmp_path / "r.json", _model(T),
                              monkeypatch)
    assert len(frame) > 0
    assert report["device_time"] is None
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_failed_run_writes_an_error_report(tmp_path, monkeypatch):
    """A report never masks the run's outcome: the error propagates, and
    the report says so."""
    monkeypatch.setenv("DELPHI_METRICS_PATH", str(tmp_path / "r.json"))
    monkeypatch.setenv("DELPHI_FAULT_PLAN", "gbdt.*:1:fatal")
    with pytest.raises(FaultInjected):
        _model(T).run()
    monkeypatch.delenv("DELPHI_FAULT_PLAN")
    report = t_obs.load_run_report(str(tmp_path / "r.json"))
    assert report["status"] == "error" and report["error"]
    assert t_obs.current_recorder() is None


def test_trace_dir_run_exports_one_trace_with_the_run_spans(
        tmp_path, monkeypatch):
    from delphi_tpu_torch.observability import trace as t_trace
    monkeypatch.setenv("DELPHI_TRACE_DIR", str(tmp_path / "traces"))
    frame, report = _reported(T, tmp_path / "r.json", _model(T),
                              monkeypatch)
    tid = report["trace"]["trace_id"]
    assert t_trace.list_traces(str(tmp_path / "traces")) == [tid]
    doc = t_trace.load_trace(tid, str(tmp_path / "traces"))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"attr stats", "repair model training"} <= names
    assert report["metrics"]["counters"]["trace.spans"] >= 6
    shutil.rmtree(tmp_path / "traces")
    assert os.path.exists(tmp_path / "r.json")
