"""The port's batch CLI (``python -m delphi_tpu_torch.main``) against the JAX
package's (``delphi_tpu.main``) on the CPU: the default run,
``--detect-only``, ``--repair-data``, ``--constraints``, ``--targets`` and
``--chunksize`` write equal CSVs; ``--escalate`` (with
``--escalate-conf`` / ``--escalate-budget``) and ``--provenance-out`` write
equal CSVs and ledger files on the escalation fixture (the port repairing
with the JAX package's models, as ``tests/test_torch_escalate.py`` explains);
``--incremental``, ``--snapshot-dir`` and ``--stream`` write equal CSVs and
``--fsck`` / ``--fsck-report-only`` give equal exit codes and summaries;
``--checkpoint-dir`` and ``--fault-plan`` write equal CSVs, and an
injected ``crash`` exits with code 23 in both; ``--pipeline`` and
``--compile-cache-dir`` write equal CSVs and ``--plan-report`` prints
equal reports of the JAX package's ledgers; ``--metrics-port`` writes the
JAX package's CSV with the live plane serving during the run; ``--serve``
(with ``--serve-port`` and ``--serve-cache-dir``) answers ``/healthz`` and
a ``POST /repair`` with the JAX package's frame, ``--fleet 2`` (with and
without ``--autoscale``) routes that request to a worker process;
``--gauntlet`` (with ``--gauntlet-rows``, ``--gauntlet-scenarios``,
``--metrics-out``, and ``--gauntlet-no-repairs`` with
``--baseline-report`` / ``--drift-fail-over``) gives the JAX CLI's exit
codes, per-scenario lines, stdout JSON and report section.

Both CLIs run in this process (``main(argv)``); one case also runs the
port as ``python -m`` in a subprocess. The input has only string columns
and a NULL-free integer column, so every repair is a classification and
the packages' CSVs are byte-identical.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import delphi_tpu_torch as T
from delphi_tpu import main as j_main
from delphi_tpu_torch import main as t_main
from delphi_tpu_torch import observability as t_obs
from delphi_tpu.session import get_session as j_session
from delphi_tpu_torch.parallel import store as t_store
from delphi_tpu_torch.session import get_session as t_session

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu_device(session):
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)
    for name in list(t_session().table_names()):
        t_session().drop(name)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    n = 400
    city = rng.randint(0, 12, n)
    df = pd.DataFrame({
        "tid": range(n),
        "city": [f"c{v}" for v in city],
        "state": [f"s{v % 6}" for v in city],
        "channel": [f"h{v}" for v in rng.randint(0, 3, n)],
        "zone": city // 4,
    })
    df.loc[rng.rand(n) < 0.06, "state"] = None
    df.loc[rng.rand(n) < 0.06, "channel"] = None
    swap = rng.rand(n) < 0.03
    df.loc[swap, "state"] = [f"s{v}" for v in rng.randint(0, 6, swap.sum())]
    df.to_csv(root / "in.csv", index=False)
    (root / "dc.txt").write_text("city->state\n")
    return root


def _run_both(inputs, tmp_path, *flags):
    """Runs both CLIs on the same arguments; returns the two CSVs' text."""
    out = []
    for name, main in (("jax", j_main.main), ("torch", t_main.main)):
        path = tmp_path / f"{name}.csv"
        argv = ["--input", str(inputs / "in.csv"), "--row-id", "tid",
                "--output", str(path)]
        for f in flags:
            argv.append(str(inputs / f) if f == "dc.txt" else f)
        assert main(argv) == 0
        out.append(path.read_text())
    return out


@pytest.mark.parametrize("flags", [
    (), ("--detect-only",), ("--repair-data",),
    ("--constraints", "dc.txt"), ("--targets", "state"),
    ("--chunksize", "64"), ("--chunksize", "150", "--dtype", "str"),
    ("--constraints", "dc.txt", "--repair-data", "--chunksize", "100"),
], ids=lambda f: "-".join(x.strip("-") for x in f) or "default")
def test_cli_csv_matches_jax(inputs, tmp_path, flags):
    want, got = _run_both(inputs, tmp_path, *flags)
    assert len(got.splitlines()) > 1
    assert got == want


def test_cli_as_module_matches_in_process(inputs, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DELPHI_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = tmp_path / "sub.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "delphi_tpu_torch.main", "--input",
         str(inputs / "in.csv"), "--row-id", "tid", "--output", str(out),
         "--constraints", str(inputs / "dc.txt")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote" in proc.stderr
    want = tmp_path / "in_process.csv"
    assert t_main.main(["--input", str(inputs / "in.csv"), "--row-id", "tid",
                        "--output", str(want), "--constraints",
                        str(inputs / "dc.txt")]) == 0
    assert out.read_text() == want.read_text()


GAUNTLET_ARGS = ["--gauntlet", "--gauntlet-rows", "160",
                 "--gauntlet-scenarios", "fd_categorical,correlated_multi"]


def _captured(main, argv):
    """(exit code, stdout, stderr) of ``main(argv)`` in this process."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def gauntlet_runs(tmp_path_factory):
    """Both CLIs' ``--gauntlet`` on the two cheapest scenarios that launch
    K1, K2 and K5 (160 rows, the size of the JAX package's gauntlet smoke),
    each writing its run report, then ``--gauntlet-no-repairs`` against
    that report with ``--drift-fail-over 0.25``. The port runs once more
    repairing with the JAX run's trees (``from_state``): at this size the
    CV search's trees tie in the last ulp, which moves posteriors (the
    scorecards' confidences) though no repair."""
    from test_torch_provenance import carry_jax_models
    root = tmp_path_factory.mktemp("gauntlet")
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            carry_jax_models(mp)
            for name, main in (("jax", j_main.main),
                               ("jax_trees", t_main.main)):
                report = root / f"{name}.json"
                runs[name] = {"healthy": _captured(
                    main, GAUNTLET_ARGS + ["--metrics-out", str(report)]),
                    "report": t_obs.load_run_report(str(report))}
        runs["torch"] = {}
        for name, main in (("jax", j_main.main), ("torch", t_main.main)):
            report = root / f"{name}.json"
            if name == "torch":
                runs[name]["healthy"] = _captured(
                    main, GAUNTLET_ARGS + ["--metrics-out", str(report)])
                runs[name]["report"] = t_obs.load_run_report(str(report))
            runs[name]["degraded"] = _captured(main, GAUNTLET_ARGS + [
                "--gauntlet-no-repairs", "--baseline-report", str(report),
                "--drift-fail-over", "0.25"])
    finally:
        torch.set_num_threads(threads)
        T.set_device(None)
    return runs["jax"], runs["torch"], runs["jax_trees"]


def _scenario_lines(stderr):
    return [ln for ln in stderr.splitlines()
            if ln.startswith("gauntlet ") and ": f1=" in ln]


def _section(report, cards=False):
    """A run report's ``gauntlet`` section without its walls, and with
    only (``cards``) or without each scenario's scorecards."""
    section = json.loads(json.dumps(report["gauntlet"]))
    scenarios = section["scenarios"]
    for name, s in scenarios.items():
        s.pop("elapsed_s")
        if cards:
            scenarios[name] = {k: s[k] for k in ("scorecards",
                                                 "scorecard_summary")}
        else:
            s.pop("scorecards")
            s.pop("scorecard_summary")
    return section


def _assert_close(got, want, tol, path=""):
    """Equal structure, ints and strings; floats within ``tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("part", [
    "exit_codes", "scenario_lines", "stdout_json", "report_section",
    "report_metrics", "degraded_gate"])
def test_gauntlet_flags_match_jax(gauntlet_runs, part):
    want, got, jax_trees = gauntlet_runs
    if part == "exit_codes":
        assert got["healthy"][0] == want["healthy"][0] == 0
        assert got["degraded"][0] == want["degraded"][0] == 3
    elif part == "scenario_lines":
        lines = _scenario_lines(got["healthy"][2])
        assert len(lines) == 2
        assert lines == _scenario_lines(want["healthy"][2])
    elif part == "stdout_json":
        out = json.loads(got["healthy"][1].strip().splitlines()[-1])
        assert out == json.loads(want["healthy"][1].strip().splitlines()[-1])
        assert out["mode"] == "gauntlet" and out["rows"] == 160
        assert sorted(out["scenarios"]) == ["correlated_multi",
                                            "fd_categorical"]
    elif part == "report_section":
        section = _section(got["report"])
        assert section == _section(want["report"])
        # the posteriors behind the scorecards, with the JAX run's trees
        _assert_close(_section(jax_trees["report"], cards=True),
                      _section(want["report"], cards=True), 1e-5)
        assert _section(jax_trees["report"]) == section
        assert got["report"]["run"] == want["report"]["run"] == {
            "mode": "gauntlet",
            "scenarios": ["correlated_multi", "fd_categorical"]}
    elif part == "report_metrics":
        def gauntlet_metrics(report):
            m = report["metrics"]
            return {kind: {k: v for k, v in m[kind].items()
                           if k.startswith("gauntlet.")}
                    for kind in ("counters", "gauges")}
        metrics = gauntlet_metrics(got["report"])
        assert metrics == gauntlet_metrics(want["report"])
        assert metrics["counters"]["gauntlet.scenarios"] == 2
    else:
        out = json.loads(got["degraded"][1].strip().splitlines()[-1])
        assert out == json.loads(
            want["degraded"][1].strip().splitlines()[-1])
        assert out["drift"]["failed"] is True
        assert out["repairs_enabled"] is False
        assert "gauntlet drift gate FAILED" in got["degraded"][2]


@pytest.fixture(scope="module")
def served_want(inputs):
    """The served frame the JAX package's ``run()`` implies for in.csv:
    sorted by all columns, through ``to_json(orient="records")``."""
    from delphi_tpu import NullErrorDetector, delphi
    df = pd.read_csv(inputs / "in.csv")
    out = delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([NullErrorDetector()]).run()
    out = out.sort_values(list(out.columns)).reset_index(drop=True)
    split = json.loads(df.to_json(orient="split"))
    table = {c: [row[i] for row in split["data"]]
             for i, c in enumerate(split["columns"])}
    return table, json.loads(out.to_json(orient="records"))


def _http(port, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if body is None
        else "POST", data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=240) as r:
        return r.status, json.loads(r.read())


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("flag", ["--serve", "--serve-port",
                                  "--serve-cache-dir", "--fleet",
                                  "--autoscale"])
def test_serving_flags_serve_the_jax_frame(inputs, tmp_path, monkeypatch,
                                           served_want, flag):
    """``main(argv)`` runs the service (or the fleet) on this thread; the
    entry point's signal-handler hook is replaced by one that exercises
    the started server from a thread and then drains it, as SIGTERM would.
    ``/healthz`` answers, and a ``POST /repair`` of in.csv answers the JAX
    package's frame. Fleet workers are ``python -m delphi_tpu_torch.main
    --serve`` processes on the CPU."""
    from delphi_tpu_torch.observability import fleet, serve

    table, want = served_want
    cache = tmp_path / "cache"
    port = _free_port() if flag == "--serve-port" else 0
    argv = ["--serve", "--serve-port", str(port)]
    if flag == "--serve-cache-dir":
        argv += ["--serve-cache-dir", str(cache)]
    if flag in ("--fleet", "--autoscale"):
        argv = ["--fleet", "2", "--serve-port", "0", "--serve-cache-dir",
                str(cache)] + (["--autoscale"] if flag == "--autoscale"
                               else [])
        for key, value in (("DELPHI_TORCH_DEVICE", "cpu"),
                           ("OMP_NUM_THREADS", "1"),
                           ("DELPHI_FLEET_HEARTBEAT_S", "0.5"),
                           ("DELPHI_COMPILE_CACHE_DIR", str(cache / "cc"))):
            monkeypatch.setenv(key, value)
    else:
        # RepairServer.start arms the build cache in the environment
        monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(cache / "cc"))
    scalers = []

    class _Scaler(fleet.FleetAutoscaler):
        def start(self):
            scalers.append(self)
            return super().start()

    monkeypatch.setattr(fleet, "FleetAutoscaler", _Scaler)
    seen = {}

    def exercise(target):
        try:
            seen["port"] = target.port
            seen["health"] = _http(target.port, "/healthz")
            seen["repair"] = _http(target.port, "/repair",
                                   {"table": table, "row_id": "tid"})
            seen["cache"] = target.cache_dir
        except BaseException as e:
            seen["error"] = e
        finally:
            if isinstance(target, fleet.FleetRouter):
                target.drain()
            else:
                target.drain(grace_s=10)

    def hook(target):
        import threading
        threading.Thread(target=exercise, args=(target,),
                         daemon=True).start()

    monkeypatch.setattr(serve, "install_signal_handlers", hook)
    monkeypatch.setattr(fleet, "install_signal_handlers", hook)
    assert t_main.main(argv) == 0
    assert "error" not in seen, seen.get("error")
    status, health = seen["health"]
    assert status == 200 and health["status"] == "ok"
    status, body = seen["repair"]
    assert status == 200 and body["frame"] == want
    if flag == "--serve-port":
        assert seen["port"] == port
    if flag in ("--serve-cache-dir", "--fleet", "--autoscale"):
        assert seen["cache"] == str(cache)
        assert (cache / "plans").is_dir() and (cache / "models").is_dir()
    if flag in ("--fleet", "--autoscale"):
        assert sorted(health["live"]) == ["0", "1"]
        assert body["worker_id"] in ("0", "1") and body["hops"] == 1
    assert len(scalers) == (flag == "--autoscale")


@pytest.mark.parametrize("flags", [
    ("--metrics-port", "0"), ("--metrics-port", "0", "--detect-only"),
], ids=["repair", "detect-only"])
def test_metrics_port_flag_matches_jax(inputs, tmp_path, flags, monkeypatch):
    """``--metrics-port`` (slice 14; it raised before) writes the JAX
    package's CSV while the live plane serves ``/healthz`` on the bound
    port; the setting reaches the session conf for the invocation only,
    and the plane's threads are joined when the CLI returns (the JAX CLI
    keeps the port in its session, so the test restores that)."""
    import urllib.request
    from delphi_tpu_torch.observability import live
    monkeypatch.setitem(j_session().conf, "repair.metrics.port", "")
    planes, health = [], []
    orig_start = live.LivePlane.start

    def start(plane):
        orig_start(plane)
        planes.append(plane)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{plane.port}/healthz", timeout=5) as r:
            health.append(json.loads(r.read()))

    monkeypatch.setattr(live.LivePlane, "start", start)
    want, got = _run_both(inputs, tmp_path, *flags)
    assert got == want and len(got.splitlines()) > 1
    assert len(planes) == 1 and planes[0].port > 0
    assert health[0]["status"] == "ok"
    assert planes[0].threads == []
    assert t_session().conf.get("repair.metrics.port") is None


@pytest.mark.parametrize("value", ["5", "0"])
def test_collective_timeout_flag_runs(inputs, tmp_path, value, monkeypatch):
    """``--collective-timeout-s`` (slice 11) writes the JAX package's CSV;
    its deadline reaches the run's session conf for the invocation only
    (the JAX CLI keeps it in its session, so the test restores that)."""
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu_torch.parallel import dist_resilience
    from delphi_tpu_torch.parallel import resilience as t_rz
    seen = []
    orig = t_rz.maybe_abort

    def spy():
        seen.append(dist_resilience.collective_timeout_s())
        return orig()

    monkeypatch.setattr(t_rz, "maybe_abort", spy)
    monkeypatch.setitem(j_session().conf, "repair.collective.timeout_s", "")
    want, got = _run_both(inputs, tmp_path, "--collective-timeout-s", value)
    assert got == want and len(got.splitlines()) > 1
    assert seen and set(seen) == {float(value)}
    assert t_session().conf.get("repair.collective.timeout_s") is None


@pytest.fixture
def _restore_plane_conf():
    """The JAX CLI leaves its flags' settings in its session conf, and its
    compile plane points jax's persistent cache at the flag's directory."""
    import jax
    keys = ("repair.compile.cache_dir", "repair.pipeline.enabled")
    prior = {k: j_session().conf.get(k) for k in keys}
    old_dir = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    for k, v in prior.items():
        if v is None:
            j_session().conf.pop(k, None)
        else:
            j_session().conf[k] = v


@pytest.mark.parametrize("flags", [
    ("--pipeline", "on"), ("--pipeline", "off"), ("--pipeline", "auto"),
    ("--compile-cache-dir", "{d}"),
    ("--pipeline", "on", "--compile-cache-dir", "{d}", "--repair-data"),
], ids=["pipeline-on", "pipeline-off", "pipeline-auto", "compile-cache-dir",
        "both"])
def test_plane_flags_match_jax(inputs, tmp_path, flags, monkeypatch,
                               _restore_plane_conf):
    """``--pipeline`` and ``--compile-cache-dir`` write the JAX package's
    CSV, and their settings reach the run through the session conf only
    for the invocation; ``--pipeline on`` runs the pipeline thread."""
    from delphi_tpu_torch.parallel import pipeline
    from delphi_tpu_torch.utils import counters
    seen = []
    orig = pipeline.enabled

    def spy():
        seen.append((orig(), t_session().conf.get("repair.compile.cache_dir")))
        return seen[-1][0]

    monkeypatch.setattr(pipeline, "enabled", spy)
    counters.clear()
    want, got = _run_both(inputs, tmp_path,
                          *[f.format(d=tmp_path / "cc") for f in flags])
    assert got == want
    on = "on" in flags
    assert seen and all(s[0] is on for s in seen)
    if "--compile-cache-dir" in flags:
        assert all(s[1] == str(tmp_path / "cc") for s in seen)
    assert bool(counters.get("pipeline.runs")) is on
    assert t_session().conf.get("repair.pipeline.enabled") is None
    assert t_session().conf.get("repair.compile.cache_dir") is None


def test_plan_report_matches_jax_on_jax_ledgers(inputs, tmp_path,
                                                monkeypatch, capsys):
    """``--plan-report ROOT`` prints what the JAX package prints for the
    launch-cost ledgers its runs persisted (under ROOT or ROOT/plans); on
    the port's own plans directory it reports plans but no ledger (the port
    writes none until queue 1 item 10)."""
    plans = tmp_path / "serve" / "plans"
    monkeypatch.setenv("DELPHI_PLAN_DIR", str(plans))
    assert j_main.main(["--input", str(inputs / "in.csv"), "--row-id", "tid",
                        "--output", str(tmp_path / "j.csv"), "--metrics-out",
                        str(tmp_path / "r.json")]) == 0
    assert list(plans.glob("ledger.*.json"))
    capsys.readouterr()
    for root in (plans, tmp_path / "serve"):
        assert j_main.main(["--plan-report", str(root)]) == 0
        want = capsys.readouterr().out
        assert t_main.main(["--plan-report", str(root)]) == 0
        got = capsys.readouterr().out
        assert got == want
        report = json.loads(got)
        assert report["ledgers"] >= 1 and report["buckets"]
    own = tmp_path / "own"
    monkeypatch.setenv("DELPHI_PLAN_DIR", str(own))
    assert t_main.main(["--input", str(inputs / "in.csv"), "--row-id", "tid",
                        "--output", str(tmp_path / "t.csv")]) == 0
    assert [p.name for p in own.iterdir()
            if not p.name.startswith("ledger.")]
    capsys.readouterr()
    assert t_main.main(["--plan-report", str(own)]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "root": str(own), "ledgers": 0, "buckets": []}


@pytest.fixture
def _restore_jax_conf():
    """The JAX CLI leaves the settings of its flags in its session conf."""
    keys = ("repair.checkpoint.dir", "repair.fault.plan")
    prior = {k: j_session().conf.get(k) for k in keys}
    yield
    for k, v in prior.items():
        if v is None:
            j_session().conf.pop(k, None)
        else:
            j_session().conf[k] = v


@pytest.mark.parametrize("flags", [
    ("--checkpoint-dir", "{d}"),
    ("--fault-plan", "freq.pair*:1:oom"),
    ("--fault-plan", "gbdt.*:1:transient,xfer.upload:2:transfer"),
    ("--fault-plan", "store.checkpoint:1:torn_write", "--checkpoint-dir",
     "{d}"),
], ids=["checkpoint-dir", "fault-plan-pairs", "fault-plan-gbdt-upload",
        "torn-checkpoint"])
def test_checkpoint_and_fault_plan_flags_match_jax(inputs, tmp_path, flags,
                                                   _restore_jax_conf):
    """Each package writes its own checkpoint directory; the CSVs equal
    each other and an unflagged run's, and a second port run with the same
    directory resumes both phases (a torn detect checkpoint reads as
    corrupt and is recomputed)."""
    from delphi_tpu.parallel import resilience as j_rz
    from delphi_tpu_torch.parallel import resilience as t_rz
    from delphi_tpu_torch.utils import counters
    plain = tmp_path / "plain.csv"
    assert t_main.main(["--input", str(inputs / "in.csv"), "--row-id", "tid",
                        "--output", str(plain)]) == 0
    out = []
    for name, main, rz in (("jax", j_main.main, j_rz),
                           ("torch", t_main.main, t_rz)):
        rz.reset_fault_state()
        path = tmp_path / f"{name}.csv"
        argv = ["--input", str(inputs / "in.csv"), "--row-id", "tid",
                "--output", str(path)]
        argv += [f.format(d=tmp_path / f"ckpt_{name}") for f in flags]
        assert main(argv) == 0
        out.append(path.read_text())
    assert out[1] == out[0] == plain.read_text()
    assert t_session().conf.get("repair.fault.plan") is None
    assert t_session().conf.get("repair.checkpoint.dir") is None
    if "--checkpoint-dir" in flags:
        counters.clear()
        t_rz.reset_fault_state()
        again = tmp_path / "again.csv"
        assert t_main.main(
            ["--input", str(inputs / "in.csv"), "--row-id", "tid",
             "--output", str(again), "--checkpoint-dir",
             str(tmp_path / "ckpt_torch")]) == 0
        assert again.read_text() == out[1]
        torn = "torn_write" in "".join(flags)
        assert counters["resilience.checkpoint.hits"] == (1 if torn else 2)


def test_injected_crash_exits_23_and_the_rerun_resumes(inputs, tmp_path):
    """``--fault-plan store.checkpoint:1:crash`` kills the port's CLI (as
    the JAX package's) with code 23 while the detect checkpoint is being
    written; a re-run without the plan exits 0 with the unflagged CSV."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DELPHI_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    base = ["--input", str(inputs / "in.csv"), "--row-id", "tid"]
    codes = []
    for pkg in ("delphi_tpu.main", "delphi_tpu_torch.main"):
        d = tmp_path / pkg
        proc = subprocess.run(
            [sys.executable, "-m", pkg, *base, "--output", str(d) + ".csv",
             "--checkpoint-dir", str(d), "--fault-plan",
             "store.checkpoint:1:crash"],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        codes.append(proc.returncode)
        assert not (d / "phase_detect.pkl").exists()
    assert codes == [23, 23]
    d = tmp_path / "delphi_tpu_torch.main"
    rerun = tmp_path / "rerun.csv"
    assert t_main.main([*base, "--output", str(rerun), "--checkpoint-dir",
                        str(d)]) == 0
    plain = tmp_path / "plain.csv"
    assert t_main.main([*base, "--output", str(plain)]) == 0
    assert rerun.read_text() == plain.read_text()
    assert (d / "phase_detect.pkl").is_file()


def _fsck_root(root):
    """A store root holding one good file, one torn file and one file
    without an envelope."""
    root.mkdir()
    t_store.write_json(str(root / "good.json"), {"v": 1},
                       schema="run_report", site="store.report")
    t_store.write_json(str(root / "torn.json"), {"v": 2},
                       schema="launch_plan", site="store.plan")
    blob = (root / "torn.json").read_bytes()
    (root / "torn.json").write_bytes(blob[:-3])
    (root / "old.json").write_text('{"pre": "envelope"}')


@pytest.mark.parametrize("flag", ["--incremental", "--snapshot-dir",
                                  "--stream", "--fsck",
                                  "--fsck-report-only"])
def test_incremental_stream_and_fsck_flags_match_jax(inputs, tmp_path,
                                                     capsys, flag):
    """The incremental, stream and fsck flags run and give the JAX CLI's
    result:
    ``--incremental`` the same CSV on the populating run and on an append
    delta, ``--snapshot-dir`` alone a plain run, ``--stream 3`` (on
    ``bench._stream_frames``) the same CSV, equal to one batch run's, ``--fsck`` (and ``--fsck-report-only``) the same exit code
    and summary on copies of one damaged root."""
    full = pd.read_csv(inputs / "in.csv")
    full.iloc[:320].to_csv(tmp_path / "base.csv", index=False)
    # every chunk of the stream fixture holds a clean example of every
    # group, which is what makes a streamed run equal one batch run
    bench._stream_frames(120, 3)[0].to_csv(tmp_path / "stream.csv",
                                           index=False)
    results = []
    for name, main in (("jax", j_main.main), ("torch", t_main.main)):
        snap = tmp_path / f"snap_{name}"
        out = tmp_path / f"{name}.csv"

        def cli(*argv, src="in.csv"):
            args = ["--input", str(inputs / src if src == "in.csv"
                                   else tmp_path / src),
                    "--row-id", "tid", "--output", str(out), *argv]
            assert main(args) == 0
            return out.read_text()

        if flag == "--incremental":
            first = cli("--incremental", "--snapshot-dir", str(snap),
                        src="base.csv")
            results.append((first, cli("--incremental", "--snapshot-dir",
                                       str(snap))))
        elif flag == "--snapshot-dir":
            results.append(cli("--snapshot-dir", str(snap)))
            assert not snap.exists()
        elif flag == "--stream":
            results.append(cli("--stream", "3", "--snapshot-dir", str(snap),
                               src="stream.csv"))
            assert (snap / "snapshot" / "manifest.json").exists()
            assert (snap / "cursor.00000003.json").exists()
        else:
            root = tmp_path / f"root_{name}"
            _fsck_root(root)
            capsys.readouterr()
            argv = ["--fsck", str(root)]
            if flag == "--fsck-report-only":
                argv.append("--fsck-report-only")
            rc = main(argv)
            summary = json.loads(capsys.readouterr().out)
            summary.pop("root")
            results.append((rc, summary,
                            sorted(p.name for p in root.rglob("*"))))
    want, got = results
    assert got == want
    if flag == "--stream":
        batch = tmp_path / "batch.csv"
        assert t_main.main(["--input", str(tmp_path / "stream.csv"),
                            "--row-id", "tid", "--output", str(batch)]) == 0
        assert got == batch.read_text()
    if flag.startswith("--fsck"):
        assert got[0] == 4 and got[1]["corrupt"] == 1
        assert ("quarantine" in got[2]) == (flag == "--fsck")


def test_cli_requires_input_row_id_output():
    with pytest.raises(SystemExit):
        t_main.main(["--input", "x.csv"])


@pytest.fixture(scope="module")
def escalate_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli_esc") / "esc.csv"
    bench._escalate_frames(64)[0].to_csv(path, index=False)
    return path


@pytest.mark.parametrize("flags", [
    ("--escalate",), ("--escalate", "--escalate-budget", "3"),
    ("--escalate", "--escalate-conf", "0.9"),
    ("--escalate", "--escalate-budget", "20", "--provenance-out"),
    ("--provenance-out",),
], ids=lambda f: "-".join(x.strip("-") for x in f))
def test_cli_escalation_and_provenance_match_jax(escalate_csv, tmp_path,
                                                 monkeypatch, flags):
    """The escalation flags and ``--provenance-out``: equal CSVs, and the
    ledger files carry the JAX package's envelope header and entries."""
    from test_torch_provenance import assert_entries_match, carry_jax_models
    carry_jax_models(monkeypatch)
    # the JAX CLI leaves repair.provenance.path in its session conf
    monkeypatch.setitem(j_session().conf, "repair.provenance.path", "")
    texts, ledgers = [], []
    for name, main in (("jax", j_main.main), ("torch", t_main.main)):
        out, led = tmp_path / f"{name}.csv", tmp_path / f"{name}.jsonl"
        argv = ["--input", str(escalate_csv), "--row-id", "tid",
                "--output", str(out)]
        for f in flags:
            argv += [f, str(led)] if f == "--provenance-out" else [f]
        assert main(argv) == 0
        texts.append(out.read_text())
        if "--provenance-out" in flags:
            with open(led, "rb") as fh:
                assert fh.readline().startswith(b"#DELPHI-STORE v1 provenance ")
            rows, status = t_store.read_jsonl(
                str(led), schema="provenance", site="store.provenance")
            assert status == "ok"
            ledgers.append(rows)
    assert len(texts[1].splitlines()) > 1
    assert texts[1] == texts[0]
    assert t_session().conf.get("repair.provenance.path") is None
    if ledgers:
        assert_entries_match(ledgers[1], ledgers[0])


@pytest.fixture
def _restore_report_conf():
    """The JAX CLI leaves ``--metrics-out``'s and the drift gate's ledger
    settings in its session conf."""
    keys = ("repair.metrics.path", "repair.provenance.path")
    prior = {k: j_session().conf.get(k) for k in keys}
    yield
    for k, v in prior.items():
        if v is None:
            j_session().conf.pop(k, None)
        else:
            j_session().conf[k] = v


@pytest.fixture(scope="module")
def baseline(inputs, tmp_path_factory):
    """A JAX run report with scorecards of the plain run of ``in.csv``."""
    root = tmp_path_factory.mktemp("baseline")
    keys = ("repair.metrics.path", "repair.provenance.path")
    prior = {k: j_session().conf.get(k) for k in keys}
    try:
        assert j_main.main(["--input", str(inputs / "in.csv"), "--row-id",
                            "tid", "--output", str(root / "b.csv"),
                            "--metrics-out", str(root / "b.json"),
                            "--provenance-out", ":memory:"]) == 0
    finally:
        for k, v in prior.items():
            if v is None:
                j_session().conf.pop(k, None)
            else:
                j_session().conf[k] = v
    return root / "b.json"


@pytest.mark.parametrize("flags", [
    ("--metrics-out",), ("--baseline-report",),
    ("--baseline-report", "--drift-fail-over", "0.25"),
    ("--metrics-out", "--baseline-report", "--drift-fail-over", "0.25"),
], ids=lambda f: "-".join(x.strip("-") for x in f))
def test_report_flags_write_the_jax_csv(inputs, tmp_path, baseline, flags,
                                        _restore_report_conf):
    """``--metrics-out``, ``--baseline-report`` and ``--drift-fail-over``
    (slice 12) write the JAX package's CSV and exit 0 on the run of the
    baseline's own input; the reports both packages write load in both."""
    from delphi_tpu.observability import load_run_report as j_load
    from delphi_tpu_torch.observability import load_run_report as t_load
    args = []
    for f in flags:
        args.append(f)
        if f == "--metrics-out":
            args.append("REPORT")
        elif f == "--baseline-report":
            args.append(str(baseline))
    texts, reports = [], []
    for name, main in (("jax", j_main.main), ("torch", t_main.main)):
        out = tmp_path / f"{name}.csv"
        report = tmp_path / f"{name}.json"
        argv = ["--input", str(inputs / "in.csv"), "--row-id", "tid",
                "--output", str(out)] + [str(report) if a == "REPORT" else a
                                         for a in args]
        assert main(argv) == 0
        texts.append(out.read_text())
        reports.append(report)
    assert texts[1] == texts[0] and len(texts[1].splitlines()) > 1
    if "--metrics-out" in flags:
        j_rep, t_rep = j_load(str(reports[1])), t_load(str(reports[0]))
        assert j_rep["status"] == t_rep["status"] == "ok"
        assert j_rep["spans"]["name"] == t_rep["spans"]["name"] \
            == "batch.main"
        if "--baseline-report" in flags:
            assert j_rep["drift"]["failed"] is False
            assert j_rep["drift"]["max_divergence"] == 0.0
            assert j_rep["scorecards"]
    assert t_session().conf.get("repair.metrics.path") is None
    assert t_session().conf.get("repair.provenance.path") is None
