"""The port stands alone: importing it and running a repair on the CPU
loads neither JAX nor any module of ``delphi_tpu`` (nor scikit-learn,
which only ``LOFOutlierErrorDetector`` imports, when it scans), and asking
for the default device (``cuda``) where there is no card raises instead of
running on the CPU.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

_RUN = """
import json, sys
import pandas as pd
import delphi_tpu_torch as T
df = pd.DataFrame({
    "tid": range(40),
    "a": [f"a{i % 4}" for i in range(40)],
    "b": [None if i % 7 == 0 else f"b{i % 4}" for i in range(40)],
    "c": [f"c{i % 2}" for i in range(40)],
})
out = T.delphi.repair.setInput(df).setRowId("tid") \\
    .setErrorDetectors([T.NullErrorDetector()]) \\
    .option("model.hp.max_evals", "1").run()
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"rows": len(out), "device": str(T.get_device()),
                  "mods": mods}))
"""

_DEFAULT_DEVICE = """
import pandas as pd
import delphi_tpu_torch as T
try:
    T.get_device()
except RuntimeError:
    pass
else:
    raise SystemExit("get_device() did not raise without CUDA")
df = pd.DataFrame({"tid": range(6), "a": ["x", None, "y", "x", "y", "x"],
                   "b": ["p", "q", "p", "q", "p", "q"]})
try:
    T.delphi.repair.setInput(df).setRowId("tid") \\
        .setErrorDetectors([T.NullErrorDetector()]).run()
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise SystemExit("run() did not raise without CUDA")
print("raised")
"""


_RUN_DEFAULTS = """
import importlib, json, pkgutil, sys
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch.models.linear import LogisticRegressionModel
from delphi_tpu_torch.utils import train_reports
names = [m.name for m in pkgutil.walk_packages(T.__path__,
                                               "delphi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
rng = np.random.RandomState(0)
n = 240
latent = rng.randint(0, 30, n)
df = pd.DataFrame({
    "tid": range(n),
    "a": [f"a{v // 2}" for v in latent],
    "p": [f"p{v % 2}" for v in latent],
    "w": [f"w{v}" for v in latent],
    "b": [f"b{v % 3}" for v in latent],
    "x": latent * 1.5 + rng.rand(n),
})
for col in ("w", "b", "x"):
    df.loc[rng.rand(n) < 0.1, col] = None
frames = [T.delphi.repair.setInput(df).setRowId("tid")
          .setErrorDetectors([T.NullErrorDetector()])
          .setParallelStatTrainingEnabled(batched).run()
          for batched in (False, True)]
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({
    "modules": len(names), "rows": len(frames[0]),
    "same": bool(frames[0].equals(frames[1])),
    "logistic": sorted({r["target"] for r in train_reports
                        if isinstance(r["model"], LogisticRegressionModel)}),
    "mods": mods}))
"""


_RUN_DETECTORS = """
import json, sys
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
rng = np.random.RandomState(0)
n = 300
city = rng.randint(0, 12, n)
df = pd.DataFrame({
    "tid": range(n),
    "city": [f"c{v}" for v in city],
    "state": [None if i % 17 == 0 else f"s{v % 6}"
              for i, v in enumerate(city)],
    "channel": [f"h{v}" for v in rng.randint(0, 3, n)],
    "amount": np.round(city * 10.0 + rng.normal(0, 1, n), 2),
})
df.loc[5, "amount"] = 1e5


class ZScore:
    def fit_predict(self, X):
        x = np.asarray(X)[:, 0]
        return np.where(np.abs(x - x.mean()) > 3 * x.std(), -1, 1)


dets = [T.NullErrorDetector(), T.RegExErrorDetector("state", "^s[0-9]$"),
        T.DomainValues("channel", autofill=True),
        T.ConstraintErrorDetector(
            constraints='city->state;t1&EQ(t1.state,"s0")&EQ(t1.channel,"h2")'),
        T.GaussianOutlierErrorDetector(),
        T.ScikitLearnBackedErrorDetector(ZScore),
        T.LOFOutlierErrorDetector()]
lof = dets.pop()  # constructed, never run: no scikit-learn import
m = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors(dets) \\
    .option("model.hp.max_evals", "1")
cells = m.run(detect_errors_only=True)
out = m.run()
given = T.delphi.repair.setInput(df).setRowId("tid") \\
    .setErrorCells(cells[["tid", "attribute"]]) \\
    .option("model.hp.max_evals", "1").run()
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib", "sklearn"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"cells": len(cells), "repairs": len(out),
                  "given": len(given),
                  "attrs": sorted(set(cells["attribute"])), "mods": mods}))
"""


_RUN_SLICE5 = """
import json, os, sys, tempfile
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch import main as cli
rng = np.random.RandomState(0)
n = 300
city = rng.randint(0, 12, n)
df = pd.DataFrame({
    "tid": range(n),
    "city": [f"c{v}" for v in city],
    "state": [f"state_{v % 6:02d}" for v in city],
    "channel": [f"h{v}" for v in rng.randint(0, 3, n)],
})
df.loc[rng.rand(n) < 0.05, "state"] = None
df.loc[rng.rand(n) < 0.05, "state"] = "stxte_01"
rules = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
    T.NullErrorDetector(), T.RegExErrorDetector("state", "^state_[0-9]{2}$"),
    T.ConstraintErrorDetector(constraints="city->state")]) \\
    .setRepairByRules(True).setUpdateCostFunction(T.Levenshtein()) \\
    .option("model.rule.repair_by_regex.disabled", "") \\
    .option("model.rule.repair_by_nearest_values.disabled", "") \\
    .option("model.hp.max_evals", "1").run()
pmf = T.delphi.repair.setInput(df).setRowId("tid") \\
    .setErrorDetectors([T.NullErrorDetector()]) \\
    .setUpdateCostFunction(T.Levenshtein()).setRepairDelta(5) \\
    .option("model.hp.max_evals", "1")
modes = [len(pmf.run(**{m: True})) for m in (
    "compute_repair_candidate_prob", "compute_repair_prob",
    "compute_repair_score", "maximal_likelihood_repair")]
T.delphi.register_table("t", df)
split = T.delphi.misc.options({"table_name": "t", "row_id": "tid",
                               "k": "3"}).splitInputTable()
out = tempfile.mkdtemp()
T.delphi.misc.options({"table_name": "t", "path": out + "/g",
                       "pairwise_attr_stat_threshold": "2.0"}) \\
    .generateDepGraph()
df.to_csv(out + "/in.csv", index=False)
cli.main(["--input", out + "/in.csv", "--row-id", "tid", "--output",
          out + "/out.csv", "--chunksize", "100"])
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"rules": len(rules), "modes": modes,
                  "clusters": int(split["k"].nunique()),
                  "dot": os.path.exists(out + "/g/depgraph.dot"),
                  "cli": len(pd.read_csv(out + "/out.csv")), "mods": mods}))
"""


_RUN_SLICE6 = """
import json, os, sys, tempfile
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch import main as cli
from delphi_tpu_torch.escalate import joint, patterns, router
from delphi_tpu_torch.observability import provenance
from delphi_tpu_torch.ops import joint as k8
from delphi_tpu_torch.parallel import store
n = 200
df = pd.DataFrame({
    "tid": [str(i) for i in range(n)],
    "c0": [f"g{i % 8}" for i in range(n)],
    "c1": [f"v{(i % 8) % 4}" for i in range(n)],
    "c2": [f"{100 + i % 5}-{10 + i % 6}" for i in range(n)],
})
for i in range(5, n, 13):
    df.loc[i, "c2"] = df.loc[i, "c2"].replace("-", "x")
for i in range(7, n, 23):
    df.loc[i, "c2"] = None
out = tempfile.mkdtemp()
os.environ["DELPHI_PROVENANCE_PATH"] = out + "/p.jsonl"
m = T.delphi.repair.setInput(df).setRowId("tid").setErrorDetectors([
    T.NullErrorDetector(), T.RegExErrorDetector("c2", "^[0-9]{3}-[0-9]{2}$")
]).option("repair.escalate", "true").option("model.hp.max_evals", "1")
frame = m.run()
del os.environ["DELPHI_PROVENANCE_PATH"]
rows, status = store.read_jsonl(out + "/p.jsonl", schema="provenance",
                                site="store.provenance")
df.to_csv(out + "/in.csv", index=False)
cli.main(["--input", out + "/in.csv", "--row-id", "tid", "--output",
          out + "/out.csv", "--escalate", "--provenance-out",
          out + "/cli.jsonl"])
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"repairs": len(frame), "status": status,
                  "entries": len(rows),
                  "escalated": m._last_escalation["escalated"],
                  "launches": k8.launches,
                  "cli": os.path.exists(out + "/cli.jsonl"), "mods": mods}))
"""


_RUN_SLICE7 = """
import json, os, sys, tempfile
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch import main as cli
from delphi_tpu_torch.incremental import manifest
from delphi_tpu_torch.parallel import store
from delphi_tpu_torch.utils import counters


def frame(n):
    return pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "c0": [f"g{i % 8}" for i in range(n)],
        "c1": [None if i % 11 == 0 else f"v{(i % 8) % 7}" for i in range(n)],
        "c2": [str((i * 7) % 5) for i in range(n)],
        "c3": [f"w{(i % 8) % 5}" for i in range(n)]})


out = tempfile.mkdtemp()
snap = out + "/snap"
runs = []
for n in (120, 150):
    counters.clear()
    m = T.delphi.repair.setInput(frame(n)).setRowId("tid").setErrorDetectors([
        T.NullErrorDetector(),
        T.ConstraintErrorDetector(constraints="t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)")]) \\
        .option("repair.incremental", "true") \\
        .option("repair.snapshot.dir", snap)
    m.run()
    runs.append(m._last_incremental["mode"])
frame(96).to_csv(out + "/in.csv", index=False)
cli.main(["--input", out + "/in.csv", "--row-id", "tid", "--output",
          out + "/s.csv", "--stream", "3", "--snapshot-dir", out + "/st"])
with open(snap + "/" + manifest.MANIFEST_FILE, "r+b") as f:
    f.seek(60)
    b = f.read(1)
    f.seek(60)
    f.write(bytes([b[0] ^ 1]))
summary = store.fsck(out)
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"runs": runs, "reused": counters.get("incremental.models_reused", 0),
                  "stream": len(pd.read_csv(out + "/s.csv")),
                  "corrupt": summary["corrupt"], "mods": mods}))
"""


_RUN_SLICE8 = """
import json, os, sys, tempfile
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch import main as cli
from delphi_tpu_torch.parallel import resilience as rz
from delphi_tpu_torch.utils import counters

df = pd.DataFrame({
    "tid": [str(i) for i in range(60)],
    "a": [f"a{i % 3}" for i in range(60)],
    "b": [None if i % 9 == 0 else f"b{i % 3}" for i in range(60)],
    "c": [f"c{i % 2}" for i in range(60)]})


def run(**opts):
    m = T.delphi.repair.setInput(df).setRowId("tid") \\
        .setErrorDetectors([T.NullErrorDetector()])
    for k, v in opts.items():
        m = m.option(k, v)
    return m.run()


out = tempfile.mkdtemp()
base = run()
os.environ["DELPHI_CHECKPOINT_DIR"] = out + "/phase"
os.environ["DELPHI_FAULT_PLAN"] = "gbdt.*:1:fatal"
try:
    run()
    killed = False
except rz.FaultInjected:
    killed = True
del os.environ["DELPHI_FAULT_PLAN"]
rz.reset_fault_state()
counters.clear()
resumed = run()
hits = counters.get("resilience.checkpoint.hits", 0)
del os.environ["DELPHI_CHECKPOINT_DIR"]
os.environ["DELPHI_FAULT_PLAN"] = "freq.pair*:1:oom,freq.pair*:2:oom,freq.pair*:3:oom"
counters.clear()
laddered = run(**{"model.checkpoint_path": out + "/model"})
rungs = counters.get("resilience.degrade.cpu_fallback", 0)
del os.environ["DELPHI_FAULT_PLAN"]
counters.clear()
reused = run(**{"model.checkpoint_path": out + "/model"})
df.to_csv(out + "/in.csv", index=False)
code = cli.main(["--input", out + "/in.csv", "--row-id", "tid", "--output",
                 out + "/o.csv", "--checkpoint-dir", out + "/cli",
                 "--fault-plan", "xfer.upload:1:transfer"])
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"killed": killed, "hits": hits,
                  "equal": all(f.equals(base) for f in (resumed, laddered,
                                                        reused)),
                  "rungs": rungs,
                  "model_hits": counters.get("train.checkpoint_hits", 0),
                  "cli": code, "mods": mods}))
"""


_RUN_SLICE11 = """
import json, os, sys
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch.parallel import dist_resilience, distributed, rowshard
from delphi_tpu_torch.ops import detect
from delphi_tpu_torch.table import encode_table

df = pd.DataFrame({"tid": [str(i) for i in range(80)],
                   "a": [None if i % 9 == 0 else f"a{i % 3}" for i in range(80)]})
table = encode_table(df, "tid")
want = detect.detect_null_cells(table, ["a"])
os.environ.update(DELPHI_SHARD="1", DELPHI_SHARD_MIN_ROWS="8")
distributed.process_count = lambda: 2
distributed.process_index = lambda: 0
# the one transport, faked: the peer holds the same table
distributed._all_gather = lambda arr: np.stack([np.asarray(arr)] * 2)
lo, hi = rowshard.active_span(table.n_rows)
got = detect.detect_null_cells(table, ["a"])
dist_resilience.declare_rank_lost("shard.detect.merge", reason="test")
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"span": [lo, hi], "want": want[0][0].tolist(),
                  "got": got[0][0].tolist(),
                  "latched": rowshard.shard_enabled() is False,
                  "mods": mods}))
"""

_RUN_SLICE15 = """
import json, os, sys, tempfile, urllib.request
from delphi_tpu_torch.observability.fleet import FleetRouter, rendezvous_rank
from delphi_tpu_torch.observability.serve import RepairServer
from delphi_tpu_torch.parallel import dist_resilience

n = 24
table = {"tid": [str(i) for i in range(n)],
         "c0": ["a" if i % 2 else "b" for i in range(n)],
         "c1": [None if i % 11 == 0 else str(i % 4) for i in range(n)],
         "c2": [str((i * 7) % 5) for i in range(n)]}
cache = tempfile.mkdtemp()
srv = RepairServer(port=0, workers=1, cache_dir=cache,
                   fleet_dir=os.path.join(cache, "fleet"),
                   worker_id="0").start()
try:
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/repair", method="POST",
        data=json.dumps({"table": table, "row_id": "tid"}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    members = dist_resilience.scan_membership(os.path.join(cache, "fleet"),
                                              srv.fleet_heartbeat_s)
    router = FleetRouter(port=0, cache_dir=cache, spawn=False).start()
    try:
        routed, answer, _ = router.handle_repair({"table": table,
                                                  "row_id": "tid"})
    finally:
        router.stop()
finally:
    srv.drain(grace_s=5)
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"status": body["status"], "rows": body["rows"],
                  "members": members["0"]["status"], "routed": routed,
                  "same": answer.get("frame") == body["frame"],
                  "mods": mods}))
"""


def _python(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DELPHI_TORCH_DEVICE", "PYTHONPATH")}
    env.update(env_over)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_and_runs_without_jax():
    proc = _python(_RUN, DELPHI_TORCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert out["rows"] > 0
    assert out["mods"] == []


def test_every_module_and_default_options_run_without_jax():
    """Every module of the port imports, and a repair at default options
    (CV grid search, a 30-class target on the logistic head, sequential
    and batched training) runs, without JAX or ``delphi_tpu`` loaded."""
    proc = _python(_RUN_DEFAULTS, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] >= 20
    assert out["rows"] > 0 and out["same"]
    assert out["logistic"] == ["w"]
    assert out["mods"] == []


def test_every_detector_runs_without_jax_or_sklearn():
    """NULL, regex, domain values, constraints (FD sugar and a one-tuple
    constraint), Gaussian outliers and a scikit-learn-style detector, then
    the same cells given back through setErrorCells: every step runs on
    the CPU without JAX, ``delphi_tpu`` or scikit-learn loaded."""
    proc = _python(_RUN_DETECTORS, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["cells"] > 0 and out["repairs"] > 0 and out["given"] > 0
    assert out["attrs"] == ["amount", "channel", "city", "state"]
    assert out["mods"] == []


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    proc = _python(_DEFAULT_DEVICE)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout
    assert proc.stdout.strip().endswith("raised")


def test_rules_pmf_misc_and_cli_run_without_jax():
    """Rule repairs, the four PMF / score / maximal-likelihood modes,
    ``delphi.misc`` (input splitting, the dependency graph) and the batch
    CLI run on the CPU without JAX or ``delphi_tpu`` loaded."""
    proc = _python(_RUN_SLICE5, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rules"] > 0 and min(out["modes"]) > 0 and out["cli"] > 0
    assert out["clusters"] == 3 and out["dot"]
    assert out["mods"] == []


def test_escalation_and_provenance_run_without_jax():
    """The provenance ledger (written through the durable store), the
    escalation tiers with K8, and the CLI's ``--escalate`` and
    ``--provenance-out`` run on the CPU without JAX or ``delphi_tpu``
    loaded."""
    proc = _python(_RUN_SLICE6, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["repairs"] > 0 and out["status"] == "ok"
    assert out["entries"] > 0 and out["escalated"] > 0
    assert out["launches"] >= 1 and out["cli"]
    assert out["mods"] == []


def test_incremental_stream_and_store_run_without_jax():
    """An incremental populate and delta, the CLI's ``--stream`` and the
    store's ``fsck`` (which finds a flipped manifest byte) run on the CPU
    without JAX or ``delphi_tpu`` loaded."""
    proc = _python(_RUN_SLICE7, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["runs"] == ["full", "delta"] and out["reused"] >= 1
    assert out["stream"] > 0 and out["corrupt"] == 1
    assert out["mods"] == []


def test_resilience_and_checkpoints_run_without_jax():
    """A run killed by an injected fault and its resume from the phase
    checkpoints, the CPU rung, a model checkpoint's save and reuse, and
    the CLI's ``--checkpoint-dir`` / ``--fault-plan`` run on the CPU
    without JAX or ``delphi_tpu`` loaded."""
    proc = _python(_RUN_SLICE8, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["killed"] and out["hits"] == 1 and out["equal"]
    assert out["rungs"] == 1 and out["model_hits"] == 1
    assert out["cli"] == 0
    assert out["mods"] == []


_RUN_SLICE9 = """
import json, os, sys, tempfile
import numpy as np
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch import main as cli
from delphi_tpu_torch.ops.kernels import domain_scores
from delphi_tpu_torch.parallel import compile_plane, pipeline, planner
from delphi_tpu_torch.observability import trace
from delphi_tpu_torch.utils import counters, gauges
rng = np.random.RandomState(0)
n = 300
a = rng.randint(0, 6, n)
df = pd.DataFrame({"tid": range(n), "a": [f"a{v}" for v in a],
                   "b": [f"b{v % 3}" for v in a],
                   "c": [f"c{v % 2}" for v in rng.randint(0, 5, n)]})
for col in ("b", "c"):
    df.loc[rng.rand(n) < 0.1, col] = None
out = tempfile.mkdtemp()
os.environ.update(DELPHI_PIPELINE="1", DELPHI_PREWARM="1",
                  DELPHI_PLAN_DIR=out + "/plans",
                  DELPHI_COMPILE_CACHE_DIR=out + "/cc")
def run(**opts):
    m = T.delphi.repair.setInput(df).setRowId("tid") \\
        .setErrorDetectors([T.NullErrorDetector()])
    for k, v in opts.items():
        m = m.option(k, v)
    return m.run()
run()
# one GBDT config: no CV search, whose per-target `gbdt.cv[0]` plans
# replace each other in the store (as in the JAX package)
first = run(**{"model.hp.max_evals": "1"})
counters.clear()
second = run(**{"model.hp.max_evals": "1"})
pipelined = counters.get("pipeline.items", 0)
hits = counters.get("launch.plan_cache.hits", 0)
replans = counters.get("launch.replans", 0)
df.to_csv(out + "/in.csv", index=False)
code = cli.main(["--input", out + "/in.csv", "--row-id", "tid", "--output",
                 out + "/o.csv", "--pipeline", "off"])
report = trace.plan_report(out + "/plans")
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"equal": bool(first.equals(second)),
                  "hits": hits, "replans": replans,
                  "pipelined": pipelined,
                  "planned": gauges.get("compile_plane.prewarm_planned", 0),
                  "ledgers": report["ledgers"], "cli": code, "mods": mods}))
"""


def test_planner_pipeline_and_compile_plane_run_without_jax():
    """The launch planner with a plan store (a warm second run replans
    nothing), the pipeline thread, the prewarm plan, K5's module, the CLI's
    ``--pipeline`` and the plan report run on the CPU without JAX or
    ``delphi_tpu`` loaded."""
    proc = _python(_RUN_SLICE9, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["equal"] and out["hits"] > 0 and out["replans"] == 0
    assert out["pipelined"] >= 2 and out["planned"] > 0
    assert out["ledgers"] == 0 and out["cli"] == 0
    assert out["mods"] == []


def test_shard_plane_modules_run_without_jax():
    """The process seam, the distributed resilience plane and the row-shard
    plane (slice 11) import and run a sharded NULL scan over a faked
    two-rank transport without JAX or ``delphi_tpu`` loaded: rank 0 scans
    its span and the gathered parts (the same span twice, as the faked
    peer holds the same rows) concatenate in rank order."""
    proc = _python(_RUN_SLICE11, DELPHI_TORCH_DEVICE="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["span"] == [0, 40]
    mine = [r for r in out["want"] if r < 40]
    assert out["got"] == mine + mine
    assert out["latched"]
    assert out["mods"] == []


def test_serving_plane_and_fleet_run_without_jax():
    """The serving plane and the fleet (slice 15) run without JAX or
    ``delphi_tpu`` loaded: a fleet-registered ``RepairServer`` answers a
    ``POST /repair`` on the CPU, ``scan_membership`` reads its liveness
    stamp, and a router attached to it routes the same request to it."""
    proc = _python(_RUN_SLICE15, DELPHI_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == "ok" and out["rows"] > 0
    assert out["members"] == "live"
    assert out["routed"] == 200 and out["same"]
    assert out["mods"] == []


_IMPORT_ONE = """
import importlib, json, sys
mod = importlib.import_module(sys.argv[1])
from delphi_tpu_torch.gauntlet import generate_scenario
from delphi_tpu_torch.observability import load
data = generate_scenario("correlated_multi", 60, 0)
segments = load.default_segments(20, 6.0, 3.0)
schedule = load.build_schedule(segments, 4, 1.1, load.parse_mix("batch=1"), 0)
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"truth": len(data.truth), "arrivals": len(schedule),
                  "mods": mods}))
"""


@pytest.mark.parametrize("module", [
    "delphi_tpu_torch.gauntlet", "delphi_tpu_torch.gauntlet.runner",
    "delphi_tpu_torch.observability.load"])
def test_gauntlet_and_load_import_without_jax(module):
    """The gauntlet, its runner and the load harness (slice 16) import,
    generate a scenario and build a load schedule without JAX or
    ``delphi_tpu`` loaded."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DELPHI_TORCH_DEVICE", "PYTHONPATH")}
    env["DELPHI_TORCH_DEVICE"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module],
                          cwd=REPO_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["truth"] > 0 and out["arrivals"] > 0
    assert out["mods"] == []
