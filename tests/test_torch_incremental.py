"""The port's incremental plane (``delphi_tpu_torch/incremental/``) against
the JAX package's, on the CPU: snapshot manifests (the same dict and
``snapshot_id``, under column reorder and two block sizes), the options
digest, delta plans for every fallback reason and for clean-append and
update deltas, constraint dirty-set expansion and PSI; the JAX package's
clean-append A/B (``bench.incremental_smoke``) run in the port at 64 and
2,000 rows, whose delta frame must equal the port's and the JAX package's
fresh frames bit for bit; an update delta in both packages; and a
JAX-written ``state.pkl``, which the port meets as a counted
``snapshot_state_missing`` fallback without importing JAX.
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
import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.constraints import parse as j_parse
from delphi_tpu.incremental import depgraph as j_dg
from delphi_tpu.incremental import executor as j_ex
from delphi_tpu.incremental import manifest as j_mf
from delphi_tpu.incremental import planner as j_pl
from delphi_tpu.observability import drift as j_drift
from delphi_tpu.table import encode_table as j_encode
from delphi_tpu_torch.constraints import parse as t_parse
from delphi_tpu_torch.incremental import depgraph as t_dg
from delphi_tpu_torch.incremental import executor as t_ex
from delphi_tpu_torch.incremental import manifest as t_mf
from delphi_tpu_torch.incremental import planner as t_pl
from delphi_tpu_torch.observability import drift as t_drift
from delphi_tpu_torch.table import encode_table as t_encode
from delphi_tpu_torch.utils import counters

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

AB_CONSTRAINTS = "t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c3,t2.c3)"

_ENV = ("DELPHI_INCREMENTAL", "DELPHI_SNAPSHOT_DIR",
        "DELPHI_SNAPSHOT_BLOCK_ROWS", "DELPHI_INCREMENTAL_DRIFT_MAX",
        "DELPHI_PROVENANCE_PATH", "DELPHI_FAULT_PLAN")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    j_ex._warned.clear()
    t_ex._warned.clear()
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def _frame(n: int = 40, seed: int = 0) -> pd.DataFrame:
    """Strings with NULLs, an integer and a float column, seeded."""
    rng = np.random.RandomState(seed)
    g = rng.randint(0, 5, n)
    df = pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "c0": [f"g{v}" for v in g],
        "c1": [f"v{v % 3}" for v in g],
        "c2": rng.randint(0, 4, n),
        "x": np.round(g * 1.5 + rng.rand(n), 3),
    })
    df.loc[rng.rand(n) < 0.15, "c1"] = None
    df.loc[rng.rand(n) < 0.1, "x"] = np.nan
    return df


# -- manifests ----------------------------------------------------------------

@pytest.mark.parametrize("block", [3, 8])
@pytest.mark.parametrize("order", ["as is", "reordered"])
def test_manifest_identical_to_jax(block, order):
    df = _frame()
    if order == "reordered":
        df = df[["tid", "x", "c2", "c0", "c1"]]
    want = j_mf.build_manifest(j_encode(df, "tid"), options_digest="d0",
                               block=block)
    got = t_mf.build_manifest(t_encode(df, "tid"), options_digest="d0",
                              block=block)
    assert got == want
    assert got["snapshot_id"] == want["snapshot_id"]
    base = t_mf.build_manifest(t_encode(_frame(), "tid"),
                               options_digest="d0", block=block)
    assert got["snapshot_id"] == base["snapshot_id"]


def test_merged_manifests_identical_to_jax():
    df = _frame(16)
    halves = [df.iloc[:8], df.iloc[8:].reset_index(drop=True)]
    want = j_mf.merge_manifests(*[j_mf.build_manifest(j_encode(h, "tid"),
                                                      block=4)
                                  for h in halves])
    got = t_mf.merge_manifests(*[t_mf.build_manifest(t_encode(h, "tid"),
                                                     block=4)
                                 for h in halves])
    assert got == want and got["merged"] is True


def _setup(lib, df):
    return lib.delphi.repair.setInput(df).setRowId("tid") \
        .setErrorDetectors([
            lib.NullErrorDetector(),
            lib.RegExErrorDetector("c1", "^v[0-9]$"),
            lib.ConstraintErrorDetector(constraints=AB_CONSTRAINTS)]) \
        .setTargets(["c1", "c2"]).setDiscreteThreshold(30) \
        .option("model.hp.max_evals", "2") \
        .option("repair.snapshot.dir", "ignored")


def test_options_digest_equals_jax():
    df = _frame()
    want = j_ex.options_digest(_setup(J, df))
    assert t_ex.options_digest(_setup(T, df)) == want
    assert t_ex.options_digest(
        _setup(T, df).option("model.hp.max_evals", "3")) != want


# -- delta plans --------------------------------------------------------------

def _plan_fields(plan):
    return {**plan.summary(),
            "clean": plan.clean_columns, "dirty": plan.dirty_columns,
            **{k: getattr(plan, k).tolist() for k in (
                "updated_rows", "appended_rows", "expanded_rows",
                "planned_rows")}}


def _plan_case(case):
    """(incoming table frame, manifest frame, digest, block, constraint)"""
    df = _frame(24)
    if case == "no_manifest":
        return df, None, "d0", 4, None
    if case == "options_changed":
        return df, df, "d1", 4, None
    if case == "schema_changed":
        return df.rename(columns={"c2": "c9"}), df, "d0", 4, None
    if case == "rows_removed":
        return df.iloc[:10], df, "d0", 4, None
    if case == "row_ids_changed":
        rekeyed = df.copy()
        rekeyed.loc[3, "tid"] = "999"
        return rekeyed, df, "d0", 4, None
    if case == "clean_append":
        more = _frame(30).iloc[24:]
        return pd.concat([df, more], ignore_index=True), df, "d0", 4, \
            "t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c2,t2.c2)"
    assert case == "update"
    edited = df.copy()
    edited.loc[7, "c2"] = 9
    edited.loc[21, "c1"] = "edited"
    return edited, df, "d0", 3, "t1&t2&EQ(t1.c0,t2.c0)&IQ(t1.c1,t2.c1)"


@pytest.mark.parametrize("case", [
    "no_manifest", "options_changed", "schema_changed", "rows_removed",
    "row_ids_changed", "clean_append", "update"])
def test_plan_fields_equal_jax(case):
    incoming, base, digest, block, dc = _plan_case(case)
    plans = []
    for enc, mf, pl, parse in ((j_encode, j_mf, j_pl, j_parse),
                               (t_encode, t_mf, t_pl, t_parse)):
        manifest = None if base is None else mf.build_manifest(
            enc(base, "tid"), options_digest="d0", block=block)
        plans.append(pl.plan_delta(enc(incoming, "tid"), manifest,
                                   [parse(dc)] if dc else [],
                                   options_digest=digest))
    want, got = plans
    expected = None if case in ("clean_append", "update") else case
    assert got.fallback_reason == want.fallback_reason == expected
    assert _plan_fields(got) == _plan_fields(want)
    if case == "update":
        assert got.dirty_columns == ["c1", "c2"]
        assert len(got.expanded_rows) > 0


@pytest.mark.parametrize("dc", [
    "t1&t2&EQ(t1.c0,t2.c0)&EQ(t1.c1,t2.c1)&IQ(t1.c2,t2.c2)",
    "t1&t2&IQ(t1.c0,t2.c0)&IQ(t1.c1,t2.c1)",
    "t1&t2&EQ(t1.c0,t2.c1)&IQ(t1.c2,t2.c2)",
    "t1&EQ(t1.c0,\"g1\")&IQ(t1.c1,\"v0\")",
])
def test_expand_dirty_rows_equal_jax(dc):
    df = _frame(30, seed=3)
    dirty = np.array([0, 7, 19], dtype=np.int64)
    want = j_dg.expand_dirty_rows(j_encode(df, "tid"), [j_parse(dc)], dirty)
    got = t_dg.expand_dirty_rows(t_encode(df, "tid"), [t_parse(dc)], dirty)
    assert got.tolist() == want.tolist()
    assert t_dg.constraint_eq_keys(t_parse(dc)) == \
        j_dg.constraint_eq_keys(j_parse(dc))


def test_psi_equals_jax():
    rng = np.random.RandomState(4)
    for _ in range(20):
        k = rng.randint(1, 12)
        cur, base = rng.randint(0, 50, k).tolist(), rng.randint(0, 50, k)
        base = base.tolist()
        assert t_drift.population_stability_index(cur, base) == \
            j_drift.population_stability_index(cur, base)
    counters.clear()
    for cur, base in (([], []), ([0.0, 0.0], [1.0, 2.0]),
                      ([float("nan")], [1.0])):
        assert t_drift.population_stability_index(cur, base) == 0.0
    assert counters["drift.bins_empty"] == 3


# -- the clean-append A/B -----------------------------------------------------

def _ab_model(lib, frame, snapshot_dir=None):
    m = lib.delphi.repair.setInput(frame.copy()).setRowId("tid") \
        .setErrorDetectors([
            lib.NullErrorDetector(),
            lib.ConstraintErrorDetector(constraints=AB_CONSTRAINTS)])
    if snapshot_dir is not None:
        m = m.option("repair.incremental", "true") \
            .option("repair.snapshot.dir", str(snapshot_dir))
    return m


def _port_run(frame, snapshot_dir=None):
    counters.clear()
    m = _ab_model(T, frame, snapshot_dir)
    out = m.run()
    return out, dict(counters), m._last_incremental


@pytest.mark.parametrize("n", [64, 2000])
def test_clean_append_delta_bit_identical_to_fresh_and_jax(
        n, tmp_path, monkeypatch):
    """``bench.incremental_smoke`` in the port: populate, delta, fresh; the
    delta frame equals the port's fresh frame and the JAX package's, on
    less detection and scoring work, with the smoke's counters."""
    monkeypatch.setenv("DELPHI_PROVENANCE_PATH", ":memory:")
    base, appended = bench._incremental_frames(n)
    snap = tmp_path / "snap"
    _, populate, p_sum = _port_run(base, snap)
    delta, d_counts, d_sum = _port_run(appended, snap)
    fresh, f_counts, _ = _port_run(appended)
    jax_fresh = _ab_model(J, appended).run()

    pd.testing.assert_frame_equal(delta, fresh)
    pd.testing.assert_frame_equal(delta, jax_fresh)
    assert p_sum["mode"] == "full" and p_sum["fallback_reason"] == \
        "no_manifest"
    assert populate.get("incremental.fallback") == 1
    assert d_sum["mode"] == "delta" and d_sum["rows_expanded"] > 0
    assert d_counts.get("incremental.fallback", 0) == 0
    assert 0 < d_counts["incremental.rows_replanned"] < len(appended)
    assert d_counts["incremental.models_reused"] >= 1
    assert d_counts["incremental.columns_reused"] >= 1
    assert d_counts["incremental.cells_spliced_reused"] > 0
    assert d_counts["detect.rows_scanned"] < f_counts["detect.rows_scanned"]
    assert d_counts["domain.cells_scored"] < f_counts["domain.cells_scored"]


def test_update_delta_matches_jax(tmp_path, monkeypatch):
    """An update delta (``c2`` rewritten in one 256-row block) in both
    packages: equal summaries, and frames equal to each other and to the
    fresh runs."""
    monkeypatch.setenv("DELPHI_SNAPSHOT_BLOCK_ROWS", "256")
    base, _ = bench._incremental_frames(2000)
    updated = base.copy()
    rows = np.arange(512, 768)
    updated.loc[rows, "c2"] = [str((i * 3) % 5) for i in rows]
    frames, summaries = [], []
    for lib in (J, T):
        snap = tmp_path / lib.__name__
        _ab_model(lib, base, snap).run()
        m = _ab_model(lib, updated, snap)
        frames.append(m.run())
        summaries.append(m._last_incremental)
    (jf, tf), (js, ts) = frames, summaries
    assert ts["mode"] == "delta" and ts["rows_updated"] == 256
    keys = ("columns_clean", "columns_dirty", "rows_updated",
            "rows_expanded", "rows_planned", "attrs_reusable",
            "models_reused", "models_retrained", "models_reused_attrs",
            "cells_spliced_reused", "base_snapshot", "snapshot_id")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    pd.testing.assert_frame_equal(tf, jf)
    pd.testing.assert_frame_equal(tf, _ab_model(T, updated).run())


_JAX_STATE = """
import json, sys
import bench
import delphi_tpu_torch as T
from delphi_tpu_torch.utils import counters
_, appended = bench._incremental_frames(64)
m = T.delphi.repair.setInput(appended).setRowId("tid").setErrorDetectors([
    T.NullErrorDetector(),
    T.ConstraintErrorDetector(constraints=sys.argv[2])]) \\
    .option("repair.incremental", "true") \\
    .option("repair.snapshot.dir", sys.argv[1])
out = m.run()
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"summary": m._last_incremental, "rows": len(out),
                  "counters": counters, "mods": mods}))
"""


def test_jax_written_state_is_a_counted_fallback_without_jax(tmp_path):
    """A snapshot the JAX package wrote: its manifest reads, its state.pkl
    (JAX model classes) reads as corrupt and is quarantined, the port
    falls back to a full run and rewrites the snapshot, and neither
    ``jax`` nor ``delphi_tpu`` is imported."""
    snap = tmp_path / "snap"
    base, _ = bench._incremental_frames(64)
    _ab_model(J, base, snap).run()
    assert t_mf.load_manifest(str(snap)) is not None
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(DELPHI_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_STATE, str(snap), AB_CONSTRAINTS],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mods"] == []
    assert out["summary"]["mode"] == "full"
    assert out["summary"]["fallback_reason"] == "snapshot_state_missing"
    assert out["counters"]["incremental.fallback"] == 1
    assert out["counters"]["store.quarantined"] == 1
    assert os.listdir(snap / "quarantine") == ["state.pkl"]
    state = t_mf.load_state(str(snap))
    assert state is not None and len(state["frame"]) == out["rows"]
