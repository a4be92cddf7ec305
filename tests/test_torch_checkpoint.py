"""Phase checkpoints and model checkpoints of the port against the JAX
package's, on the CPU: a run killed by an injected fault resumes to the
unfaulted frame and to the JAX package's resumed frame, a checkpointed
re-run skips training, the model checkpoint's save / resume / stale /
relocation / unreadable cases (``tests/test_checkpoint_conf.py``), the
fingerprint digests of both packages, and checkpoints the JAX package
wrote, read by the port in a process without JAX."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu import observability as j_obs
from delphi_tpu.parallel import resilience as j_rz
from delphi_tpu_torch.parallel import resilience as t_rz
from delphi_tpu_torch.utils import counters, phase_walls

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DELPHI_FAULT_PLAN", "DELPHI_CHECKPOINT_DIR",
                "DELPHI_CHECKPOINT_SAMPLED_HASH"):
        monkeypatch.delenv(var, raising=False)
    for rz in (j_rz, t_rz):
        rz.reset_fault_state()
        rz.clear_cpu_fallback()
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    counters.clear()
    yield
    for rz in (j_rz, t_rz):
        rz.reset_fault_state()
    torch.set_num_threads(threads)
    T.set_device(None)


def _table(n=64, seed=0):
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "c0": rng.choice(["a", "b"], n),
        "c1": rng.choice(["p", "q", "r"], n),
        "c2": rng.choice(["0", "1", "2", "3"], n),
    })
    df.loc[df.index % 9 == 0, "c1"] = None
    return df


def _repair(lib, df, name="ckpt_input", **options):
    """A NULL repair of ``df`` registered as ``name`` in ``lib``'s
    session (the phase fingerprint covers the input's name)."""
    from delphi_tpu.session import get_session as j_session
    from delphi_tpu_torch.session import get_session as t_session
    sess = j_session() if lib is J else t_session()
    sess.register(name, df.copy())
    try:
        m = lib.delphi.repair.setTableName(name).setRowId("tid") \
            .setErrorDetectors([lib.NullErrorDetector()])
        for k, v in options.items():
            m = m.option(k, v)
        return m.run()
    finally:
        sess.drop(name)


def _killed_then_resumed(lib, df, directory, monkeypatch):
    """Run A dies at the first GBDT launch after the detect checkpoint
    landed; run B resumes. Returns (B's frame, B's checkpoint hits)."""
    rz = j_rz if lib is J else t_rz
    monkeypatch.setenv("DELPHI_CHECKPOINT_DIR", str(directory))
    monkeypatch.setenv("DELPHI_FAULT_PLAN", "gbdt.*:1:fatal")
    with pytest.raises(rz.FaultInjected):
        _repair(lib, df)
    assert (directory / "phase_detect.pkl").is_file()
    assert not (directory / "phase_train.pkl").exists()
    monkeypatch.delenv("DELPHI_FAULT_PLAN")
    rz.reset_fault_state()
    counters.clear()
    rec = j_obs.start_recording("resume") if lib is J else None
    try:
        out = _repair(lib, df)
    finally:
        if rec is not None:
            j_obs.stop_recording(rec)
    got = rec.registry.snapshot()["counters"] if rec is not None \
        else counters
    return out, got.get("resilience.checkpoint.hits", 0)


def test_resume_after_fatal_is_bit_identical_to_unfaulted_and_jax(
        tmp_path, monkeypatch):
    df = _table()
    base = _repair(T, df)
    pd.testing.assert_frame_equal(base, _repair(J, df))
    want, j_hits = _killed_then_resumed(J, df, tmp_path / "jax",
                                        monkeypatch)
    got, t_hits = _killed_then_resumed(T, df, tmp_path / "torch",
                                       monkeypatch)
    assert t_hits == j_hits == 1
    assert counters.get("train.stat_models") == 1
    pd.testing.assert_frame_equal(got, base)
    pd.testing.assert_frame_equal(got, want)


def test_checkpointed_rerun_skips_training(tmp_path, monkeypatch):
    df = pd.DataFrame({
        "tid": [str(i) for i in range(32)],
        "c0": ["a" if i % 2 else "b" for i in range(32)],
        "c1": [str(i % 3) for i in range(32)],
    })
    df.loc[df.index % 7 == 0, "c1"] = None
    monkeypatch.setenv("DELPHI_CHECKPOINT_DIR", str(tmp_path))
    first = _repair(T, df)
    assert (tmp_path / "phase_detect.pkl").is_file()
    assert (tmp_path / "phase_train.pkl").is_file()
    counters.clear()
    phase_walls.clear()
    second = _repair(T, df)
    assert counters["resilience.checkpoint.hits"] == 2
    assert "repair model training" not in phase_walls
    assert "error detection" not in phase_walls
    pd.testing.assert_frame_equal(first, second)
    pd.testing.assert_frame_equal(second, _repair(J, df))


def test_edited_input_invalidates_the_phase_store(tmp_path, monkeypatch):
    df = _table()
    monkeypatch.setenv("DELPHI_CHECKPOINT_DIR", str(tmp_path))
    _repair(T, df)
    edited = df.copy()
    edited.loc[1, "c2"] = "3" if edited.loc[1, "c2"] != "3" else "0"
    counters.clear()
    out = _repair(T, edited)
    assert counters["resilience.checkpoint.stale"] == 2
    assert "resilience.checkpoint.hits" not in counters
    pd.testing.assert_frame_equal(out, _repair(J, edited))


# -- model checkpoints (tests/test_checkpoint_conf.py) ------------------------

def _adult_model(lib, ckpt_dir):
    return lib.delphi.repair \
        .setTableName("adult").setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .option("model.checkpoint_path", str(ckpt_dir))


@pytest.fixture
def adult(adult_df):
    from delphi_tpu_torch.session import get_session
    get_session().register("adult", adult_df)
    yield adult_df
    get_session().drop("adult")


def test_checkpoint_save_and_resume(adult, tmp_path):
    df1 = _adult_model(T, tmp_path).run()
    ckpt = tmp_path / "repair_models.pkl"
    assert ckpt.exists()
    mtime = os.path.getmtime(ckpt)
    counters.clear()
    df2 = _adult_model(T, tmp_path).run()
    assert os.path.getmtime(ckpt) == mtime, "resume must not retrain"
    assert counters["train.checkpoint_hits"] == 1
    key = ["tid", "attribute"]
    pd.testing.assert_frame_equal(
        df1.sort_values(key).reset_index(drop=True),
        df2.sort_values(key).reset_index(drop=True))


def test_checkpoint_stale_targets_ignored(adult, tmp_path):
    _adult_model(T, tmp_path).run()
    df = _adult_model(T, tmp_path).setTargets(["Sex"]).run()
    assert set(df["attribute"]) <= {"Sex"}


def test_checkpoint_stale_data_ignored(adult, adult_df, tmp_path):
    from delphi_tpu_torch.session import get_session
    _adult_model(T, tmp_path).run()
    ckpt = tmp_path / "repair_models.pkl"
    mtime = os.path.getmtime(ckpt)
    changed = adult_df.copy()
    changed.loc[0, "Country"] = "Elbonia"
    get_session().register("adult", changed)
    counters.clear()
    _adult_model(T, tmp_path).run()
    assert os.path.getmtime(ckpt) != mtime, "edited data must retrain"
    assert "train.checkpoint_hits" not in counters


def test_checkpoint_survives_relocation(adult, tmp_path):
    src, dst = tmp_path / "a", tmp_path / "b"
    _adult_model(T, src).run()
    shutil.move(str(src), str(dst))
    ckpt = dst / "repair_models.pkl"
    mtime = os.path.getmtime(ckpt)
    _adult_model(T, dst).run()
    assert os.path.getmtime(ckpt) == mtime, "relocated checkpoint must reuse"


def test_checkpoint_unreadable_file_ignored(adult, tmp_path):
    (tmp_path / "repair_models.pkl").write_bytes(b"not a pickle")
    counters.clear()
    df = _adult_model(T, tmp_path).run()
    assert len(df) > 0
    assert counters["store.quarantined"] == 1
    assert any((tmp_path / "quarantine").iterdir())


# -- fingerprints equal across the packages -----------------------------------

def _fingerprints(lib, df, options, rules, thres):
    m = lib.delphi.repair.setInput(df.copy()).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector()]) \
        .setDiscreteThreshold(thres).setRepairByRules(rules)
    for k, v in options.items():
        m = m.option(k, v)
    table, _, continuous = m._check_input_table()
    masked = table.with_nulls_at_arrays(
        np.array([0, 3], dtype=np.int64), np.array(["c1", "c2"], dtype=object))
    rz = j_rz if lib is J else t_rz
    return (rz.fingerprint_digest(m._phase_fingerprint(table, continuous)),
            rz.fingerprint_digest(m._checkpoint_fingerprint(
                masked, ["c2", "c1"])),
            m._table_content_sha1(table))


@pytest.mark.parametrize("options,rules,thres,sampled", [
    ({}, False, 80, False),
    ({"model.hp.max_evals": "1", "model.checkpoint_path": "x"}, True, 30,
     False),
    ({"error.max_attrs_to_compute_pairwise_stats": "4"}, False, 80, True),
])
def test_fingerprint_digests_equal_jax(options, rules, thres, sampled,
                                       monkeypatch):
    if sampled:
        monkeypatch.setenv("DELPHI_CHECKPOINT_SAMPLED_HASH", "1")
    df = _table(200, seed=4)
    df["n"] = np.arange(200) * 0.5
    got = _fingerprints(T, df, options, rules, thres)
    assert got == _fingerprints(J, df, options, rules, thres)
    assert got != _fingerprints(T, _table(200, seed=5).assign(
        n=np.arange(200) * 0.5), options, rules, thres)


# -- checkpoints the JAX package wrote ----------------------------------------

_READ_JAX_CHECKPOINTS = """
import json, os, sys
import pandas as pd
import delphi_tpu_torch as T
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.utils import counters
d = sys.argv[1]
df = pd.read_pickle(os.path.join(d, "input.pkl"))
get_session().register("ckpt_input", df)
fresh = T.delphi.repair.setTableName("ckpt_input").setRowId("tid") \\
    .setErrorDetectors([T.NullErrorDetector()]).run()
counters.clear()
os.environ["DELPHI_CHECKPOINT_DIR"] = os.path.join(d, "phase")
out = T.delphi.repair.setTableName("ckpt_input").setRowId("tid") \\
    .setErrorDetectors([T.NullErrorDetector()]) \\
    .option("model.checkpoint_path", os.path.join(d, "model")).run()
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "delphi_tpu" or m.startswith("delphi_tpu."))
print(json.dumps({"equal": bool(out.equals(fresh)),
                  "counters": dict(counters), "mods": mods}))
"""


def test_jax_written_checkpoints_read_as_corrupt_without_jax(tmp_path,
                                                             monkeypatch):
    """The JAX package's phase_detect.pkl, phase_train.pkl and
    repair_models.pkl, for the same table and options (equal
    fingerprints), each read as corrupt in a process that never loads
    JAX: quarantined, counted, recomputed; the frame equals a fresh
    run's."""
    df = _table()
    df.to_pickle(tmp_path / "input.pkl")
    monkeypatch.setenv("DELPHI_CHECKPOINT_DIR", str(tmp_path / "phase"))
    _repair(J, df, **{"model.checkpoint_path": str(tmp_path / "model")})
    for f in ("phase/phase_detect.pkl", "phase/phase_train.pkl",
              "model/repair_models.pkl"):
        assert (tmp_path / f).is_file(), f
    env = {k: v for k, v in os.environ.items()
           if k not in ("DELPHI_TORCH_DEVICE", "PYTHONPATH",
                        "DELPHI_CHECKPOINT_DIR")}
    env.update(DELPHI_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _READ_JAX_CHECKPOINTS, str(tmp_path)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mods"] == [] and out["equal"]
    c = out["counters"]
    assert c["resilience.checkpoint.corrupt"] == 2
    assert c["store.quarantined"] == 3
    assert c.get("resilience.checkpoint.hits", 0) == 0
    assert "train.checkpoint_hits" not in c
    assert len(list((tmp_path / "phase" / "quarantine").iterdir())) == 2
    assert len(list((tmp_path / "model" / "quarantine").iterdir())) == 1
    # the port rewrote all three files, its own now
    for f in ("phase/phase_detect.pkl", "phase/phase_train.pkl",
              "model/repair_models.pkl"):
        assert (tmp_path / f).is_file(), f


def test_checkpoint_pickles_hold_cpu_tensors_only(tmp_path):
    """A pickle the store writes holds the CPU copy of every tensor and
    leaves the object it pickled as it was."""
    from delphi_tpu_torch.parallel import store
    t = torch.arange(3.0)
    store.write_pickle(str(tmp_path / "x.pkl"), {"t": t, "l": [t * 2]},
                       schema="phase_ckpt", site="store.checkpoint")
    got, status = store.read_pickle(str(tmp_path / "x.pkl"),
                                    schema="phase_ckpt",
                                    site="store.checkpoint")
    assert status == "ok" and got["t"].device.type == "cpu"
    assert torch.equal(got["l"][0], t * 2)
