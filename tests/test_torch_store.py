"""The port's durable store (``delphi_tpu_torch/parallel/store.py``, its
write and read side) against the JAX package's: the same envelope bytes
for the same rows, and each package reads the other's files back."""

import os

import pytest

from delphi_tpu.parallel import store as j_store
from delphi_tpu_torch.parallel import store as t_store

ROWS = [{"row_id": "1", "attribute": "a", "detectors": ["d"],
         "top_k": [{"value": "x", "prob": 0.25}], "confidence": 0.25},
        {"row_id": 2, "attribute": "b", "current_value": None,
         "decision": "kept", "note": "é"},
        {"note": "cpu_fallback", "detail": "shrink", "seq": 0}]


def test_envelope_bytes_match_jax():
    for payload in (b"", b"abc\n", "é\n".encode("utf-8")):
        assert t_store.encode_envelope(payload, "provenance") == \
            j_store.encode_envelope(payload, "provenance")
    blob = j_store.encode_envelope(b"xyz", "run_report")
    assert t_store.decode_envelope(blob, "run_report") == (b"xyz",
                                                            "run_report")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_write_jsonl_files_match_and_read_across(tmp_path, writer):
    j_path, t_path = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    j_store.write_jsonl(j_path, ROWS, schema="provenance",
                        site="store.provenance")
    t_store.write_jsonl(t_path, ROWS, schema="provenance",
                        site="store.provenance")
    with open(j_path, "rb") as a, open(t_path, "rb") as b:
        j_bytes, t_bytes = a.read(), b.read()
    assert t_bytes == j_bytes
    assert t_bytes.startswith(b"#DELPHI-STORE v1 provenance ")
    path = j_path if writer == "jax" else t_path
    want = [{k: v for k, v in r.items()} for r in ROWS]
    rows, status = t_store.read_jsonl(path, schema="provenance",
                                      site="store.provenance")
    assert (rows, status) == (want, "ok")
    rows, status = j_store.read_jsonl(path, schema="provenance",
                                      site="store.provenance")
    assert (rows, status) == (want, "ok")
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".store_")]


def test_read_reports_missing_legacy_and_corrupt(tmp_path):
    path = str(tmp_path / "p.jsonl")
    assert t_store.read_jsonl(path, schema="provenance",
                              site="store.provenance") == (None, "missing")
    with open(path, "wb") as f:
        f.write(b'{"a": 1}\n')
    assert t_store.read_bytes(path, schema="provenance",
                              site="store.provenance") == (b'{"a": 1}\n',
                                                           "legacy")
    t_store.write_jsonl(path, ROWS, schema="provenance",
                        site="store.provenance")
    with open(path, "rb") as f:
        blob = f.read()
    for bad in (blob[:-3], blob.replace(b"provenance", b"run_report", 1),
                blob[:-2] + b"!\n"):
        with open(path, "wb") as f:
            f.write(bad)
        assert t_store.read_jsonl(path, schema="provenance",
                                  site="store.provenance") == (None,
                                                               "corrupt")
        with pytest.raises(t_store.StoreCorrupt):
            t_store.decode_envelope(bad, "provenance")


# -- the rest of the store: quarantine, fault sites, quota GC, fsck ----------
#
# The cases of tests/test_store.py on the port's store, plus cross reads of
# JSON files and the fault plan's store sites against the JAX package's.

import json  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

from delphi_tpu.incremental import manifest as j_mf  # noqa: E402
from delphi_tpu.parallel import resilience as j_rz  # noqa: E402
from delphi_tpu_torch.incremental import manifest as t_mf  # noqa: E402
from delphi_tpu_torch.parallel import resilience as t_rz  # noqa: E402
from delphi_tpu_torch.utils import counters  # noqa: E402

_STORE_ENV = ("DELPHI_FAULT_PLAN", "DELPHI_STORE_QUOTA_GB",
              "DELPHI_STORE_GC_INTERVAL_S", "DELPHI_STORE_GC_LOCK_STALE_S",
              "DELPHI_SNAPSHOT_CHAIN_KEEP")


@pytest.fixture(autouse=True)
def _clean_store_state(monkeypatch):
    for var in _STORE_ENV:
        monkeypatch.delenv(var, raising=False)
    for mod in (t_rz, j_rz):
        mod.reset_fault_state()
    t_store.reset_gc_state()
    counters.clear()
    yield
    for mod in (t_rz, j_rz):
        mod.reset_fault_state()
    t_store.reset_gc_state()


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DELPHI_FAULT_PLAN")}
    env.update(DELPHI_TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu")
    return env


def test_json_and_pickle_roundtrips(tmp_path):
    root = str(tmp_path)
    jp = os.path.join(root, "a.json")
    t_store.write_json(jp, {"k": [1, 2]}, schema="run_report",
                       site="store.report", root=root)
    assert t_store.read_json(jp, schema="run_report", site="store.report",
                             root=root) == ({"k": [1, 2]}, "ok")
    lines = open(jp).read().splitlines()
    assert lines[0].startswith("#DELPHI-STORE v1 run_report ")
    assert json.loads(lines[1]) == {"k": [1, 2]}
    pp = os.path.join(root, "a.pkl")
    t_store.write_pickle(pp, {"arr": (1, 2)}, schema="phase_ckpt",
                         site="store.checkpoint", root=root)
    assert t_store.read_pickle(pp, schema="phase_ckpt",
                               site="store.checkpoint",
                               root=root) == ({"arr": (1, 2)}, "ok")


def test_legacy_raw_json_reads_through(tmp_path):
    path = str(tmp_path / "old.json")
    with open(path, "w") as f:
        json.dump({"pre": "seam"}, f)
    assert t_store.read_json(path, schema="run_report", site="store.report",
                             root=str(tmp_path)) == ({"pre": "seam"},
                                                     "legacy")
    assert os.path.exists(path)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_json_files_read_ok_in_the_other_package(tmp_path, writer):
    """A JSON file (a snapshot manifest) written by either package reads
    ``ok`` and equal in both."""
    path = str(tmp_path / "m.json")
    doc = {"version": 1, "snapshot_id": "0123456789abcdef",
           "columns": {"c": {"block_sha1": ["x"]}}, "v": [1.5, None, "é"]}
    store = j_store if writer == "jax" else t_store
    store.write_json(path, doc, schema="snapshot_manifest",
                     site="store.manifest", root=str(tmp_path), indent=1)
    for reader in (j_store, t_store):
        assert reader.read_json(path, schema="snapshot_manifest",
                                site="store.manifest",
                                root=str(tmp_path)) == (doc, "ok")


def _tear_offsets(blob: bytes):
    header_end = blob.index(b"\n") + 1
    return sorted({0, 1, len(t_store.MAGIC) - 1, header_end - 1,
                   header_end, header_end + 1, len(blob) // 2,
                   len(blob) - 1})


def test_truncation_at_every_boundary_reads_as_miss(tmp_path):
    root = str(tmp_path)
    payload = {"phases": {"freq": {"chunks": [4, 4]}}}
    offsets = _tear_offsets(t_store.encode_envelope(
        (json.dumps(payload) + "\n").encode(), "launch_plan"))
    for i, cut in enumerate(offsets):
        path = os.path.join(root, f"plan_{i}.json")
        t_store.write_json(path, payload, schema="launch_plan",
                           site="store.plan", root=root)
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:cut])
        assert t_store.read_json(path, schema="launch_plan",
                                 site="store.plan",
                                 root=root) == (None, "corrupt"), cut
        assert not os.path.exists(path), cut
    assert t_store.quarantine_count(root) == len(offsets)


def test_bit_flip_in_payload_is_quarantined(tmp_path):
    root = str(tmp_path)
    path = os.path.join(root, "r.json")
    t_store.write_json(path, {"v": 1}, schema="run_report",
                       site="store.report", root=root)
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(blob))
    counters.clear()
    assert t_store.read_json(path, schema="run_report", site="store.report",
                             root=root) == (None, "corrupt")
    assert counters["store.corrupt"] == 1
    assert counters["store.quarantined"] == 1
    assert counters["resilience.faults.store_corrupt"] == 1
    assert os.listdir(t_store.quarantine_dir(root)) == ["r.json"]


def test_pickle_of_a_foreign_class_is_corrupt_and_imports_nothing(tmp_path):
    """A pickle naming a class outside the admitted modules (here a JAX
    package class) reads as corrupt and is quarantined; a pickle of plain
    values the JAX package wrote reads ok."""
    from delphi_tpu.model import PoorModel
    root = str(tmp_path)
    plain = os.path.join(root, "plain.pkl")
    j_store.write_pickle(plain, {"a": [1, 2.5, "x"]}, schema="snapshot_state",
                         site="store.snapshot_state", root=root)
    assert t_store.read_pickle(plain, schema="snapshot_state",
                               site="store.snapshot_state",
                               root=root) == ({"a": [1, 2.5, "x"]}, "ok")
    foreign = os.path.join(root, "state.pkl")
    t_store.write_bytes(foreign, pickle.dumps({"m": PoorModel("v")}),
                        schema="snapshot_state",
                        site="store.snapshot_state", root=root)
    assert t_store.read_pickle(foreign, schema="snapshot_state",
                               site="store.snapshot_state",
                               root=root) == (None, "corrupt")
    assert os.listdir(t_store.quarantine_dir(root)) == ["state.pkl"]


def test_injected_torn_write_surfaces_at_next_read(tmp_path, monkeypatch):
    root = str(tmp_path)
    path = os.path.join(root, "plan.json")
    monkeypatch.setenv("DELPHI_FAULT_PLAN", "store.plan:1:torn_write")
    t_store.write_json(path, {"v": 1}, schema="launch_plan",
                       site="store.plan", root=root)
    assert os.path.exists(path)
    assert t_store.read_json(path, schema="launch_plan", site="store.plan",
                             root=root) == (None, "corrupt")
    t_store.write_json(path, {"v": 2}, schema="launch_plan",
                       site="store.plan", root=root)
    assert t_store.read_json(path, schema="launch_plan", site="store.plan",
                             root=root) == ({"v": 2}, "ok")
    assert counters["store.torn_writes"] == 1
    assert counters["store.corrupt"] == 1
    assert [n for n in os.listdir(root) if n.startswith(".store_")] == []


@pytest.mark.parametrize("plan", ["store.manifest:2:torn_write",
                                  "store.*:3:torn_write"])
def test_torn_write_tears_as_the_jax_package_does(tmp_path, monkeypatch,
                                                  plan):
    """The same plan tears the same write of the same bytes at the same
    offset in both packages (the snapshot manifest's site)."""
    monkeypatch.setenv("DELPHI_FAULT_PLAN", plan)
    torn = []
    for name, store in (("jax", j_store), ("torch", t_store)):
        path = str(tmp_path / name / "manifest.json")
        for gen in range(3):
            store.write_json(path, {"gen": gen, "pad": "x" * 40},
                             schema="snapshot_manifest",
                             site="store.manifest",
                             root=str(tmp_path / name))
            if gen == 1:
                torn.append(open(path, "rb").read())
    assert torn[1] == torn[0]
    whole = t_store.encode_envelope(
        (json.dumps({"gen": 1, "pad": "x" * 40}, sort_keys=True)
         + "\n").encode(), "snapshot_manifest")
    if plan.endswith(":2:torn_write"):
        assert 0 < len(torn[1]) < len(whole)  # generation 1 torn
    else:
        assert torn[1] == whole


_CRASH = """
import os, sys
os.environ["DELPHI_FAULT_PLAN"] = sys.argv[2]
from delphi_tpu_torch.parallel import store
store.write_json(sys.argv[1], {"gen": 2}, schema="launch_plan",
                 site="store.plan", root=os.path.dirname(sys.argv[1]))
raise SystemExit(99)  # unreachable: the crash fires mid-write
"""


@pytest.mark.parametrize("plan", ["store.plan:1:crash", "store.*:1:crash"])
def test_injected_crash_kills_process_before_rename(tmp_path, plan):
    """``crash`` exits with code 23 after the temporary file's fsync,
    before the rename: the destination keeps the previous generation, and
    fsck reclaims the temporary file."""
    root = str(tmp_path)
    path = os.path.join(root, "plan.json")
    t_store.write_json(path, {"gen": 1}, schema="launch_plan",
                       site="store.plan", root=root)
    proc = subprocess.run([sys.executable, "-c", _CRASH, path, plan],
                          env=_env(), capture_output=True, timeout=240,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 23, proc.stderr.decode()[-800:]
    assert t_store.read_json(path, schema="launch_plan", site="store.plan",
                             root=root) == ({"gen": 1}, "ok")
    assert len([n for n in os.listdir(root)
                if n.startswith(".store_")]) == 1
    summary = t_store.fsck(root)
    assert summary["tmp_removed"] == 1 and summary["corrupt"] == 0
    assert [n for n in os.listdir(root) if n.startswith(".store_")] == []


def _fill(root, name, nbytes, age_s, now):
    path = os.path.join(root, name)
    t_store.write_bytes(path, b"x" * nbytes, schema="model_ckpt",
                        site="store.model", root=root)
    os.utime(path, (now - age_s, now - age_s))
    return path


def test_gc_evicts_lru_until_under_quota_and_respects_protect(tmp_path):
    root = str(tmp_path)
    now = time.time()
    old = _fill(root, "cold.bin", 4000, 500, now)
    protected = _fill(root, "warm/keep.bin", 4000, 400, now)
    young = _fill(root, "hot.bin", 4000, 5, now)
    counters.clear()
    summary = t_store.gc_sweep(root, quota=9000,
                               protect=[os.path.join(root, "warm")], now=now)
    assert summary["evicted_files"] == 1
    assert not os.path.exists(old)
    assert os.path.exists(protected) and os.path.exists(young)
    assert counters["store.gc.sweeps"] == 1
    assert counters["store.gc.evicted_files"] == 1


def test_gc_removes_only_stale_tmp_debris(tmp_path):
    root = str(tmp_path)
    now = time.time()
    stale = os.path.join(root, ".store_orphan")
    live = os.path.join(root, ".store_inflight")
    for p, age in ((stale, 300), (live, 1)):
        with open(p, "wb") as f:
            f.write(b"partial")
        os.utime(p, (now - age, now - age))
    summary = t_store.gc_sweep(root, quota=1 << 30, now=now)
    assert summary["tmp_removed"] == 1
    assert not os.path.exists(stale) and os.path.exists(live)


def test_gc_lock_excludes_concurrent_sweepers(tmp_path, monkeypatch):
    root = str(tmp_path)
    lock = os.path.join(root, ".store_gc.lock")
    with open(lock, "w") as f:
        f.write("held\n")
    assert t_store.gc_sweep(root, quota=100) == {"skipped": "locked"}
    assert counters["store.gc.lock_busy"] == 1
    monkeypatch.setenv("DELPHI_STORE_GC_LOCK_STALE_S", "1")
    os.utime(lock, (time.time() - 900, time.time() - 900))
    assert "skipped" not in t_store.gc_sweep(root, quota=1 << 30)
    assert not os.path.exists(lock)


def test_gc_never_evicts_quarantine(tmp_path):
    root = str(tmp_path)
    path = os.path.join(root, "bad.json")
    t_store.write_json(path, {"v": 1}, schema="run_report",
                       site="store.report", root=root)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:10])
    assert t_store.read_json(path, schema="run_report", site="store.report",
                             root=root)[1] == "corrupt"
    assert t_store.quarantine_count(root) == 1
    t_store.gc_sweep(root, quota=0, now=time.time())
    assert t_store.quarantine_count(root) == 1


def test_env_quota_arms_automatic_post_write_gc(tmp_path, monkeypatch):
    root = str(tmp_path)
    cold = os.path.join(root, "cold.json")
    hot = os.path.join(root, "hot.json")
    t_store.write_json(cold, {"blob": "x" * 4096}, schema="plan",
                       site="store.plan", root=root)
    old = time.time() - 3600
    os.utime(cold, (old, old))
    monkeypatch.setenv("DELPHI_STORE_QUOTA_GB", "1e-6")  # ~1073 bytes
    monkeypatch.setenv("DELPHI_STORE_GC_INTERVAL_S", "0")
    t_store.reset_gc_state()
    t_store.write_json(hot, {"ok": 1}, schema="plan", site="store.plan",
                       root=root)
    assert not os.path.exists(cold)
    assert t_store.read_json(hot, schema="plan", site="store.plan",
                             root=root) == ({"ok": 1}, "ok")


def test_concurrent_writers_and_gc_on_one_root(tmp_path):
    root = str(tmp_path)
    errors = []

    def writer():
        try:
            for i in range(30):
                t_store.write_json(os.path.join(root, "doc.json"), {"i": i},
                                   schema="run_report", site="store.report",
                                   root=root)
        except Exception as e:  # pragma: no cover - the assertion target
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    for _ in range(10):
        t_store.gc_sweep(root, quota=1 << 30)
    t.join(timeout=120)
    assert not t.is_alive() and errors == []
    assert t_store.read_json(os.path.join(root, "doc.json"),
                             schema="run_report", site="store.report",
                             root=root) == ({"i": 29}, "ok")


def test_fsck_buckets_ok_legacy_corrupt_and_repairs(tmp_path):
    root = str(tmp_path)
    t_store.write_json(os.path.join(root, "good.json"), {"v": 1},
                       schema="run_report", site="store.report", root=root)
    with open(os.path.join(root, "old.json"), "w") as f:
        json.dump({"pre": "seam"}, f)
    bad = os.path.join(root, "torn.json")
    t_store.write_json(bad, {"v": 2}, schema="launch_plan",
                       site="store.plan", root=root)
    blob = open(bad, "rb").read()
    with open(bad, "wb") as f:
        f.write(blob[:-4])
    orphan = os.path.join(root, ".store_orphan")
    with open(orphan, "wb") as f:
        f.write(b"junk")
    os.utime(orphan, (time.time() - 300,) * 2)

    report_only = t_store.fsck(root, repair=False)
    assert report_only["corrupt"] == 1 and report_only["quarantined"] == 0
    assert os.path.exists(bad)
    want = j_store.fsck(root, repair=False)
    assert {k: v for k, v in report_only.items() if k != "gc"} == \
        {k: v for k, v in want.items() if k != "gc"}

    summary = t_store.fsck(root)
    assert summary["ok"] == 1 and summary["legacy"] == 1
    assert summary["corrupt"] == 1 and summary["quarantined"] == 1
    assert summary["tmp_removed"] == 1
    assert summary["per_store"]["run_report"]["ok"] == 1
    assert summary["per_store"]["launch_plan"]["corrupt"] == 1
    assert summary["per_store"]["(legacy)"]["legacy"] == 1
    assert not os.path.exists(bad)
    again = t_store.fsck(root)
    assert again["corrupt"] == 0 and again["quarantine_files"] == 1


def test_fsck_cli_exit_codes(tmp_path):
    root = str(tmp_path)
    t_store.write_json(os.path.join(root, "good.json"), {"v": 1},
                       schema="run_report", site="store.report", root=root)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "delphi_tpu_torch.main", "--fsck", root]
    clean = subprocess.run(cmd, env=_env(), capture_output=True,
                           timeout=240, cwd=repo)
    assert clean.returncode == 0, clean.stderr.decode()[-800:]
    assert json.loads(clean.stdout)["corrupt"] == 0
    bad = os.path.join(root, "torn.json")
    t_store.write_json(bad, {"v": 2}, schema="launch_plan",
                       site="store.plan", root=root)
    blob = open(bad, "rb").read()
    with open(bad, "wb") as f:
        f.write(blob[:-2])
    dirty = subprocess.run(cmd, env=_env(), capture_output=True,
                           timeout=240, cwd=repo)
    assert dirty.returncode == 4, dirty.stderr.decode()[-800:]
    assert json.loads(dirty.stdout)["corrupt"] == 1
    assert t_store.quarantine_count(root) == 1


def test_manifest_chain_archives_and_compacts(tmp_path, monkeypatch):
    snap = str(tmp_path / "snap")
    ids = []
    for gen in range(4):
        t_mf.write_snapshot(snap, {"version": t_mf.MANIFEST_VERSION,
                                   "snapshot_id": f"{gen:016x}",
                                   "n_rows": 3}, {"gen": gen})
        ids.append(f"{gen:016x}")
    assert len(t_mf.chain_files(snap)) == 3
    cur = t_mf.load_manifest(snap)
    assert cur["snapshot_id"] == ids[-1]
    assert cur["parent_snapshot_id"] == ids[-2]
    # the JAX package reads the port's chain head and state alike
    assert j_mf.load_manifest(snap) == cur
    assert j_mf.load_state(snap) == t_mf.load_state(snap) == {"gen": 3}
    monkeypatch.setenv("DELPHI_SNAPSHOT_CHAIN_KEEP", "1")
    assert t_mf.compact_chain(snap) == 2
    assert len(t_mf.chain_files(snap)) == 1
    assert t_mf.compact_chain(snap, keep=0) == 1
    assert t_mf.chain_files(snap) == []
    assert t_mf.load_manifest(snap)["snapshot_id"] == ids[-1]


def test_fault_plan_check_counts_unmatched_and_refuses_unported(
        monkeypatch, tmp_path):
    """A pattern that names no guarded site is counted and never fires;
    every other entry, at any site and of any kind, now fires as in the
    JAX package (none raises NotImplementedError); a malformed plan raises
    ValueError in both packages."""
    monkeypatch.setenv("DELPHI_FAULT_PLAN",
                       "store.nonexistent:1:crash,store.*:2:torn_write")
    t_rz.reset_fault_state()
    t_store.write_json(str(tmp_path / "a.json"), {"v": 1},
                       schema="launch_plan", site="store.plan")
    assert counters["resilience.plan.unmatched"] == 1
    for plan, site in (("xfer.upload:1:transfer", "xfer.upload"),
                       ("store.plan:1:oom", "store.plan")):
        monkeypatch.setenv("DELPHI_FAULT_PLAN", plan)
        fired = []
        for rz, store in ((j_rz, j_store), (t_rz, t_store)):
            rz.reset_fault_state()
            with pytest.raises(rz.FaultInjected) as e:
                if site.startswith("store."):
                    store.write_json(str(tmp_path / "b.json"), {"v": 2},
                                     schema="launch_plan", site=site)
                else:
                    rz._maybe_inject(site)
            fired.append((str(e.value), rz.classify_fault(e.value)))
        assert fired[0] == fired[1]
    # a rank-scoped entry for another rank never fires here; a stall wedges
    stalls = []
    monkeypatch.setattr(t_rz, "_stall_forever", lambda: stalls.append(1))
    for plan in ("1:store.plan:1:crash", "store.plan:1:stall"):
        monkeypatch.setenv("DELPHI_FAULT_PLAN", plan)
        t_rz.reset_fault_state()
        t_store.write_json(str(tmp_path / "c.json"), {"v": 3},
                           schema="launch_plan", site="store.plan")
    assert stalls == [1]
    for plan in ("store.plan:0:crash", "store.plan:1:melt", "nonsense"):
        monkeypatch.setenv("DELPHI_FAULT_PLAN", plan)
        with pytest.raises(ValueError):
            j_rz.parse_fault_plan(plan)
        t_rz.reset_fault_state()
        with pytest.raises(ValueError):
            t_rz._maybe_inject("store.plan")
