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
