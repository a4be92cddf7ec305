"""The port's transfer ledger (``delphi_tpu_torch/ops/xfer.py``) against
the JAX package's (``delphi_tpu/ops/xfer.py``): the same uploads, cache
hits and evictions under one recorder span give the same counters and the
same ``/metrics`` lines in both packages. The whole-run reconciliation is
``tests/test_torch_run_report.py``'s."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delphi_tpu import observability as j_obs
from delphi_tpu.observability import live as j_live
from delphi_tpu.observability import spans as j_spans
from delphi_tpu.ops import xfer as j_xfer
import delphi_tpu_torch as T
from delphi_tpu_torch import observability as t_obs
from delphi_tpu_torch.observability import live as t_live
from delphi_tpu_torch.observability import spans as t_spans
from delphi_tpu_torch.ops import xfer as t_xfer


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the JAX package's content-addressed layer (DELPHI_XFER_CONTENT_CACHE)
    # has no port counterpart: each test's columns are fresh objects of
    # fresh codes, so it never hits here
    T.set_device("cpu")
    yield
    T.set_device(None)


def _column(codes, vocab):
    return types.SimpleNamespace(name="c", codes=codes, domain_size=vocab)


def _session(obs, spans, xfer, live, to_dev, dtypes):
    """Uploads, reuses and evictions under two spans; returns (counters,
    the ``transfer`` lines of ``/metrics``)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(-1, 9, 1000).astype(np.int32)
    col = _column(codes, 9)
    rec = obs.start_recording("xfer-parity")
    try:
        outer = spans.span_enter("error detection")
        try:
            xfer.to_device(rng.normal(size=(7, 3)))              # f64
            xfer.to_device(np.arange(10, dtype=np.int64), dtypes[0])
            xfer.to_device(np.ones(5, np.float32), dtypes[1])
            xfer.device_codes(col)
            xfer.device_codes(col)                               # a reuse
        finally:
            spans.span_exit(outer)
        inner = spans.span_enter("cell domain analysis")
        try:
            on_device = to_dev(np.zeros(4, np.float32))
            xfer.to_device(on_device)                            # a reuse
            assert xfer.evict_device_codes([col]) in (None, 1)
            xfer.device_codes(col)                               # again
            text = live.render_prometheus(rec)
        finally:
            spans.span_exit(inner)
        counters = {k: v for k, v in rec.registry.snapshot()["counters"]
                    .items() if k.startswith("transfer.")}
    finally:
        obs.stop_recording(rec)
    lines = [ln for ln in text.splitlines() if "transfer" in ln]
    return counters, lines


def test_ledger_counters_and_metrics_equal_jax(monkeypatch):
    monkeypatch.setenv("DELPHI_XFER_CONTENT_CACHE", "0")
    want = _session(j_obs, j_spans, j_xfer, j_live, jnp.asarray,
                    (np.int32, np.float64))
    got = _session(t_obs, t_spans, t_xfer, t_live, torch.from_numpy,
                   (torch.int32, torch.float64))
    assert got == want
    counters = got[0]
    assert counters["transfer.calls"] == 5
    assert counters["transfer.bytes"] == 7 * 3 * 8 + 10 * 4 + 5 * 8 \
        + 2 * 1000 * 4
    assert counters["transfer.phase.error_detection.calls"] == 4
    assert counters["transfer.phase.cell_domain_analysis.bytes"] == 4000
    assert counters["transfer.reuses"] == 2
    assert counters["transfer.evictions"] == 1
    assert "delphi_transfer_phase_error_detection_bytes 4248" in got[1]


def test_ledger_counts_outside_a_recording_too():
    """Without a run recorder the totals still count (the process-wide
    counters), and no phase key appears."""
    from delphi_tpu_torch.utils import counters
    counters.clear()
    t_xfer.to_device(np.zeros(3, np.int32))
    assert counters["transfer.calls"] == 1
    assert counters["transfer.bytes"] == 12
    assert not any(k.startswith("transfer.phase.") for k in counters)
