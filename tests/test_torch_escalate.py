"""The port's escalation tier (``delphi_tpu_torch/escalate``, K8 in
``delphi_tpu_torch/ops/joint.py``) against the JAX package's, on the CPU.

* The router, the budget and pattern induction on the JAX package's own
  cases (``tests/test_escalate.py``), against the JAX functions.
* K8 against ``delphi_tpu.ops.joint._jit_joint_ascent`` on the chain
  fixture and on random padded buckets: beliefs within 1e-5, the argmax
  equal, and the port bit-deterministic across two calls.
* ``run_joint_tier``: the same proposals; the launch grouping equal to the
  JAX planner's ``plan_launches(..., pad_batch=True, persist=False)``.
* End to end on ``bench._escalate_frames`` (64 rows at the default discrete
  threshold, 2,000 rows at a threshold of 200 so that the ``c2`` code,
  whose broken spellings double its vocabulary, stays a target and its
  cells route): off by default, the candidates frame, ``routed_cells``,
  ``escalated_cells`` and the summary equal to the JAX package's, budget
  exhaustion, an explicit ``"false"``, and the adapter tier hard off,
  ``mock`` when allowed, with a static guard that ``resolve_adapter`` is
  the only way to build one. ``c2`` has more than 24 classes, so it trains
  the logistic head, whose f32 Adam steps end a step apart in the two
  packages (``ROADMAP.md`` queue 3, "Adam's exit step"): these runs
  repair with the JAX package's models (``from_state``), so what is held
  is the escalation pass, not the models.
"""

import ast
import inspect
import pathlib
import re

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu.escalate import joint as j_joint
from delphi_tpu.escalate import patterns as j_patterns
from delphi_tpu.escalate import router as j_router
from delphi_tpu.ops import joint as j_kernel
from delphi_tpu.parallel import planner
from delphi_tpu.table import encode_table as j_encode
from delphi_tpu_torch import escalate as t_esc
from delphi_tpu_torch.escalate import adapter as t_adapter
from delphi_tpu_torch.escalate import joint as t_joint
from delphi_tpu_torch.escalate import patterns as t_patterns
from delphi_tpu_torch.escalate import router as t_router
from delphi_tpu_torch.ops import joint as t_kernel
from delphi_tpu_torch.table import encode_table as t_encode
from delphi_tpu_torch.utils import counters

from test_torch_provenance import carry_jax_models

_ENV = ("DELPHI_ESCALATE", "DELPHI_ESCALATE_CONF", "DELPHI_ESCALATE_BUDGET",
        "DELPHI_ESCALATE_ITERS", "DELPHI_ESCALATE_ADAPTER",
        "DELPHI_ESCALATE_ADAPTER_CALLS", "DELPHI_PROVENANCE_PATH")
BELIEF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_and_clean_env(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


# ---------------------------------------------------------------- router --

def _entry(rid, attr, reason=None, conf=None):
    return {"row_id": rid, "attribute": attr, "decision_reason": reason,
            "confidence": conf}


def _routed(cells):
    return [(c.row_id, c.attribute, c.row_pos, c.current_value,
             c.confidence, c.route_reason) for c in cells]


def test_router_matches_jax():
    index = {(r, "a"): (int(r), f"v{r}") for r in "0123456"}
    index[("7", "a")] = (7, None)
    entries = [
        _entry("0", "a", conf=0.2), _entry("1", "a", conf=0.9),
        _entry("2", "a"), _entry("3", "a", reason="confidence_unavailable_keep_all"),
        _entry("4", "a", reason="weak_label_clean", conf=0.1),
        _entry("5", "b", conf=0.1), _entry("9", "a", conf=0.1),
        _entry("6", "a", conf=0.4), _entry("7", "a", conf="x"),
    ]
    for thr in (0.5, 0.3):
        want = j_router.select_candidates(entries, index, thr, ["a"])
        got = t_router.select_candidates(entries, index, thr, ["a"])
        assert _routed(got) == _routed(want)
    assert [c[0] for c in _routed(got)] == ["2", "3", "7", "0"]


def test_budget_matches_jax():
    for limit in (0, 2, -1):
        j, t = j_router.Budget(limit), t_router.Budget(limit)
        for n in (1, 1, 2, 1):
            assert t.take(n) == j.take(n)
            assert (t.spent, t.exhausted, t.remaining()) == \
                (j.spent, j.exhausted, j.remaining())


@pytest.mark.parametrize("values", [
    [f"{100 + i % 7}-{10 + i % 8}" for i in range(40)],
    ["alpha beta", "x", "12 monkeys", "no-no_1", "tail spin", "a-1", "bb",
     "9", "c c c", "zz_9"],
    ["abc"] * 10, [str(10 + i) for i in range(10)],
    [f"10{i}-11" for i in range(8)] + ["ab-12", "cd-13"], ["1-2"],
    [f"AB{i % 10}_x" for i in range(30)],
])
def test_pattern_induction_matches_jax(values):
    want = j_patterns.induce_pattern(values)
    assert t_patterns.induce_pattern(values) == want
    if want is None:
        return
    j_rep = j_patterns.InducedPatternRepair(want)
    t_rep = t_patterns.InducedPatternRepair(want)
    for v in values[:5] + ["104x12", "104-12", None, "", "AB3-x", "10-"]:
        assert t_rep.repair(v) == j_rep.repair(v)
    assert sorted(t_patterns.induce_for_attributes({"c": values})) == \
        sorted(j_patterns.induce_for_attributes({"c": values}))


# ---------------------------------------------------------------------- K8 --

def _chain_fixture():
    V, K = 4, 2
    unary = np.zeros((3, V), dtype=np.float32)
    unary[0, 1] = 5.0
    eq = np.eye(V, dtype=np.float32) * 4.0
    nbr_idx = np.full((3, K), -1, dtype=np.int32)
    nbr_pot = np.zeros((3, K, V, V), dtype=np.float32)
    nbr_idx[1, 0], nbr_pot[1, 0] = 0, eq
    nbr_idx[2, 0], nbr_pot[2, 0] = 1, eq
    return unary, nbr_idx, nbr_pot


def _random_bucket(seed, n, n_pad, v, v_pad, k=4):
    rng = np.random.default_rng(seed)
    unary = np.full((n_pad, v_pad), t_kernel.NEG_INF, dtype=np.float32)
    unary[:, 0] = 0.0
    unary[:n, :v] = rng.normal(0, 2, (n, v)).astype(np.float32)
    nbr_idx = np.full((n_pad, k), -1, dtype=np.int32)
    nbr_pot = np.zeros((n_pad, k, v_pad, v_pad), dtype=np.float32)
    for i in range(n):
        for j in range(rng.integers(0, k + 1)):
            nbr_idx[i, j] = rng.integers(0, n)
            nbr_pot[i, j, :v, :v] = np.log(rng.dirichlet(np.ones(v), v))
    return unary, nbr_idx, nbr_pot


def _k8(args, iters):
    return t_kernel.joint_ascent(*(torch.as_tensor(a) for a in args),
                                 iters).numpy()


@pytest.mark.parametrize("case", ["chain", "v5", "v16", "v64"])
@pytest.mark.parametrize("iters", [1, 8, 32])
def test_k8_matches_jax(case, iters):
    if case == "chain":
        args, v = _chain_fixture(), 4
    else:
        v_pad = int(case[1:])
        v = v_pad - 3 if v_pad > 8 else v_pad
        args = _random_bucket(iters + v_pad, 37, 64, v, v_pad)
    want = np.asarray(j_kernel._jit_joint_ascent(*args, iters))
    got = _k8(args, iters)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BELIEF_TOL, rtol=0)
    n = 3 if case == "chain" else 37
    np.testing.assert_array_equal(got[:n, :v].argmax(axis=1),
                                  want[:n, :v].argmax(axis=1))
    again = _k8(args, iters)
    assert np.array_equal(got, again)
    if case == "chain" and iters == 32:
        assert list(got.argmax(axis=1)) == [1, 1, 1]


def test_k8_counts_launches_and_keeps_the_device():
    t_kernel.reset_launches()
    u, i, p = (torch.as_tensor(a) for a in _chain_fixture())
    out = t_kernel.joint_ascent(u, i, p, 4)
    assert out.device == u.device and out.dtype == torch.float32
    assert t_kernel.launches == 1


# ------------------------------------------------------------ joint tier --

def _joint_frame(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, n)
    df = pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "x": [f"x{v}" for v in x],
        "y": [f"y{v}" for v in x],
        "z": [f"z{(v + rng.integers(0, 2)) % 4}" for v in x],
        "w": [f"w{v}" for v in rng.integers(0, 40, n)],
        "q": [f"q{v}" for v in rng.integers(0, 70, n)],
    })
    cells = []
    for r in range(0, n, 7):
        for a in ("y", "z", "w", "q"):
            if rng.random() < 0.5:
                df.loc[r, a] = None
                conf = None if rng.random() < 0.5 else float(rng.random())
                cells.append((str(r), a, r, conf))
    return df, cells


@pytest.mark.parametrize("seed", [0, 1])
def test_run_joint_tier_matches_jax(seed):
    df, cells = _joint_frame(300, seed)
    results = []
    for encode, router, tier in ((j_encode, j_router, j_joint),
                                 (t_encode, t_router, t_joint)):
        masked = encode(df, "tid")
        routed = [router.RoutedCell(r, a, p, None, c, "low_confidence")
                  for r, a, p, c in cells]
        props = tier.run_joint_tier(masked, routed, 0.3, 8)
        results.append([(p.cell.key, p.value, p.belief) for p in props])
    want, got = results
    assert len(want) > 0
    assert [k[:2] for k in got] == [k[:2] for k in want]
    np.testing.assert_allclose([k[2] for k in got], [k[2] for k in want],
                               atol=BELIEF_TOL, rtol=0)


def test_run_joint_tier_recovers_correlated_cells():
    n = 64
    df = pd.DataFrame({
        "tid": [str(i) for i in range(n)],
        "x": [f"x{i % 4}" for i in range(n)],
        "y": [f"y{i % 4}" for i in range(n)],
        "z": [f"z{i % 4}" for i in range(n)],
    })
    df.loc[0, "y"] = None
    df.loc[0, "z"] = None
    counters.clear()
    cells = [t_router.RoutedCell("0", a, 0, None, None,
                                 "confidence_unavailable") for a in "yz"]
    props = t_joint.run_joint_tier(t_encode(df, "tid"), cells, 0.5, 16)
    assert {(p.cell.attribute, p.value) for p in props} == \
        {("y", "y0"), ("z", "z0")}
    assert counters["escalation.joint.launches"] == 1
    assert counters["escalation.joint.cells"] == 2


def test_launch_grouping_matches_planner():
    rng = np.random.default_rng(3)
    sizes = [int(v) for v in rng.choice([1, 2, 3, 4, 5, 9, 16, 17, 33, 64],
                                        size=200)]
    plan = planner.plan_launches(
        "escalation.joint",
        [planner.Piece(key=i, size=1, shape=(planner.pow2_pad(v),))
         for i, v in enumerate(sizes)],
        pad_batch=True, persist=False)
    want = [(int(l.shape[0]), int(l.batch_pad),
             [int(s.key) for s in l.spans])
            for l in sorted(plan.launches, key=lambda l: l.shape[0])]
    assert t_joint.plan_buckets(sizes) == want


# ------------------------------------------------------------ end to end --

def _model(lib, df, options, thr=80):
    m = lib.delphi.repair.setInput(df.copy()).setRowId("tid") \
        .setErrorDetectors([lib.NullErrorDetector(), lib.RegExErrorDetector(
            "c2", "^[0-9]{3}-[0-9]{2}$")]).setDiscreteThreshold(thr)
    for k, v in options.items():
        m = m.option(k, v)
    return m


def _both(monkeypatch, n, options, thr=80):
    """(JAX frame, JAX summary, port frame, port summary) on the fixture,
    the port repairing with the JAX package's models."""
    df, _ = bench._escalate_frames(n)
    carry_jax_models(monkeypatch)
    out = []
    for lib in (J, T):
        m = _model(lib, df, options, thr)
        frame = m.run()
        out += [frame, getattr(m, "_last_escalation", None)]
    return out


def _sans_cells(summary):
    return {k: v for k, v in summary.items()
            if k not in ("routed_cells", "escalated_cells")}


@pytest.mark.parametrize("n,thr", [(64, 80), (2000, 200)])
def test_escalated_run_matches_jax(monkeypatch, n, thr):
    want, ws, got, gs = _both(monkeypatch, n, {"repair.escalate": "true"},
                              thr)
    pd.testing.assert_frame_equal(got, want)
    assert gs["routed_cells"] == ws["routed_cells"]
    assert gs["escalated_cells"] == ws["escalated_cells"]
    assert _sans_cells(gs) == _sans_cells(ws)
    assert gs["escalated"] > 0 and gs["tiers"]["joint"]["attempts"] > 0


def test_escalation_off_by_default_and_for_false(monkeypatch):
    df, _ = bench._escalate_frames(64)
    base = _model(T, df, {})
    plain = base.run()
    assert getattr(base, "_last_escalation", None) is None
    off = _model(T, df, {"repair.escalate": "false"})
    pd.testing.assert_frame_equal(off.run(), plain)
    assert getattr(off, "_last_escalation", None) is None
    assert t_esc.escalation_requested(
        T.delphi.repair.option("repair.escalate", "false")) is False
    assert t_esc.escalation_requested(
        T.delphi.repair.option("repair.escalate", "true")) is True
    assert t_esc.escalation_requested(T.delphi.repair) is False
    monkeypatch.setenv("DELPHI_ESCALATE", "1")
    assert t_esc.escalation_requested(T.delphi.repair) is True
    monkeypatch.setenv("DELPHI_ESCALATE", "off")
    assert t_esc.escalation_requested(T.delphi.repair) is False


def test_budget_exhaustion_matches_jax(monkeypatch):
    want, ws, got, gs = _both(monkeypatch, 64, {
        "repair.escalate": "true", "repair.escalate.budget": "3"})
    pd.testing.assert_frame_equal(got, want)
    assert gs == ws
    assert gs["budget"]["exhausted"] is True and gs["budget"]["spent"] <= 3
    assert gs["tiers"]["joint"]["attempts"] == 0 and gs["escalated"] > 0
    cells = {(str(r), str(a)): v for r, a, v in
             zip(got["tid"], got["attribute"], got["repaired"])}
    for rid, attr, _tier, value in gs["escalated_cells"]:
        assert cells[(rid, attr)] == value


def test_adapter_hard_off_by_default(monkeypatch):
    assert t_adapter.adapter_allowed(None) is False
    assert t_adapter.resolve_adapter(None) is None

    def boom(self, batch):
        raise AssertionError("adapter tier reached without explicit enable")
    monkeypatch.setattr(t_adapter.MockAdapter, "repair", boom)
    df, _ = bench._escalate_frames(64)
    m = _model(T, df, {"repair.escalate": "true"})
    m.run()
    assert m._last_escalation["tiers"]["adapter"] == {
        "allowed": False, "calls": 0, "attempts": 0, "repairs": 0}
    for spelling in ("", "0", "false", "no", "off", " False "):
        monkeypatch.setenv("DELPHI_ESCALATE_ADAPTER", spelling)
        assert t_adapter.resolve_adapter(None) is None


def test_adapter_mock_when_allowed_matches_jax(monkeypatch):
    want, ws, got, gs = _both(monkeypatch, 64, {
        "repair.escalate": "true", "repair.escalate.adapter": "mock"})
    pd.testing.assert_frame_equal(got, want)
    assert gs == ws
    tier = gs["tiers"]["adapter"]
    assert tier["allowed"] is True and tier["repairs"] > 0
    assert 0 < tier["calls"] <= t_adapter.adapter_call_limit()
    monkeypatch.setenv("DELPHI_ESCALATE_ADAPTER",
                       "delphi_tpu_torch.escalate.adapter:MockAdapter")
    assert isinstance(t_adapter.resolve_adapter(None), t_adapter.MockAdapter)
    monkeypatch.setenv("DELPHI_ESCALATE_ADAPTER", "no_such_module:Thing")
    assert t_adapter.resolve_adapter(None) is None


def test_adapter_static_guard_single_gatekeeper():
    """The adapter tier is built through resolve_adapter ONLY, and its
    first act is the allow check."""
    root = pathlib.Path(T.__file__).parent
    construct = re.compile(r"\bMockAdapter\(|\bRepairAdapter\(")
    resolve = re.compile(r"\bresolve_adapter\(")
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        if construct.search(text):
            assert rel == "escalate/adapter.py", rel
        if resolve.search(text):
            assert rel in ("escalate/adapter.py", "escalate/__init__.py"), rel
    fn = ast.parse(inspect.getsource(t_adapter.resolve_adapter)).body[0]
    stmts = [s for s in fn.body
             if not (isinstance(s, ast.Expr)
                     and isinstance(s.value, ast.Constant))]
    assert isinstance(stmts[0], ast.If) \
        and "adapter_allowed" in ast.dump(stmts[0].test)


def test_ledger_entries_of_escalated_run_match_jax(monkeypatch):
    """With a ledger configured, the escalation marks (route reason, tier,
    sticky reason, confidence) land on the same entries."""
    from delphi_tpu.observability import provenance as j_prov
    from delphi_tpu_torch.observability import provenance as t_prov
    from test_torch_provenance import _capture, assert_entries_match
    monkeypatch.setenv("DELPHI_PROVENANCE_PATH", ":memory:")
    j_seen, t_seen = _capture(monkeypatch, j_prov), _capture(monkeypatch,
                                                              t_prov)
    _both(monkeypatch, 64, {"repair.escalate": "true"})
    want, got = j_seen[0].entries(), t_seen[0].entries()
    assert any(e.get("escalation_tier") for e in want)
    assert_entries_match(got, want)
    for g, w in zip(got, want):
        assert g.get("escalation_confidence") == w.get(
            "escalation_confidence") or abs(
            g["escalation_confidence"] - w["escalation_confidence"]) <= 1e-5
