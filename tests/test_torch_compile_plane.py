"""The port's compile plane (``delphi_tpu_torch/parallel/compile_plane.py``)
against ``tests/test_compile_plane.py``: the build cache's hit and miss
counters across two loads, its threshold, the prewarm thread's lifecycle
(a failed load, ``stop()``, a load that succeeds, no thread without work on
the card), and the prewarm plan equal to the JAX package's for the same
tables and options. This host has no ``nvcc``: every build is stubbed to
write a file, and ``ctypes.CDLL`` to return a stand-in library.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

import delphi_tpu_torch as T
from delphi_tpu.gauntlet.scenarios import generate_scenario
from delphi_tpu.parallel import compile_plane as j_plane
from delphi_tpu.parallel import planner as j_planner
from delphi_tpu.table import encode_table as j_encode
from delphi_tpu_torch.ops.kernels import build
from delphi_tpu_torch.parallel import compile_plane, planner
from delphi_tpu_torch.session import get_session as t_session
from delphi_tpu_torch.table import encode_table as t_encode
from delphi_tpu_torch.utils import counters, gauges, histograms


class _FakeLib:
    """Stands in for the loaded library: every entry point accepts its
    ``argtypes`` and ``restype``."""

    class _Fn:
        pass

    def __getattr__(self, name):
        fn = self._Fn()
        self.__dict__[name] = fn
        return fn


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    """``build.build`` writes the hashed library file into its directory
    (after ``delay`` seconds) and counts; loading returns a stand-in."""
    calls = []
    delay = {"s": 0.0}

    def fake_build(ptxas_verbose=False, directory=None):
        directory = directory or build.BUILD_DIR
        path = os.path.join(directory, build._library_name())
        time.sleep(delay["s"])
        os.makedirs(directory, exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"\x7fELF stand-in")
        calls.append(directory)
        return path, ""

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "default"))
    monkeypatch.delenv("DELPHI_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("DELPHI_COMPILE_CACHE_MIN_S", raising=False)
    build.reset_library()
    counters.clear()
    gauges.clear()
    yield calls, delay
    build.reset_library()


def test_cache_hit_miss_counters_across_two_loads(stub_build, tmp_path,
                                                  monkeypatch):
    calls, _ = stub_build
    cache = tmp_path / "cache"
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(cache))
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_MIN_S", "0")
    build.library()
    assert counters == {"compile_cache.requests": 1,
                        "compile_cache.misses": 1}
    assert os.path.exists(os.path.join(str(cache), build._library_name()))
    assert gauges["compile_cache.entries"] == 1
    assert gauges["compile_cache.dir_bytes"] > 0
    # a loaded library is not resolved again until it is forgotten
    build.library()
    assert counters["compile_cache.requests"] == 1
    build.reset_library()
    build.library()
    assert counters == {"compile_cache.requests": 2,
                        "compile_cache.misses": 1, "compile_cache.hits": 1}
    assert len(calls) == 1
    # nothing left in the default build directory but the private ones'
    # parent
    assert not os.path.exists(build._library_path())


def test_cache_on_another_filesystem(stub_build, tmp_path, monkeypatch):
    """A cache directory on another filesystem than the default build
    directory: the miss builds inside the cache directory, so the move
    into the cache never crosses filesystems (a rename across them fails
    with EXDEV, which the stub raises for paths under different top-level
    directories of ``tmp_path``)."""
    import errno
    calls, _ = stub_build
    cache = tmp_path / "other_fs" / "cache"
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(cache))
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_MIN_S", "0")
    real_replace = os.replace

    def filesystem(path):
        return os.path.relpath(path, tmp_path).split(os.sep)[0]

    def replace(src, dst):
        if filesystem(src) != filesystem(dst):
            raise OSError(errno.EXDEV, "Invalid cross-device link")
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    build.library()
    assert counters == {"compile_cache.requests": 1,
                        "compile_cache.misses": 1}
    assert os.path.commonpath([calls[0], str(cache)]) == str(cache)
    assert sorted(os.listdir(cache)) == [build._library_name()]
    assert not os.path.exists(build.BUILD_DIR)


def test_failed_build_leaves_no_work_directory(stub_build, tmp_path,
                                               monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(cache))

    def failing_build(ptxas_verbose=False, directory=None):
        os.makedirs(directory)
        with open(os.path.join(directory, "partial.o"), "wb") as f:
            f.write(b"")
        raise build.KernelBuildError("nvcc failed")

    monkeypatch.setattr(build, "build", failing_build)
    with pytest.raises(build.KernelBuildError):
        build.library()
    assert os.listdir(cache) == []


def test_cache_dir_from_session_conf(stub_build, tmp_path, monkeypatch):
    monkeypatch.setitem(t_session().conf, "repair.compile.cache_dir",
                        str(tmp_path / "conf_cache"))
    assert compile_plane.cache_dir() == str(tmp_path / "conf_cache")
    build.library()
    assert os.path.exists(os.path.join(str(tmp_path / "conf_cache"), build._library_name()))
    # the environment beats the session conf
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert compile_plane.cache_dir() == str(tmp_path / "env")


def test_fast_build_stays_out_of_the_cache(stub_build, tmp_path,
                                           monkeypatch):
    """A build faster than the threshold loads from a private file that is
    deleted once loaded; the next load misses again."""
    calls, _ = stub_build
    cache = tmp_path / "cache"
    monkeypatch.setenv("DELPHI_COMPILE_CACHE_DIR", str(cache))
    monkeypatch.setitem(t_session().conf, "repair.compile.min_compile_secs",
                        "60")
    assert compile_plane.min_compile_secs() == 60.0
    build.library()
    assert not os.path.exists(os.path.join(str(cache), build._library_name()))
    assert not os.path.exists(calls[0])  # the private directory is gone
    build.reset_library()
    build.library()
    assert counters["compile_cache.misses"] == 2
    assert "compile_cache.hits" not in counters


def test_prewarm_thread_records_a_failed_load(monkeypatch):
    calls = []

    def boom():
        calls.append(1)
        raise build.KernelBuildError("nvcc failed")

    monkeypatch.setattr(build, "library", boom)
    counters.clear()
    handle = compile_plane.start_prewarm(3)
    handle._thread.join(timeout=30)
    assert not handle.alive
    assert isinstance(handle.error, build.KernelBuildError)
    assert not handle.loaded
    assert calls == [1]
    assert counters["compile_plane.prewarm_errors"] == 1
    # a failed build is no fault of the card: nothing classified
    assert not any(k.startswith("resilience.faults") for k in counters)


def test_prewarm_stop_does_not_wait_past_its_timeout(monkeypatch):
    started = threading.Event()
    release = threading.Event()

    def slow():
        started.set()
        release.wait(timeout=30)

    monkeypatch.setattr(build, "library", slow)
    handle = compile_plane.start_prewarm(1)
    assert started.wait(timeout=30)
    t0 = time.perf_counter()
    handle.stop(timeout=0.1)  # the load is in flight
    assert time.perf_counter() - t0 < 5
    release.set()
    handle._thread.join(timeout=30)
    assert not handle.alive
    assert handle.error is None


def test_prewarm_loads_the_library(stub_build):
    histograms.clear()
    handle = compile_plane.start_prewarm(2)
    handle._thread.join(timeout=30)
    assert handle.error is None and handle.loaded
    assert handle.planned == 2
    assert len(histograms["compile_plane.prewarm_seconds"]) == 1
    assert counters["compile_cache.requests"] == 1
    # the plane compiles no per-shape variant
    assert "compile_plane.prewarmed" not in counters


def test_no_prewarm_thread_on_a_cpu_run(monkeypatch):
    """With prewarm forced on, a CPU run plans the variants (the gauge)
    but starts no thread: it launches no kernel."""
    T.set_device("cpu")
    try:
        monkeypatch.setenv("DELPHI_PREWARM", "1")
        gauges.clear()
        sc = generate_scenario("missing_heavy", 600, seed=0)
        before = threading.active_count()
        handle = compile_plane.maybe_start_prewarm(
            t_encode(sc.dirty, "tid"), [], "tid", [], 10000, {})
        assert handle is None
        assert threading.active_count() == before
        assert gauges["compile_plane.prewarm_planned"] > 0
        monkeypatch.setenv("DELPHI_PREWARM", "0")
        gauges.clear()
        assert compile_plane.maybe_start_prewarm(
            t_encode(sc.dirty, "tid"), [], "tid", [], 10000, {}) is None
        assert "compile_plane.prewarm_planned" not in gauges
    finally:
        T.set_device(None)


@pytest.mark.parametrize("env,conf,want", [
    ({"DELPHI_PREWARM": "yes"}, {}, True),
    ({"DELPHI_PREWARM": "off"}, {"repair.compile.prewarm": "1"}, False),
    ({}, {"repair.compile.prewarm": "on"}, True),
    ({}, {}, False),  # auto: on for a run on the card only
])
def test_prewarm_toggle(env, conf, want, monkeypatch):
    T.set_device("cpu")
    try:
        monkeypatch.delenv("DELPHI_PREWARM", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for k, v in conf.items():
            monkeypatch.setitem(t_session().conf, k, v)
        assert compile_plane.prewarm_enabled() is want
    finally:
        T.set_device(None)


# scenario -> (continuous columns, targets, max training rows, options)
PLANS = {
    "missing_heavy": ([], [], 10000, {}),
    "missing_heavy max_evals=1": ([], [], 10000, {"model.hp.max_evals": "1"}),
    "missing_heavy targets": ([], ["tier", "grade"], 10000, {}),
    "fd_categorical": ([], [], 10000, {}),
    "numeric_regression": (None, [], 10000, {}),
    "correlated_multi small cap": ([], [], 500, {}),
    "wide": ([], [], 10000, {}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
@pytest.mark.parametrize("budget", [None, "3"])
def test_prewarm_plan_equals_the_jax_packages(case, budget, monkeypatch):
    """``plan_prewarm_variants`` (and so the ``prewarm_planned`` gauge)
    equals the JAX package's on its CPU backend, whose grid trim the port
    pins."""
    name = case.split(" ")[0]
    cont, targets, max_rows, opts = PLANS[case]
    if budget:
        monkeypatch.setenv("DELPHI_PREWARM_BUDGET", budget)
    sc = generate_scenario(name, 2000, seed=0)
    if cont is None:
        cont = [c for c in sc.dirty.columns
                if c != "tid" and pd.api.types.is_float_dtype(sc.dirty[c])]
    want = j_plane.plan_prewarm_variants(
        j_encode(sc.dirty, "tid"), cont, "tid", targets, max_rows, opts)
    got = compile_plane.plan_prewarm_variants(
        t_encode(sc.dirty, "tid"), cont, "tid", targets, max_rows, opts)
    assert got == want
    # one-config grids (max_evals=1) search nothing, so plan nothing
    assert (len(got) > 0) == ("max_evals=1" not in case)


def test_prewarm_plan_from_a_stored_plan_equals_the_jax_packages(tmp_path):
    """With a stored ``gbdt.cv`` plan for the table's fingerprint, both
    packages prewarm exactly its variants."""
    sc = generate_scenario("missing_heavy", 2000, seed=0)
    fp = planner.table_plan_fingerprint("t", 2000, list(sc.dirty.columns))
    shape = (3, 100, 2048, 8, 64, "multiclass", 4, 2)
    j_planner.set_plan_store(str(tmp_path))
    try:
        j_planner.plan_launches(
            "gbdt.cv[0]", [j_planner.Piece(key=i, size=1, shape=shape)
                           for i in range(5)],
            batch_cap=16, pad_batch=True, fingerprint=fp)
        with j_planner.plan_fingerprint(fp):
            want = j_plane.plan_prewarm_variants(
                j_encode(sc.dirty, "tid"), [], "tid", [], 10000, {})
    finally:
        j_planner.set_plan_store(None)
    planner.set_plan_store(str(tmp_path))
    try:
        with planner.plan_fingerprint(fp):
            got = compile_plane.plan_prewarm_variants(
                t_encode(sc.dirty, "tid"), [], "tid", [], 10000, {})
    finally:
        planner.set_plan_store(None)
    assert got == want
    assert [v["width"] for v in got] == [8] * len(got)
