"""The compile plane: the kernel library's build cache and the prewarm
thread.

The port of the JAX package's ``parallel/compile_plane.py``. The port's
only compile is the ``nvcc`` build of ``delphi_tpu_torch/csrc/*.cu`` into
one shared library (:mod:`delphi_tpu_torch.ops.kernels.build`); eager
PyTorch has no executable for each shape. So:

1. **Build cache.** ``DELPHI_COMPILE_CACHE_DIR`` (environment) or
   ``repair.compile.cache_dir`` (session conf) moves the library's
   directory (default: ``build/delphi_tpu_torch`` at the repository root).
   Each library load counts ``compile_cache.requests`` and either
   ``compile_cache.hits`` (the hashed library was there) or
   ``compile_cache.misses`` (it was built). ``DELPHI_COMPILE_CACHE_MIN_S``
   / ``repair.compile.min_compile_secs`` keeps a build faster than the
   threshold out of the cache directory, as
   ``jax_persistent_cache_min_compile_time_secs`` does for XLA: the
   library loads from a private file that is deleted once loaded.

2. **Prewarm.** ``DELPHI_PREWARM`` / ``repair.compile.prewarm`` (auto: on
   when the run's device is ``cuda``) with ``DELPHI_PREWARM_BUDGET`` /
   ``repair.compile.prewarm_budget``. At run start
   :func:`maybe_start_prewarm` plans the GBDT CV-chunk variants phase 2
   can reach (:func:`plan_prewarm_variants`, the JAX package's plan, so
   the ``compile_plane.prewarm_planned`` gauge equals its) and starts one
   background thread that loads the kernel library, building it on a
   miss, while ingest and detection run; the run stops it at its end.
   The worker compiles no variant (there is nothing to compile per
   shape), so ``compile_plane.prewarmed`` never counts; the load's
   seconds go to ``compile_plane.prewarm_seconds`` and a failed load to
   ``compile_plane.prewarm_errors`` (the run then raises at its first
   kernel launch, as it would without prewarm).
"""

import os
import threading
import time
from typing import Any, Dict, List, Optional

from delphi_tpu_torch.utils import (counter_inc, gauge_set,
                                    histogram_observe, setup_logger)

_logger = setup_logger()

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("0", "false", "off", "no")


def _conf(key: str) -> Optional[str]:
    from delphi_tpu_torch.session import get_session
    raw = get_session().conf.get(key)
    return str(raw) if raw is not None and str(raw).strip() else None


# ---------------------------------------------------------------------------
# the library's build cache
# ---------------------------------------------------------------------------

def cache_dir() -> Optional[str]:
    """The configured library directory (environment beats session conf),
    absolute, or None for the build module's default."""
    target = os.environ.get("DELPHI_COMPILE_CACHE_DIR") \
        or _conf("repair.compile.cache_dir")
    if not target:
        return None
    return os.path.abspath(os.path.expanduser(str(target)))


def min_compile_secs() -> float:
    """Builds faster than this many seconds stay out of the cache
    directory (default 0: every build persists, as before the plane)."""
    raw = os.environ.get("DELPHI_COMPILE_CACHE_MIN_S")
    if raw is None or not str(raw).strip():
        raw = _conf("repair.compile.min_compile_secs")
    if raw is None:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        _logger.warning(f"invalid compile-cache min-seconds {raw!r}")
        return 0.0


def record_cache_dir_stats(directory: str) -> None:
    """``compile_cache.entries`` / ``compile_cache.dir_bytes`` gauges of
    the library directory."""
    total = entries = 0
    try:
        with os.scandir(directory) as it:
            for entry in it:
                if entry.is_file(follow_symlinks=False):
                    entries += 1
                    total += entry.stat(follow_symlinks=False).st_size
    except OSError:
        return
    gauge_set("compile_cache.entries", entries)
    gauge_set("compile_cache.dir_bytes", total)


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------

class PrewarmHandle:
    """Owns the background prewarm thread; ``stop()`` is safe to call any
    number of times and after natural completion."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.loaded = False
        self.planned = 0

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        """Signals the worker and optionally waits for it. The thread is a
        daemon: a build that outlasts ``timeout`` cannot block the run
        (the run's own first launch waits on the build's lock instead)."""
        self._stop.set()
        t = self._thread
        if t is not None and timeout:
            t.join(timeout)


def _prewarm_worker(handle: PrewarmHandle) -> None:
    from delphi_tpu_torch.ops.kernels import build
    if handle._stop.is_set():
        return
    t0 = time.perf_counter()
    try:
        build.library()
    except BaseException as e:
        # a build that fails here fails again, and raises, at the run's
        # first kernel launch: the worker only records it
        handle.error = e
        counter_inc("compile_plane.prewarm_errors")
        from delphi_tpu_torch.parallel.resilience import note_fault
        note_fault(e, "compile.prewarm")
        _logger.warning(
            f"prewarm: loading the kernel library failed: "
            f"{type(e).__name__}: {e}")
        return
    handle.loaded = True
    histogram_observe("compile_plane.prewarm_seconds",
                      time.perf_counter() - t0)


def start_prewarm(planned: int) -> PrewarmHandle:
    handle = PrewarmHandle()
    handle.planned = planned
    t = threading.Thread(target=_prewarm_worker, args=(handle,),
                         daemon=True, name="delphi-prewarm")
    handle._thread = t
    t.start()
    return handle


def prewarm_enabled() -> bool:
    """``DELPHI_PREWARM`` / ``repair.compile.prewarm``; auto is on when the
    run's device is ``cuda`` (the JAX package's "not the CPU backend")."""
    raw = os.environ.get("DELPHI_PREWARM")
    if raw is None:
        raw = _conf("repair.compile.prewarm")
    if raw is not None:
        v = str(raw).strip().lower()
        if v in _TRUTHY:
            return True
        if v in _FALSY:
            return False
    from delphi_tpu_torch.device import get_device
    return get_device().type == "cuda"


def _prewarm_budget() -> int:
    raw = os.environ.get("DELPHI_PREWARM_BUDGET") \
        or _conf("repair.compile.prewarm_budget")
    try:
        return max(0, int(raw)) if raw is not None else 32
    except (TypeError, ValueError):
        _logger.warning(f"invalid prewarm budget {raw!r}; using 32")
        return 32


def plan_prewarm_variants(table: Any, continuous_columns: List[str],
                          row_id: str, targets: Optional[List[str]],
                          max_training_rows: int,
                          opts: Dict[str, str]) -> List[Dict[str, Any]]:
    """The padded CV-chunk shape variants phase 2 can reach, enumerated as
    the JAX package enumerates them (its CPU grid trim, which the port
    pins): from a stored ``gbdt.cv`` plan of this table's fingerprint when
    there is one, else from the row and feature pads, each column's
    objective and class bucket, the trimmed grid's (depth, rounds) groups
    and the planner's CV slab widths; cut to the prewarm budget."""
    from delphi_tpu_torch import train as _train
    from delphi_tpu_torch.models import gbdt as _gbdt
    from delphi_tpu_torch.parallel import planner
    from delphi_tpu_torch.utils import get_option_value

    n_rows = int(table.n_rows)
    columns = [c for c in table.column_names if c != row_id]
    if targets:
        wanted = set(targets)
        columns = [c for c in columns if c in wanted]
    domain = table.domain_stats()
    continuous = set(continuous_columns)

    n_splits = int(get_option_value(opts, *_train._opt_n_splits))
    max_evals = int(get_option_value(opts, *_train._opt_max_evals))
    n_train = max(1, min(n_rows, int(max_training_rows)))
    if n_train < n_splits * 2:
        return []  # no CV search at this size

    stored = planner.stored_launch_shapes(
        planner.current_fingerprint(), "gbdt.cv")
    if stored:
        variants = []
        seen = set()
        for shape, _padded, width in stored:
            try:
                (depth, rounds, s_n_pad, s_d_pad, s_n_bins, objective, k,
                 n_cfg) = shape
            except ValueError:
                continue  # another layout: enumerate below
            for chunk in sorted(set(planner.round_chunks(
                    int(rounds), _gbdt._CHUNK_ROUNDS))):
                vkey = (chunk, int(depth), objective, int(k), int(width),
                        int(n_cfg), int(s_n_pad), int(s_d_pad))
                if vkey in seen:
                    continue
                seen.add(vkey)
                variants.append(dict(
                    chunk=chunk, depth=int(depth), n_bins=int(s_n_bins),
                    n_nodes=1 << int(depth), objective=objective, k=int(k),
                    width=int(width), n_cfg=int(n_cfg), n_pad=int(s_n_pad),
                    d_pad=int(s_d_pad)))
        if variants:
            return variants[:_prewarm_budget()]
    n_pad = _gbdt.train_row_target(n_train)
    # one feature column per non-target attribute (the compact design)
    n_feat = max(1, len(table.column_names) - 2)
    d_pad = max(8, -(-n_feat // 8) * 8)
    n_bins = 64  # max_bin caps at 63; the binner's width is max_bin + 1

    # targets grouped as the batched search groups them: (objective, class
    # bucket, trimmed-grid signature)
    buckets: Dict[tuple, int] = {}
    for c in columns:
        is_discrete = c not in continuous
        if is_discrete:
            k_real = int(domain.get(c, 0))
            if k_real <= 1:
                continue
            num_class = k_real
            if k_real <= 2:
                objective, k = "binary", 1
            elif k_real <= _gbdt.MAX_MULTICLASS:
                objective = "multiclass"
                k = next(b for b in (4, 8, 16, 24, _gbdt.MAX_MULTICLASS)
                         if b >= k_real)
            else:
                continue  # the logistic head's, not the GBDT's
        else:
            objective, k, num_class = "regression", 1, 0
        if not _gbdt.gbdt_supported(is_discrete, num_class):
            continue
        grid = _train._trimmed_grid(is_discrete, num_class, max_evals, opts)
        if len(grid) <= 1:
            continue  # single-config grids skip CV
        sig = tuple(tuple(sorted(cfg.items())) for cfg in grid)
        key = (objective, k, sig)
        buckets[key] = buckets.get(key, 0) + 1

    variants = []
    seen = set()
    for (objective, k, sig), n_targets in buckets.items():
        grid = [dict(s) for s in sig]
        groups: Dict[tuple, int] = {}
        for cfg in grid:
            depth = int(cfg.get("max_depth", 7))
            rounds = _gbdt._cfg_rounds_for(cfg, objective, k)
            groups[(depth, rounds)] = groups.get((depth, rounds), 0) + 1
        total = n_targets * n_splits
        cap = planner.cv_instance_cap(default=_gbdt._CV_INSTANCE_CAP)
        widths = set(planner.plan_cv_slab_widths(
            total, cap, single_target=n_targets == 1))
        for (depth, _rounds), n_cfg in groups.items():
            for width in sorted(widths):
                vkey = (depth, objective, k, width, n_cfg)
                if vkey in seen:
                    continue
                seen.add(vkey)
                variants.append(dict(
                    chunk=_gbdt._CHUNK_ROUNDS, depth=depth, n_bins=n_bins,
                    n_nodes=1 << depth, objective=objective, k=k,
                    width=width, n_cfg=n_cfg, n_pad=n_pad, d_pad=d_pad))

    budget = _prewarm_budget()
    if len(variants) > budget:
        _logger.info(
            f"prewarm plan truncated to budget: {budget} of "
            f"{len(variants)} variants (DELPHI_PREWARM_BUDGET raises it)")
        variants = variants[:budget]
    return variants


def maybe_start_prewarm(table: Any, continuous_columns: List[str],
                        row_id: str, targets: Optional[List[str]],
                        max_training_rows: int,
                        opts: Dict[str, str]) -> Optional[PrewarmHandle]:
    """Run-start hook: when prewarm is on, plans the variants (the
    ``compile_plane.prewarm_planned`` gauge) and, on a run on the card,
    starts the thread that loads the kernel library. A run on the CPU
    launches no kernel, so it starts no thread."""
    if not prewarm_enabled():
        return None
    variants = plan_prewarm_variants(
        table, continuous_columns, row_id, targets, max_training_rows, opts)
    if variants:
        gauge_set("compile_plane.prewarm_planned", len(variants))
    from delphi_tpu_torch.device import get_device
    if get_device().type != "cuda":
        return None
    _logger.info("prewarm: loading the kernel library on a background "
                 f"thread ({len(variants)} CV variants planned)")
    return start_prewarm(len(variants))
