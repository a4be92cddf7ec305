"""Repair-model training: option registry, model dispatch, class rebalancing.

The port of the JAX package's ``train.py`` without its mesh paths and
provenance ledger. Every ``model.lgb.*`` / ``model.cv.*`` / ``model.hp.*``
key validates as before. Routes the reference picks on
``jax.default_backend()`` are pinned to its CPU choices, on the card too:
the candidate grid is trimmed as on the CPU, local refinement of the CV
winner runs only when ``model.hp.no_progress_loss`` is set explicitly,
and the batched path's CV sets run one after the other.
"""

import time
from collections import namedtuple
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.parallel.pipeline import run_pipelined
from delphi_tpu_torch.utils import (counter_inc, elapsed_time,
                                    get_option_value, setup_logger)

_logger = setup_logger()

_option = namedtuple("_option", "key default_value type_class validator err_msg")

_opt_boosting_type = \
    _option("model.lgb.boosting_type", "gbdt", str,
            lambda v: v in ["gbdt", "dart", "goss", "rf"],
            "`{}` should be in ['gbdt', 'dart', 'goss', 'rf']")
_opt_class_weight = \
    _option("model.lgb.class_weight", "balanced", str, None, None)
_opt_learning_rate = \
    _option("model.lgb.learning_rate", 0.01, float,
            lambda v: v > 0.0, "`{}` should be positive")
_opt_max_depth = \
    _option("model.lgb.max_depth", 7, int, None, None)
_opt_max_bin = \
    _option("model.lgb.max_bin", 255, int, None, None)
_opt_reg_alpha = \
    _option("model.lgb.reg_alpha", 0.0, float,
            lambda v: v >= 0.0, "`{}` should be greater than or equal to 0.0")
_opt_min_split_gain = \
    _option("model.lgb.min_split_gain", 0.0, float,
            lambda v: v >= 0.0, "`{}` should be greater than or equal to 0.0")
_opt_n_estimators = \
    _option("model.lgb.n_estimators", 300, int,
            lambda v: v > 0, "`{}` should be positive")
_opt_importance_type = \
    _option("model.lgb.importance_type", "gain", str,
            lambda v: v in ["split", "gain"], "`{}` should be in ['split', 'gain']")
_opt_n_splits = \
    _option("model.cv.n_splits", 3, int,
            lambda v: v >= 3, "`{}` should be greater than 2")
_opt_timeout = \
    _option("model.hp.timeout", 0, int, None, None)
_opt_max_evals = \
    _option("model.hp.max_evals", 100000000, int,
            lambda v: v > 0, "`{}` should be positive")
_opt_no_progress_loss = \
    _option("model.hp.no_progress_loss", 50, int,
            lambda v: v > 0, "`{}` should be positive")
_opt_stop_score = \
    _option("model.hp.stop_score", 0.995, float,
            lambda v: 0.0 < v <= 1.0, "`{}` should be in (0.0, 1.0]")

train_option_keys = [
    _opt_boosting_type.key,
    _opt_class_weight.key,
    _opt_learning_rate.key,
    _opt_max_depth.key,
    _opt_max_bin.key,
    _opt_reg_alpha.key,
    _opt_min_split_gain.key,
    _opt_n_estimators.key,
    _opt_importance_type.key,
    _opt_n_splits.key,
    _opt_timeout.key,
    _opt_max_evals.key,
    _opt_no_progress_loss.key,
    _opt_stop_score.key,
]

# The reference's candidate grid, in its order (prefix slicing by
# `model.hp.max_evals` keeps the strongest defaults first).
_GBDT_GRID = [
    dict(max_depth=3, reg_lambda=3.0, learning_rate=0.05, n_estimators=300),
    dict(max_depth=3, reg_lambda=1.0, learning_rate=0.1, n_estimators=200),
    dict(max_depth=5, reg_lambda=1.0, learning_rate=0.1, n_estimators=200),
    dict(max_depth=5, reg_lambda=1.0, learning_rate=0.1, n_estimators=200,
         min_child_weight=5.0),
    dict(max_depth=3, reg_lambda=0.15, learning_rate=0.1, n_estimators=200),
    dict(max_depth=3, reg_lambda=10.0, learning_rate=0.05, n_estimators=200),
    dict(max_depth=3, reg_lambda=1.0, learning_rate=0.2, n_estimators=200,
         min_child_weight=0.05),
    dict(max_depth=5, reg_lambda=5.0, learning_rate=0.05, n_estimators=200),
    dict(max_depth=5, reg_lambda=0.15, learning_rate=0.1, n_estimators=200,
         min_child_weight=0.5),
    dict(max_depth=5, reg_lambda=1.0, learning_rate=0.2, n_estimators=200,
         min_child_weight=2.5),
]


def _is_device_error(e: BaseException) -> bool:
    """A fault of the card or its runtime: it propagates instead of turning
    into a fallback model."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        isinstance(e, RuntimeError)
        and any(w in str(e) for w in ("CUDA", "CUBLAS", "cuBLAS", "cuDNN")))


def _refine_candidates(cfg: dict, seen: list, scale: int = 1) -> list:
    """Local perturbations of the winning grid config along reg_lambda,
    learning_rate and min_child_weight, at the SAME depth and round count
    so the refined set rides one CV launch. ``scale`` widens the steps."""
    base_rl = float(cfg.get("reg_lambda", 1.0))
    base_lr = float(cfg.get("learning_rate", 0.1))
    base_mcw = float(cfg.get("min_child_weight", 1.0))
    f_rl, f_lr, f_mcw = 3.0 ** scale, 2.0 ** scale, 3.0 ** scale
    out = []
    for rl in (base_rl / f_rl, base_rl * f_rl):
        out.append({**cfg, "reg_lambda": rl})
    for lr in (base_lr / f_lr, min(0.5, base_lr * f_lr)):
        out.append({**cfg, "learning_rate": lr})
    for mcw in (base_mcw / f_mcw, base_mcw * f_mcw):
        out.append({**cfg, "min_child_weight": mcw})
    uniq = []
    for c in out:
        if c not in seen and c not in uniq and c != cfg:
            uniq.append(c)
    return uniq


def _refine_best_config(X, y, is_discrete, best_cfg, best_score, best_rounds,
                        grid, n_splits, class_weight, template, deadline,
                        no_progress_evals, explicit, good_enough=0.995):
    """Adaptive second phase of the search, honoring
    `model.hp.no_progress_loss`: rounds of local refinement around the
    current best config until `no_progress_evals` consecutive candidate
    evaluations bring no improvement. `deadline` (monotonic seconds, or
    None) bounds the whole search. Pinned to the reference's CPU route:
    refinement runs only when the option is set (``explicit``)."""
    from delphi_tpu_torch.models.gbdt import gbdt_cv_grid_search

    if not explicit or not np.isfinite(best_score):
        return best_cfg, best_score, best_rounds

    max_rounds = 5
    evals_no_progress = 0
    scale = 1
    seen = list(grid)
    for _ in range(max_rounds):
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            break
        candidates = _refine_candidates(best_cfg, seen, scale=scale)
        if not candidates:
            break
        seen.extend(candidates)
        ci, score, rounds, r_timed, _ = gbdt_cv_grid_search(
            X, y, is_discrete, candidates, n_splits, class_weight, template,
            timeout_s=remaining if remaining is not None else 0.0,
            good_enough=good_enough)
        if score <= best_score:
            evals_no_progress += len(candidates)
            if evals_no_progress >= no_progress_evals or scale >= 3:
                break
            scale += 1  # widen the neighborhood instead of re-proposing it
            continue
        evals_no_progress = 0
        scale = 1
        _logger.info(
            f"Refinement improved CV score {best_score:.4f} -> {score:.4f} "
            f"({candidates[ci]})")
        if r_timed and rounds > 0:
            # a deadline-truncated round count is not CV-proven
            rounds = 0
        best_cfg, best_score, best_rounds = dict(candidates[ci]), score, rounds
    return best_cfg, best_score, best_rounds


def _trimmed_grid(is_discrete: bool, num_class: int, max_evals: int,
                  opts: Dict[str, str]) -> list:
    """The per-target candidate grid the reference would search. The port
    pins the reference's CPU trim on every device, as the parity tests run
    the reference on the CPU."""
    grid = _GBDT_GRID[: max(1, min(len(_GBDT_GRID), max_evals))]
    if _opt_max_evals.key not in opts:
        if is_discrete:
            seen_depths: set = set()
            trimmed = []
            for cfg in grid[:4]:
                depth = cfg.get("max_depth", 7)
                if depth not in seen_depths:
                    seen_depths.add(depth)
                    trimmed.append(cfg)
            grid = trimmed
        else:
            grid = grid[:4]
    if is_discrete and num_class > 8:
        # wide multiclass: CV grid search is too costly for the gain
        grid = grid[:1]
    return grid


def _gbdt_factory(opts: Dict[str, str], is_discrete: bool, num_class: int):
    from delphi_tpu_torch.models.gbdt import GradientBoostedTreesModel

    def make(cfg: dict) -> GradientBoostedTreesModel:
        return GradientBoostedTreesModel(
            is_discrete=is_discrete, num_class=num_class,
            max_bin=int(get_option_value(opts, *_opt_max_bin)),
            min_split_gain=float(get_option_value(opts, *_opt_min_split_gain)),
            class_weight=str(get_option_value(opts, *_opt_class_weight)),
            **cfg)
    return make


@elapsed_time  # type: ignore
def _build_model(X: Any, y: pd.Series, is_discrete: bool,
                 num_class: int, opts: Dict[str, str]) -> Tuple[Any, float]:
    def opt(*args):  # type: ignore
        return get_option_value(opts, *args)

    try:
        from delphi_tpu_torch.models.encoding import OneHotDesign
        from delphi_tpu_torch.models.gbdt import (gbdt_cv_grid_search,
                                                  gbdt_supported)
        n_splits = int(opt(*_opt_n_splits))
        class_weight = str(opt(*_opt_class_weight))
        if not isinstance(X, OneHotDesign):  # the linear heads take the
            X = np.asarray(X)                # factored design as-is

        if gbdt_supported(is_discrete, num_class):
            factory = _gbdt_factory(opts, is_discrete, num_class)
            grid = _trimmed_grid(is_discrete, num_class,
                                 int(opt(*_opt_max_evals)), opts)
            best_cfg, best_score, best_rounds = grid[0], -np.inf, 0
            chunks = 0
            t_cv = time.perf_counter()
            if len(grid) > 1 and len(X) >= n_splits * 2:
                template = factory(grid[0])
                timeout_s = float(opt(*_opt_timeout))
                # one deadline bounds the WHOLE search (grid + refinement)
                deadline = time.monotonic() + timeout_s if timeout_s > 0 \
                    else None
                good_enough = float(opt(*_opt_stop_score))
                best_ci, best_score, best_rounds, timed0, chunks = \
                    gbdt_cv_grid_search(
                        X, y, is_discrete, grid, n_splits, class_weight,
                        template, timeout_s=timeout_s,
                        good_enough=good_enough)
                if timed0:
                    best_rounds = 0  # not CV-proven: keep the full budget
                best_cfg = dict(grid[best_ci])
                if best_score < good_enough:
                    best_cfg, best_score, best_rounds = _refine_best_config(
                        X, y, is_discrete, best_cfg, best_score, best_rounds,
                        grid, n_splits, class_weight, template, deadline,
                        no_progress_evals=int(opt(*_opt_no_progress_loss)),
                        explicit=_opt_no_progress_loss.key in opts,
                        good_enough=good_enough)
                if best_rounds > 0 and is_discrete:
                    # classifiers train only the rounds CV proved useful
                    # for the winning config; regressors keep the full
                    # budget (their MSE keeps creeping down)
                    best_cfg["n_estimators"] = best_rounds
            t_fit = time.perf_counter()
            model = factory(best_cfg)
            model.fit(X, y)
            model.train_report_ = _report(
                best_cfg, best_score, best_rounds, chunks,
                t_fit - t_cv, time.perf_counter() - t_fit)
            return model, best_score if np.isfinite(best_score) else -model.loss_

        from delphi_tpu_torch.models.linear import (LogisticRegressionModel,
                                                    MLPRegressorModel)
        t_fit = time.perf_counter()
        model = LogisticRegressionModel() if is_discrete \
            else MLPRegressorModel()
        model.fit(X, y)
        model.train_report_ = _report(None, -np.inf, 0, 0, 0.0,
                                      time.perf_counter() - t_fit)
        model.train_report_["steps"] = model.n_steps_run_
        return model, -model.loss_
    except Exception as e:
        if _is_device_error(e):
            raise
        _logger.warning(f"Failed to build a stat model because: {e}")
        return None, 0.0


def _report(cfg: Optional[dict], score: float, rounds: int, chunks: int,
            cv_s: float, fit_s: float) -> Dict[str, Any]:
    """What a fitted model records of its training (``train_report_``)."""
    return {"config": cfg, "cv_score": score, "cv_rounds": rounds,
            "cv_chunks": chunks, "cv_seconds": cv_s, "fit_seconds": fit_s}


def build_model(X: Any, y: pd.Series, is_discrete: bool, num_class: int,
                n_jobs: int, opts: Dict[str, str]) -> Tuple[Tuple[Any, float], float]:
    """Returns ((model, score), elapsed_seconds); model is None on failure
    (callers substitute PoorModel). A fault of the card propagates."""
    return _build_model(X, y, is_discrete, num_class, opts)


def _record_model_scores(
        results: Dict[str, Tuple[Tuple[Any, float], float]]) \
        -> Dict[str, Tuple[Tuple[Any, float], float]]:
    """Lands each target's CV score in the provenance ledger (it surfaces
    as ``model_cv_score`` on the attribute's quality scorecard)."""
    led = active_ledger()
    if led is not None:
        for name, ((model, score), _elapsed) in results.items():
            if model is not None:
                led.record_model_score(name, score)
    return results


def build_models_batched(tasks: list, opts: Dict[str, str]) \
        -> Dict[str, Tuple[Tuple[Any, float], float]]:
    """Builds MANY per-attribute repair models with shared device launches:
    their CV searches stack into :func:`gbdt_cv_grid_search_multi` and
    their final fits into :func:`gbdt_fit_batch`.

    ``tasks``: list of (name, X, y, is_discrete, num_class). Returns
    {name: ((model, score), elapsed_s)}; model None on failure, like
    :func:`build_model`. Non-GBDT targets (the linear heads) train one by
    one through :func:`build_model`. A failed batched fit falls back to
    per-target fits and counts ``train.batched_fallbacks``; a fault of the
    card propagates."""
    t0 = time.time()
    results: Dict[str, Tuple[Tuple[Any, float], float]] = {}
    gbdt_tasks = []
    try:
        from delphi_tpu_torch.models.encoding import OneHotDesign
        from delphi_tpu_torch.models.gbdt import (_cv_prepare_target,
                                                  gbdt_cv_grid_search_multi,
                                                  gbdt_fit_batch,
                                                  gbdt_supported)
        for task in tasks:
            name, X, y, is_discrete, num_class = task
            if gbdt_supported(is_discrete, num_class) \
                    and not isinstance(X, OneHotDesign):
                gbdt_tasks.append(task)
            else:
                results[name] = build_model(
                    X, y, is_discrete, num_class, -1, opts)
        if not gbdt_tasks:
            return _record_model_scores(results)

        def opt(*args):  # type: ignore
            return get_option_value(opts, *args)

        counter_inc("train.batched_gbdt_targets", len(gbdt_tasks))
        n_splits = int(opt(*_opt_n_splits))
        max_evals = int(opt(*_opt_max_evals))
        class_weight = str(opt(*_opt_class_weight))
        good_enough = float(opt(*_opt_stop_score))
        timeout_s = float(opt(*_opt_timeout))
        # model.hp.timeout is a PER-TARGET budget; the batched path pools
        # the same total
        deadline = time.monotonic() + timeout_s * len(gbdt_tasks) \
            if timeout_s > 0 else None

        # tasks sharing a candidate grid share one multi-target CV search;
        # single-config grids (wide multiclass) skip CV entirely
        chosen: Dict[int, Tuple[dict, float, int, list]] = {}
        templates: Dict[int, Any] = {}
        cv_sets: Dict[tuple, List[int]] = {}
        for ti, (name, X, y, is_discrete, num_class) in enumerate(gbdt_tasks):
            grid = _trimmed_grid(is_discrete, num_class, max_evals, opts)
            chosen[ti] = (dict(grid[0]), -np.inf, 0, grid)
            if len(grid) > 1 and len(X) >= n_splits * 2:
                sig = tuple(tuple(sorted(c.items())) for c in grid)
                cv_sets.setdefault(sig, []).append(ti)

        cv_seconds: Dict[int, float] = {}
        cv_chunks: Dict[int, int] = {}

        def _prep_cv_set(tis: List[int]) -> Tuple[List[Optional[dict]],
                                                   float]:
            # host featurization of one CV set (fold binning, scoring
            # constants; numpy only, so it can run on the pipeline's
            # producer thread) and its seconds
            t_prep = time.perf_counter()
            grid = chosen[tis[0]][3]
            preps: List[Optional[dict]] = []
            for ti in tis:
                name, X, y, is_discrete, num_class = gbdt_tasks[ti]
                tmpl = _gbdt_factory(opts, is_discrete, num_class)(
                    dict(grid[0]))
                templates[ti] = tmpl
                try:
                    preps.append(_cv_prepare_target(
                        np.asarray(X), y, is_discrete, n_splits,
                        class_weight, tmpl))
                except Exception as e:
                    if _is_device_error(e):
                        raise
                    _logger.warning(f"{e.__class__}: {e}")
                    preps.append(None)
            return preps, time.perf_counter() - t_prep

        def _search_cv_set(tis: List[int], prepared: Tuple[
                List[Optional[dict]], float]) -> None:
            preps, prep_s = prepared
            t_cv = time.perf_counter()
            grid = chosen[tis[0]][3]
            remaining = 0.0 if deadline is None \
                else max(deadline - time.monotonic(), 1e-3)
            res = gbdt_cv_grid_search_multi(
                preps, grid, timeout_s=remaining, good_enough=good_enough)
            for ti, (ci, score, rounds, timed, c) in zip(tis, res):
                if timed:
                    rounds = 0  # not CV-proven: keep the full round budget
                chosen[ti] = (dict(grid[ci]), score, rounds, grid)
                cv_chunks[ti] = c
            cv_s = prep_s + time.perf_counter() - t_cv
            for ti in tis:  # the set's search is shared by its targets
                cv_seconds[ti] = cv_s

        # featurization of CV set k+1 overlaps the device search of set k
        run_pipelined(list(cv_sets.values()), _prep_cv_set, _search_cv_set)

        # local refinement stays per target, for targets the base grid left
        # below the good-enough bar
        explicit = _opt_no_progress_loss.key in opts
        for ti in list(templates):
            name, X, y, is_discrete, num_class = gbdt_tasks[ti]
            cfg, score, rounds, grid = chosen[ti]
            if np.isfinite(score) and score < good_enough:
                cfg, score, rounds = _refine_best_config(
                    np.asarray(X), y, is_discrete, cfg, score, rounds, grid,
                    n_splits, class_weight, templates[ti], deadline,
                    no_progress_evals=int(opt(*_opt_no_progress_loss)),
                    explicit=explicit, good_enough=good_enough)
                chosen[ti] = (cfg, score, rounds, grid)

        entries = []
        finals: Dict[int, Tuple[Any, float]] = {}
        configs: Dict[int, dict] = {}
        for ti, (name, X, y, is_discrete, num_class) in enumerate(gbdt_tasks):
            cfg, score, rounds, grid = chosen[ti]
            cfg = dict(cfg)
            if rounds > 0 and is_discrete:
                cfg["n_estimators"] = rounds  # CV-proven early stop
            m = _gbdt_factory(opts, is_discrete, num_class)(cfg)
            finals[ti] = (m, score)
            configs[ti] = cfg
            entries.append((m, np.asarray(X), y))
        t_fit = time.perf_counter()
        try:
            gbdt_fit_batch(entries)
        except Exception as e:
            if _is_device_error(e):
                raise
            _logger.warning(
                f"Batched fit failed ({e.__class__}: {e}); falling back to "
                "per-target fits")
            counter_inc("train.batched_fallbacks")
            for mi, (m, X, y) in enumerate(entries):
                try:
                    m.fit(X, y)
                except Exception as e2:
                    if _is_device_error(e2):
                        raise
                    _logger.warning(f"{e2.__class__}: {e2}")
                    finals[mi] = (None, 0.0)

        fit_s = time.perf_counter() - t_fit
        elapsed_each = (time.time() - t0) / max(len(gbdt_tasks), 1)
        for ti, (name, X, y, is_discrete, num_class) in enumerate(gbdt_tasks):
            m, score = finals[ti]
            if m is not None:
                m.train_report_ = _report(configs[ti], score, chosen[ti][2],
                                          cv_chunks.get(ti, 0),
                                          cv_seconds.get(ti, 0.0), fit_s)
            score = score if m is not None and np.isfinite(score) \
                else (-m.loss_ if m is not None else 0.0)
            results[name] = ((m, score), elapsed_each)
        return _record_model_scores(results)
    except Exception as e:
        if _is_device_error(e):
            raise
        # total batched-path failure: every unresolved task falls back to
        # the sequential builder (never silently drop a target)
        _logger.warning(
            f"Batched training failed ({e.__class__}: {e}); falling back "
            "to sequential per-target training")
        counter_inc("train.batched_fallbacks")
        for task in tasks:
            name, X, y, is_discrete, num_class = task
            if name not in results:
                results[name] = build_model(
                    X, y, is_discrete, num_class, -1, opts)
        return _record_model_scores(results)


def compute_class_nrow_stdv(y: pd.Series, is_discrete: bool) -> Optional[float]:
    if not is_discrete:
        return None
    counts = pd.Series(np.asarray(y)).value_counts(dropna=False)
    return float(np.std(counts.to_numpy()))


def rebalance_training_data(X: pd.DataFrame, y: pd.Series, target: str) \
        -> Tuple[pd.DataFrame, pd.Series]:
    """Class rebalancing toward the median class size: oversample minority
    classes with replacement and undersample majority classes."""
    rng = np.random.RandomState(42)
    prev_nrows = len(X)
    prev_stdv = compute_class_nrow_stdv(y, is_discrete=True)

    y_arr = pd.Series(np.asarray(y)).reset_index(drop=True)
    is_frame = isinstance(X, pd.DataFrame)
    if is_frame:
        X = X.reset_index(drop=True)
    hist = y_arr.value_counts()
    median = int(np.median(hist.to_numpy()))

    idx_parts = []
    for cls, count in hist.items():
        cls_idx = np.nonzero((y_arr == cls).to_numpy())[0]
        if count < median:
            extra = rng.choice(cls_idx, size=median - count, replace=True)
            idx_parts.append(np.concatenate([cls_idx, extra]))
        elif count > median:
            idx_parts.append(rng.choice(cls_idx, size=median, replace=False))
        else:
            idx_parts.append(cls_idx)

    idx = np.concatenate(idx_parts) if idx_parts else np.arange(len(X))
    Xb = X.iloc[idx].reset_index(drop=True) if is_frame else np.asarray(X)[idx]
    yb = y_arr.iloc[idx].reset_index(drop=True)
    _logger.info(
        "Rebalanced training data (y={}, median={}): #rows={}(stdv={}) -> "
        "#rows={}(stdv={})".format(
            target, median, prev_nrows, prev_stdv, len(Xb),
            compute_class_nrow_stdv(yb, is_discrete=True)))
    return Xb, yb
