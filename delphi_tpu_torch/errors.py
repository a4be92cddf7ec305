"""Error detectors and the error-detection sub-pipeline.

The port of the JAX package's ``errors.py``: the detectors
(:class:`NullErrorDetector`, :class:`DomainValues`,
:class:`RegExErrorDetector`, :class:`ConstraintErrorDetector`,
:class:`GaussianOutlierErrorDetector`, the scikit-learn-style
:class:`ScikitLearnBackedErrorDetector` and :class:`LOFOutlierErrorDetector`)
and :class:`ErrorModel` (run detectors, or take user-supplied error cells
-> resolve current values -> discretize -> frequency & pairwise-entropy
stats -> weak-label demotion).

Error-cell frames are pandas DataFrames with columns ``[<row_id>,
'attribute']`` (plus ``'current_value'`` once resolved); an internal
``__row_idx__`` column carries positional indices between stages.
"""

import os
from abc import ABCMeta, abstractmethod
from collections import namedtuple
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from delphi_tpu_torch import constraints as dc
from delphi_tpu_torch.ops import detect as detect_ops
from delphi_tpu_torch.ops import xfer
from delphi_tpu_torch.ops.domain import compute_weak_label_mask
from delphi_tpu_torch.ops.entropy import (compute_pairwise_stats,
                                          select_candidate_pairs)
from delphi_tpu_torch.ops.freq import (FreqStats, PairDistinctCounter,
                                       compute_freq_stats)
from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.session import get_session
from delphi_tpu_torch.table import (DiscretizedTable, EncodedTable,
                                    discretize_table)
from delphi_tpu_torch.utils import (counter_inc, get_option_value,
                                    job_phase, log_based_on_level,
                                    setup_logger, to_list_str)

_logger = setup_logger()

ROW_IDX = "__row_idx__"


def _cells_to_frame(row_id: str, row_id_values: np.ndarray,
                    cells: List[Tuple[np.ndarray, str]]) -> pd.DataFrame:
    frames = []
    for rows, attr in cells:
        frames.append(pd.DataFrame({
            row_id: row_id_values[rows],
            "attribute": attr,
            ROW_IDX: rows,
        }))
    if not frames:
        return pd.DataFrame(columns=[row_id, "attribute", ROW_IDX])
    return pd.concat(frames, ignore_index=True)


class ErrorDetector(metaclass=ABCMeta):
    """Base detector. ``setUp`` receives the pipeline context; subclasses
    implement ``_detect_impl`` returning a frame with [row_id, attribute]."""

    def __init__(self, targets: List[str] = []) -> None:
        self.row_id: Optional[str] = None
        self.qualified_input_name: Optional[str] = None
        self.continous_cols: List[str] = []
        self.targets: List[str] = targets
        self._table: Optional[EncodedTable] = None

    def setUp(self, row_id: str, qualified_input_name: str,
              continous_cols: List[str], targets: List[str],
              encoded_table: Optional[EncodedTable] = None) -> "ErrorDetector":
        self.row_id = row_id
        self.qualified_input_name = qualified_input_name
        self.continous_cols = continous_cols
        if self.targets:
            self._targets = list(set(self.targets) & set(targets))
        else:
            self._targets = targets

        if encoded_table is not None:
            self._table = encoded_table
        else:
            from delphi_tpu_torch.table import encode_table
            df = get_session().table(qualified_input_name)
            self._table = encode_table(df, row_id)
        return self

    @property
    def input_df(self) -> pd.DataFrame:
        """The input as a pandas frame (for custom detectors)."""
        assert self._table is not None
        return self._table.to_pandas()

    @abstractmethod
    def _detect_impl(self) -> pd.DataFrame:
        pass

    def _empty_dataframe(self) -> pd.DataFrame:
        assert self.row_id is not None
        return pd.DataFrame(columns=[self.row_id, "attribute", ROW_IDX])

    def _frame(self, cells: List[Tuple[np.ndarray, str]]) -> pd.DataFrame:
        assert self._table is not None and self.row_id is not None
        return _cells_to_frame(self.row_id, self._table.row_id_values, cells)

    def detect(self) -> pd.DataFrame:
        assert self.row_id is not None and self._table is not None
        dirty_df = self._detect_impl()
        assert isinstance(dirty_df, pd.DataFrame)
        return dirty_df


class NullErrorDetector(ErrorDetector):
    """NULL-cell scan."""

    def __init__(self) -> None:
        ErrorDetector.__init__(self)

    def __str__(self) -> str:
        return f"{self.__class__.__name__}()"

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        return self._frame(detect_ops.detect_null_cells(self._table, self._targets))


class DomainValues(ErrorDetector):
    """Flags values outside a (possibly auto-filled) domain list.
    Partial-match regex semantics preserved; the values go into the regex
    unescaped, as in the JAX package."""

    def __init__(self, attr: str, values: List[str] = [], autofill: bool = False,
                 min_count_thres: int = 12) -> None:
        ErrorDetector.__init__(self)
        self.attr = attr
        self.values = values if not autofill else []
        self.autofill = autofill
        self.min_count_thres = min_count_thres

    def __str__(self) -> str:
        args = f'attr="{self.attr}",size={len(self.values)},autofill={self.autofill},' \
            f'min_count_thres={self.min_count_thres}'
        return f"{self.__class__.__name__}({args})"

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        if self.attr in self.continous_cols:
            return self._empty_dataframe()

        domain_values = self.values
        if self.autofill and self._table.has_column(self.attr):
            col = self._table.column(self.attr)
            codes = xfer.device_codes(col)
            counts = torch.bincount(codes[codes >= 0].long(),
                                    minlength=col.domain_size).cpu().numpy()
            domain_values = [str(v) for v, c in zip(col.vocab, counts)
                             if c > self.min_count_thres]

        regex = "({})".format("|".join(domain_values)) if domain_values else "$^"
        return self._frame(
            detect_ops.detect_regex_errors(self._table, self.attr, regex, self._targets))


class RegExErrorDetector(ErrorDetector):
    """Flags values not matching a regex (partial match), and NULLs."""

    def __init__(self, attr: str, regex: str) -> None:
        ErrorDetector.__init__(self)
        self.attr = attr
        self.regex = regex

    def __str__(self) -> str:
        return f'{self.__class__.__name__}(pattern="{self.regex}")'

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        return self._frame(
            detect_ops.detect_regex_errors(self._table, self.attr, self.regex, self._targets))


class ConstraintErrorDetector(ErrorDetector):
    """Denial-constraint violations: every referenced target attribute of
    every violating row (left tuple)."""

    def __init__(self, constraint_path: str = "", constraints: str = "",
                 targets: List[str] = []) -> None:
        ErrorDetector.__init__(self, targets)
        if not constraint_path and not constraints:
            raise ValueError(
                "At least one of `constraint_path` or `constraints` should be specified")
        self.constraint_path = constraint_path
        self.constraints = constraints

    def __str__(self) -> str:
        params = []
        if self.constraint_path:
            params.append(f"constraint_path={self.constraint_path}")
        if self.constraints:
            params.append(f"constraints={self.constraints}")
        if self.targets:
            params.append(f'targets={",".join(self.targets)}')
        return f'{self.__class__.__name__}({",".join(params)})'

    def parsed_constraints(self, table: EncodedTable, input_name: str) -> dc.DenialConstraints:
        stmts = dc.load_constraint_stmts_from_file(self.constraint_path) \
            + dc.load_constraint_stmts_from_string(self.constraints)
        return dc.parse_and_verify_constraints(stmts, input_name, table.column_names)

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        parsed = self.parsed_constraints(self._table, str(self.qualified_input_name))
        if parsed.is_empty:
            return self._empty_dataframe()
        cells = detect_ops.detect_constraint_violations(self._table, parsed, self._targets)
        return self._frame(cells)


class GaussianOutlierErrorDetector(ErrorDetector):
    """IQR (box-whisker) outliers on continuous attributes. With
    ``approx_enabled`` the quartiles of a column over 100,000 values come
    from a seeded with-replacement sample of that size; the fences then
    apply to every row."""

    def __init__(self, approx_enabled: bool = False) -> None:
        ErrorDetector.__init__(self)
        self.approx_enabled = approx_enabled

    def __str__(self) -> str:
        return f"{self.__class__.__name__}(approx_enabled={self.approx_enabled})"

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        return self._frame(
            detect_ops.detect_outliers(self._table, self.continous_cols,
                                       self._targets,
                                       approx=self.approx_enabled))


class ScikitLearnBasedErrorDetector(ErrorDetector):
    """Runs a scikit-learn-style ``fit_predict`` outlier model per continuous
    column on the host; NaNs are median-filled first. Above
    ``parallel_mode_threshold`` rows the per-column detectors run on a
    thread pool of ``num_parallelism`` workers (default: one per core, at
    most one per column); below it they run inline."""

    def __init__(self, parallel_mode_threshold: int = 10000,
                 num_parallelism: Optional[int] = None) -> None:
        ErrorDetector.__init__(self)
        if num_parallelism is not None and int(num_parallelism) <= 0:
            raise ValueError(f"`num_parallelism` must be positive, got {num_parallelism}")
        self.parallel_mode_threshold = parallel_mode_threshold
        self.num_parallelism = num_parallelism

    def __str__(self) -> str:
        return f"{self.__class__.__name__}()"

    @abstractmethod
    def _outlier_detector_impl(self) -> Any:
        pass

    def _detect_column(self, c: str) -> Optional[Tuple[np.ndarray, str]]:
        assert self._table is not None
        col = self._table.column(c)
        assert col.numeric is not None
        values = col.numeric
        valid = ~np.isnan(values)
        if not valid.any():
            return None
        median = float(np.median(values[valid]))
        filled = np.where(valid, values, median).reshape(-1, 1)
        # a fresh detector instance per column: safe to run concurrently
        predicted = np.asarray(self._outlier_detector_impl().fit_predict(filled))
        rows = np.nonzero(predicted < 0)[0]
        return (rows, c) if rows.size else None

    def _detect_impl(self) -> pd.DataFrame:
        assert self._table is not None
        columns = [c for c in self.continous_cols if c in self._targets] \
            if self._targets else self.continous_cols
        if not columns:
            return self._empty_dataframe()

        run_parallel = self._table.n_rows > int(self.parallel_mode_threshold) \
            and len(columns) > 1
        if run_parallel:
            from concurrent.futures import ThreadPoolExecutor
            workers = int(self.num_parallelism) if self.num_parallelism \
                else min(len(columns), os.cpu_count() or 1)
            _logger.info(
                f"{self}: running {len(columns)} column detectors on "
                f"{workers} threads (rows > {self.parallel_mode_threshold})")
            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(self._detect_column, columns))
        else:
            results = [self._detect_column(c) for c in columns]
        cells = [r for r in results if r is not None]
        return self._frame(cells)


class ScikitLearnBackedErrorDetector(ScikitLearnBasedErrorDetector):
    """Wraps a user-supplied detector factory (anything whose instances
    have ``fit_predict``; -1 marks an outlier)."""

    def __init__(self, error_detector_cls: Callable[[], Any],
                 parallel_mode_threshold: int = 10000,
                 num_parallelism: Optional[int] = None) -> None:
        ScikitLearnBasedErrorDetector.__init__(self, parallel_mode_threshold, num_parallelism)
        if not hasattr(error_detector_cls, "__call__"):
            raise ValueError("`error_detector_cls` should be callable")
        if not hasattr(error_detector_cls(), "fit_predict"):
            raise ValueError(
                "An instance that `error_detector_cls` returns should have a `fit_predict` method")
        self.error_detector_cls = error_detector_cls

    def __str__(self) -> str:
        return f"{self.__class__.__name__}()"

    def _outlier_detector_impl(self) -> Any:
        return self.error_detector_cls()


class LOFOutlierErrorDetector(ScikitLearnBasedErrorDetector):
    """Local-outlier-factor detector (scikit-learn, imported when a column
    is scanned: the package itself does not need scikit-learn)."""

    def __init__(self, parallel_mode_threshold: int = 10000,
                 num_parallelism: Optional[int] = None) -> None:
        ScikitLearnBasedErrorDetector.__init__(self, parallel_mode_threshold, num_parallelism)

    def __str__(self) -> str:
        return f"{self.__class__.__name__}()"

    def _outlier_detector_impl(self) -> Any:
        from sklearn.neighbors import LocalOutlierFactor
        return LocalOutlierFactor(novelty=False)


class ErrorModel:
    """The error-detection sub-pipeline: run detectors (or take the
    user-supplied error cells) -> resolve current values -> discretize ->
    frequency & pairwise-entropy stats -> weak-label demotion."""

    _option = namedtuple("_option", "key default_value type_class validator err_msg")

    _opt_attr_freq_ratio_threshold = \
        _option("error.attr_freq_ratio_threshold", 0.0, float,
                lambda v: 0.0 <= v <= 1.0, "`{}` should be in [0.0, 1.0]")
    _opt_pairwise_freq_ratio_threshold = \
        _option("error.pairwise_freq_ratio_threshold", 0.05, float,
                lambda v: 0.0 <= v <= 1.0, "`{}` should be in [0.0, 1.0]")
    _opt_max_attrs_to_compute_pairwise_stats = \
        _option("error.max_attrs_to_compute_pairwise_stats", 3, int,
                lambda v: v >= 2, "`{}` should be greater than 1")
    _opt_max_attrs_to_compute_domains = \
        _option("error.max_attrs_to_compute_domains", 2, int,
                lambda v: v >= 2, "`{}` should be greater than 1")
    _opt_domain_threshold_alpha = \
        _option("error.domain_threshold_alpha", 0.0, float,
                lambda v: 0.0 <= v < 1.0, "`{}` should be in [0.0, 1.0)")
    _opt_domain_threshold_beta = \
        _option("error.domain_threshold_beta", 0.70, float,
                lambda v: 0.0 <= v < 1.0, "`{}` should be in [0.0, 1.0)")

    option_keys = set([
        _opt_attr_freq_ratio_threshold.key,
        _opt_pairwise_freq_ratio_threshold.key,
        _opt_max_attrs_to_compute_pairwise_stats.key,
        _opt_max_attrs_to_compute_domains.key,
        _opt_domain_threshold_alpha.key,
        _opt_domain_threshold_beta.key])

    def __init__(self, row_id: str, targets: List[str], discrete_thres: int,
                 error_detectors: List[ErrorDetector],
                 error_cells: Optional[Any],
                 opts: Dict[str, str]) -> None:
        self.row_id = str(row_id)
        self.targets = targets
        self.discrete_thres = discrete_thres
        self.error_detectors = error_detectors
        self.error_cells = error_cells
        self.opts = opts
        self._session = get_session()
        self.discretized: Optional[DiscretizedTable] = None
        self.freq_stats: Optional[FreqStats] = None
        # Per-detector cell frames of NON-constraint detectors, captured in
        # phase 1 so the one-tuple DC repair minimization can protect those
        # cells without re-running detection (None unless a constraint
        # detector ran).
        self._non_constraint_frames: Optional[List[pd.DataFrame]] = None

    def _get_option_value(self, *args) -> Any:  # type: ignore
        return get_option_value(self.opts, *args)

    def _get_default_error_detectors(self, table: EncodedTable) -> List[ErrorDetector]:
        detectors: List[ErrorDetector] = [NullErrorDetector()]
        targets = self.targets if self.targets else table.column_names
        for c in targets:
            detectors.append(DomainValues(attr=c, autofill=True, min_count_thres=4))
        return detectors

    def _target_attrs(self, input_columns: List[str]) -> List[str]:
        target_attrs = [c for c in input_columns if c != self.row_id]
        if self.targets:
            target_attrs = [c for c in target_attrs if c in set(self.targets)]
        return target_attrs

    def _detect_error_cells(self, table: EncodedTable, input_name: str,
                            continuous_columns: List[str]) -> pd.DataFrame:
        detectors = self.error_detectors or self._get_default_error_detectors(table)
        _logger.info(
            f"[Error Detection Phase] Used error detectors: {to_list_str(detectors)}")
        target_attrs = self._target_attrs([self.row_id] + table.column_names)

        frames = []
        # the capture only feeds the one-tuple DC repair minimization, so it
        # is kept only when a constraint detector is present
        keep_capture = any(isinstance(d, ConstraintErrorDetector)
                           for d in detectors)
        self._non_constraint_frames = [] if keep_capture else None
        led = active_ledger()
        for d in detectors:
            d.setUp(self.row_id, input_name, continuous_columns, target_attrs,
                    encoded_table=table)
            cells = d.detect()
            frames.append(cells)
            if led is not None and len(cells):
                led.record_detection(
                    str(d), cells[ROW_IDX].to_numpy(),
                    cells["attribute"].to_numpy(dtype=object),
                    cells[self.row_id].to_numpy())
            if keep_capture and len(cells) \
                    and not isinstance(d, ConstraintErrorDetector):
                assert self._non_constraint_frames is not None
                self._non_constraint_frames.append(cells)
        if not frames:
            return pd.DataFrame(columns=[self.row_id, "attribute", ROW_IDX])
        if len(frames) == 1 and not isinstance(
                detectors[0], ConstraintErrorDetector):
            # a single non-constraint detector emits each (row, attribute)
            # at most once (constraint detectors repeat a cell once per
            # violated constraint, so they still need the dedup below)
            return frames[0].reset_index(drop=True)
        merged = pd.concat(frames, ignore_index=True)
        # dedup on the fused (row position, attribute code) int key,
        # keep-first like drop_duplicates
        attr_codes, attr_uniques = pd.factorize(
            merged["attribute"].to_numpy(dtype=object))
        key = merged[ROW_IDX].to_numpy().astype(np.int64) \
            * max(len(attr_uniques), 1) + attr_codes
        dup = pd.Series(key).duplicated().to_numpy()
        return merged[~dup].reset_index(drop=True)

    def _resolve_error_cells_input(self, table: EncodedTable) -> pd.DataFrame:
        """Maps a user-provided error-cell frame/view to the internal format
        (adds __row_idx__, drops cells for unknown rows/columns)."""
        df = self.error_cells
        if isinstance(df, str):
            df = self._session.table(df)
        assert isinstance(df, pd.DataFrame)
        df = df[[self.row_id, "attribute"]].copy()

        if len(self.targets) == 0:
            df = df[df["attribute"].isin(table.column_names)]
        else:
            df = df[df["attribute"].isin(self.targets)]

        # hash join from row ids to row positions; the dtype-coercion
        # fallback (e.g. str vs int ids) runs over DISTINCT unmatched ids
        # only. Row ids are unique (check_input_table), so get_indexer is
        # total.
        index = pd.Index(table.row_id_values)
        raw = df[self.row_id].to_numpy()
        idx = index.get_indexer(raw)
        if (idx < 0).any():
            row_index = table.row_index()
            miss_codes, miss_uniques = pd.factorize(raw, use_na_sentinel=False)
            lut = np.fromiter(
                (row_index.get(_coerce_like(r, table.row_id_values), -1)
                 for r in miss_uniques), dtype=np.int64,
                count=len(miss_uniques))
            idx = np.where(idx >= 0, idx, lut[miss_codes])
        df = df.assign(**{ROW_IDX: idx})
        df = df[df[ROW_IDX] >= 0].reset_index(drop=True)
        led = active_ledger()
        if led is not None and len(df):
            led.record_detection(
                "user_supplied", df[ROW_IDX].to_numpy(),
                df["attribute"].to_numpy(dtype=object),
                df[self.row_id].to_numpy())
        return df

    def _with_current_values(self, table: EncodedTable, cells_df: pd.DataFrame,
                             factorized=None) -> pd.DataFrame:
        """Adds the `current_value` column (CAST-to-string of the original
        cell), decoding per attribute group."""
        rows_arr = cells_df[ROW_IDX].to_numpy()
        currents = np.empty(len(cells_df), dtype=object)
        if factorized is None:
            factorized = pd.factorize(
                cells_df["attribute"].to_numpy(dtype=object))
        attr_codes, attr_uniques = factorized
        for ai, attr in enumerate(attr_uniques):
            sel = attr_codes == ai
            col = table.column(attr)
            codes = col.codes[rows_arr[sel].astype(np.int64)]
            vals = np.empty(len(codes), dtype=object)
            valid = codes >= 0
            vals[valid] = col.vocab[codes[valid]]
            vals[~valid] = None
            currents[sel] = vals
        out = cells_df.copy()
        out["current_value"] = currents
        return out[[self.row_id, "attribute", "current_value", ROW_IDX]]

    @job_phase(name="error detection")
    def _detect_errors(self, table: EncodedTable, input_name: str,
                       continuous_columns: List[str]) -> Tuple[pd.DataFrame, List[str]]:
        if self.error_cells is not None:
            noisy_cells_df = self._resolve_error_cells_input(table)
            _logger.info(
                f"[Error Detection Phase] Error cells provided by `{self.error_cells}`")
        else:
            noisy_cells_df = self._detect_error_cells(table, input_name, continuous_columns)
        noisy_columns: List[str] = []
        if len(noisy_cells_df) > 0:
            factorized = pd.factorize(
                noisy_cells_df["attribute"].to_numpy(dtype=object))
            noisy_columns = list(factorized[1])
            noisy_cells_df = self._with_current_values(
                table, noisy_cells_df, factorized=factorized)
            led = active_ledger()
            if led is not None:
                led.record_current_values(
                    noisy_cells_df[self.row_id].to_numpy(),
                    noisy_cells_df["attribute"].to_numpy(dtype=object),
                    noisy_cells_df["current_value"].to_numpy(dtype=object))
        return noisy_cells_df, noisy_columns

    @job_phase(name="attr stats")
    def _compute_attr_stats(self, disc: DiscretizedTable, target_columns: List[str],
                            domain_stats: Dict[str, int]) \
            -> Tuple[FreqStats, Dict[str, List[Tuple[str, float]]]]:
        """Candidate pair pruning -> freq stats (kernel K1) -> pairwise
        conditional entropy (kernel K2)."""
        discretized_attrs = disc.table.column_names
        candidate_pairs = select_candidate_pairs(
            PairDistinctCounter(disc.table),
            target_columns, discretized_attrs, domain_stats,
            self._get_option_value(*self._opt_pairwise_freq_ratio_threshold),
            self._get_option_value(*self._opt_max_attrs_to_compute_pairwise_stats))

        freq = compute_freq_stats(
            disc.table, discretized_attrs, candidate_pairs,
            self._get_option_value(*self._opt_attr_freq_ratio_threshold))

        pairwise = compute_pairwise_stats(
            freq.n_rows, freq, candidate_pairs, domain_stats)
        for t in target_columns:
            pairwise.setdefault(t, [])
        log_based_on_level(
            lambda: f"candidate pairs for pairwise stats: {candidate_pairs}")
        log_based_on_level(
            lambda: "pairwise conditional-entropy stats: "
            + "; ".join(f"{y}<-{[(x, round(h, 4)) for x, h in deps]}"
                        for y, deps in pairwise.items()))
        return freq, pairwise

    @job_phase(name="cell domain analysis")
    def _extract_error_cells_from(self, noisy_cells_df: pd.DataFrame,
                                  disc: DiscretizedTable,
                                  continuous_columns: List[str],
                                  target_columns: List[str],
                                  pairwise: Dict[str, List[Tuple[str, float]]],
                                  freq: FreqStats,
                                  domain_stats: Dict[str, int]) -> pd.DataFrame:
        _logger.info("[Error Detection Phase] Analyzing cell domains to fix error cells...")
        rows_np = noisy_cells_df[ROW_IDX].to_numpy().astype(np.int64)
        attrs_np = noisy_cells_df["attribute"].to_numpy(dtype=object)
        curs_np = noisy_cells_df["current_value"].to_numpy(dtype=object)

        # Weak labeling: if the top domain value equals the current value,
        # the cell is deemed clean.
        demote = compute_weak_label_mask(
            disc, (rows_np, attrs_np, curs_np), continuous_columns,
            target_columns, freq, pairwise, domain_stats,
            self._get_option_value(*self._opt_max_attrs_to_compute_domains),
            self._get_option_value(*self._opt_domain_threshold_alpha),
            self._get_option_value(*self._opt_domain_threshold_beta))
        fixed = int(demote.sum())
        led = active_ledger()
        if led is not None and fixed:
            led.record_weak_label_demotions(
                noisy_cells_df[self.row_id].to_numpy()[demote],
                attrs_np[demote])
        error_cells_df = noisy_cells_df[~demote].reset_index(drop=True)
        assert len(noisy_cells_df) == len(error_cells_df) + fixed
        counter_inc("domain.cells_fixed", fixed)
        _logger.info(
            f"[Error Detection Phase] {fixed} noisy cells fixed and "
            f"{len(error_cells_df)} error cells remaining...")
        return error_cells_df

    def detect(self, table: EncodedTable, input_name: str,
               continuous_columns: List[str]) \
            -> Tuple[pd.DataFrame, List[str], Dict[str, Any], Dict[str, int]]:
        noisy_cells_df, noisy_columns = self._detect_errors(
            table, input_name, continuous_columns)
        if len(noisy_cells_df) == 0:
            return noisy_cells_df, [], {}, {}

        disc = discretize_table(table, self.discrete_thres)
        self.discretized = disc
        domain_stats = disc.domain_stats
        discretized_columns = disc.table.column_names
        if len(discretized_columns) == 0:
            return noisy_cells_df, [], {}, {}

        target_columns = [c for c in noisy_columns if c in discretized_columns]
        if len(target_columns) == 0 or len(discretized_columns) <= 1:
            return noisy_cells_df, target_columns, {}, domain_stats

        freq, pairwise = self._compute_attr_stats(disc, target_columns, domain_stats)
        self.freq_stats = freq

        error_cells_df = noisy_cells_df
        if self.error_cells is None:
            error_cells_df = self._extract_error_cells_from(
                noisy_cells_df, disc, continuous_columns, target_columns,
                pairwise, freq, domain_stats)
        return error_cells_df, target_columns, pairwise, domain_stats


def _coerce_like(value: Any, reference_values: np.ndarray) -> Any:
    """Best-effort coercion of a user-provided row id to the table's dtype."""
    try:
        sample = reference_values[0]
    except IndexError:
        return value
    try:
        if isinstance(sample, (int, np.integer)):
            return int(value)
        if isinstance(sample, (float, np.floating)):
            return float(value)
        return str(value)
    except (TypeError, ValueError):
        return value
