"""RepairModel: the 3-phase repair pipeline (detect -> train -> repair).

The port of the JAX package's ``model.py``: the fluent setters and option
keys, error detection with any detector mix or user-supplied error cells
(:mod:`delphi_tpu_torch.errors`), rule repairs (regex structure, nearest
values under an update cost function, FD rule models), per-attribute
training on rows whose target is clean (sequential, or batched behind
``setParallelStatTrainingEnabled(True)``), batched repair inference over
the dirty rows (at once, or in blocks of ``DELPHI_REPAIR_CHUNK_ROWS``
rows), the one-tuple denial-constraint repair minimization, repair
validation against the constraints, and the PMF, score and
maximal-likelihood modes. Phase checkpoints (``DELPHI_CHECKPOINT_DIR`` /
``repair.checkpoint.dir``) let a run that died resume at its last
completed phase, model checkpoints (``model.checkpoint_path``) let a later
run skip training, and a fault plan (``DELPHI_FAULT_PLAN`` /
``repair.fault.plan``) injects faults at the resilience plane's guarded
sites (:mod:`delphi_tpu_torch.parallel.resilience`). Launch plans persist
per table fingerprint with ``DELPHI_PLAN_DIR``
(:mod:`delphi_tpu_torch.parallel.planner`), sequential training runs
through the pipeline thread (:mod:`delphi_tpu_torch.parallel.pipeline`),
and the prewarm thread loads the kernel library at run start
(:mod:`delphi_tpu_torch.parallel.compile_plane`). Settings of the
reference that the port does not have yet raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that brings them: multi-GPU (queue 1 item
9) and the run report, traces and live telemetry (item 10). With
``DELPHI_PROVENANCE_PATH`` / ``repair.provenance.path`` set, every flagged
cell gets a provenance ledger entry
(:mod:`delphi_tpu_torch.observability.provenance`); with
``repair.escalate`` on, the cells the models are unsure about go through
the escalation tiers (:mod:`delphi_tpu_torch.escalate`); with
``repair.incremental`` and a snapshot directory, a run repairs only the
rows that changed since the snapshot (:mod:`delphi_tpu_torch.incremental`).

DataFrames in and out are pandas.
"""

import contextlib
import copy
import hashlib
import heapq
import os
import zlib
from collections import namedtuple
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import pandas as pd

from delphi_tpu_torch import escalate as _escalate
from delphi_tpu_torch import incremental as _incremental
from delphi_tpu_torch.constraints import Constant
from delphi_tpu_torch.costs import UpdateCostFunction
from delphi_tpu_torch.depgraph import (compute_functional_dep_map,
                                       compute_functional_deps)
from delphi_tpu_torch.errors import (ROW_IDX, ConstraintErrorDetector,
                                     ErrorDetector, ErrorModel,
                                     RegExErrorDetector)
from delphi_tpu_torch.models.encoding import FeatureEncoder, OrdinalEncoder
from delphi_tpu_torch.observability import provenance as _prov
from delphi_tpu_torch.observability.provenance import active_ledger
from delphi_tpu_torch.parallel import compile_plane, planner
from delphi_tpu_torch.parallel import resilience as _resilience
from delphi_tpu_torch.parallel.pipeline import run_pipelined
from delphi_tpu_torch.regex_repair import RegexStructureRepair
from delphi_tpu_torch.session import AnalysisException, get_session
from delphi_tpu_torch.ops.detect import (_one_tuple_violations,
                                         detect_constraint_violations)
from delphi_tpu_torch.table import (KIND_FRACTIONAL, KIND_INTEGRAL,
                                    EncodedTable, check_encoded_table,
                                    check_input_table, encode_table)
from delphi_tpu_torch.train import (build_model, build_models_batched,
                                    rebalance_training_data,
                                    train_option_keys)
from delphi_tpu_torch.utils import (argtype_check, counter_inc,
                                    elapsed_time, get_option_value,
                                    job_phase, log_based_on_level,
                                    phase_span, setup_logger, to_list_str,
                                    train_reports)

_logger = setup_logger()

# The ROADMAP.md items that bring the settings run() still rejects
_MULTI_GPU_ITEM = "queue 1 item 9 of ROADMAP.md, multi-GPU"
_OBSERVABILITY_ITEM = "queue 1 item 10 of ROADMAP.md, observability"


class PoorModel:
    """Constant predictor fallback."""

    def __init__(self, v: Any) -> None:
        self.v = v

    @property
    def classes_(self) -> Any:
        return np.array([self.v])

    def predict(self, X: Any) -> Any:
        return [self.v] * len(X)

    def predict_proba(self, X: Any) -> Any:
        return [np.array([1.0])] * len(X)


class FunctionalDepModel:
    """Rule model looking values up in an FD map x -> y."""

    def __init__(self, x: str, fd_map: Dict[str, str]) -> None:
        self.fd_map = fd_map
        # sorted: str-set iteration order varies with hash randomization,
        # which would make classes_ (and PMF tie-breaking) vary across runs
        self.classes = sorted(set(fd_map.values()))
        self.x = x
        self.fd_keypos_map = {c: i for i, c in enumerate(self.classes)}

    @property
    def classes_(self) -> Any:
        return np.array(self.classes)

    def predict(self, X: pd.DataFrame) -> Any:
        return [self.fd_map.get(x, None) for x in X[self.x]]

    def predict_proba(self, X: pd.DataFrame) -> Any:
        pmf = []
        for x in X[self.x]:
            if x in self.fd_map:
                probs = np.zeros(len(self.classes))
                probs[self.fd_keypos_map[self.fd_map[x]]] = 1.0
                pmf.append(probs)
            else:
                _logger.warning(f'Unknown "{self.x}" domain value found: {x}')
                pmf.append(None)
        return pmf


def repair_attrs_from(updates_df: pd.DataFrame, base_df: pd.DataFrame,
                      row_id: str, continuous_cols: Dict[str, str]) -> pd.DataFrame:
    """Applies (row_id, attribute, repaired) updates into a table, with
    type-aware casts for continuous columns (RepairMiscApi.scala:184-247)."""
    need = {row_id, "attribute", "repaired"}
    if not need.issubset(updates_df.columns):
        raise AnalysisException(
            f"Table must have '{row_id}', 'attribute', and 'repaired' columns")

    out = base_df.copy()
    row_index = pd.Index(out[row_id])
    for attr, group in updates_df.groupby("attribute"):
        if attr not in out.columns:
            continue
        pos = row_index.get_indexer(group[row_id])
        present = pos >= 0
        rows = pos[present]
        if not len(rows):
            continue
        reps = pd.Series(group["repaired"].to_numpy(dtype=object)[present],
                         dtype=object)
        non_null = reps.notna().to_numpy()
        if attr in continuous_cols and non_null.any():
            conv = reps[non_null].astype(float)
            if continuous_cols[attr] == KIND_INTEGRAL:
                conv = conv.round().astype("int64")
            reps = reps.copy()
            reps[non_null] = conv.astype(object)
        values = reps.to_numpy(dtype=object)
        col = out[attr].copy()
        if pd.api.types.is_integer_dtype(col.dtype) and not non_null.all():
            col = col.astype("float64")
        elif pd.api.types.is_integer_dtype(col.dtype):
            values = pd.Series(values).astype("int64").to_numpy()
        # assign as a list: pandas accepts elementwise coercion for lists
        # where it rejects whole object-dtype arrays
        col.iloc[rows] = list(values)
        out[attr] = col
    return out


_FALSY = frozenset({"0", "false", "off", "no"})
_TRUTHY = frozenset({"1", "true", "yes", "on"})


def _raw(env: str, conf: Optional[str]) -> Optional[str]:
    """The setting's raw value as the JAX package reads it: the
    environment variable, when present and not blank, beats the session
    conf."""
    raw = os.environ.get(env)
    if (raw is None or not str(raw).strip()) and conf is not None:
        raw = get_session().conf.get(conf)
    if raw is None or not str(raw).strip():
        return None
    return str(raw).strip()


def _path_set(env: str, conf: Optional[str] = None) -> bool:
    """A path or address: set when not blank."""
    return _raw(env, conf) is not None


def _parses(env: str, conf: Optional[str], cast: Any) -> bool:
    """A number (a port, a timeout, a row floor): set when ``cast``
    parses it, as the JAX package ignores what it cannot parse."""
    raw = _raw(env, conf)
    if raw is None:
        return False
    try:
        cast(raw)
    except ValueError:
        return False
    return True


def _truthy(env: str, conf: Optional[str] = None) -> bool:
    """A flag the JAX package reads as on only when 1/true/yes/on."""
    raw = _raw(env, conf)
    return raw is not None and raw.lower() in _TRUTHY


def _not_false(env: str, conf: Optional[str] = None) -> bool:
    """A switch the JAX package reads as on unless blank or an explicit
    false spelling (0, false, off, no)."""
    raw = _raw(env, conf)
    return raw is not None and raw.lower() not in _FALSY


# (what the setting turns on, whether the JAX package would see it) of the
# planes the port does not have yet: multi-GPU (item 9) and observability
# (item 10). Each raises before any work; an explicit false spelling runs.
_MULTI_GPU_SETTINGS = [
    ("the device mesh (DELPHI_MESH or the session conf repair.mesh)",
     lambda: _not_false("DELPHI_MESH", "repair.mesh")),
    ("the row-shard plane (DELPHI_SHARD)",
     lambda: _not_false("DELPHI_SHARD")),
    ("the row-shard plane's row floor (DELPHI_SHARD_MIN_ROWS)",
     lambda: _parses("DELPHI_SHARD_MIN_ROWS", None, int)),
    ("a multi-process cluster (DELPHI_COORDINATOR)",
     lambda: _path_set("DELPHI_COORDINATOR")),
    ("a multi-process cluster (DELPHI_NUM_PROCESSES)",
     lambda: _parses("DELPHI_NUM_PROCESSES", None, int)),
    ("a multi-process cluster (DELPHI_PROCESS_ID)",
     lambda: _parses("DELPHI_PROCESS_ID", None, int)),
    ("the collective deadline (DELPHI_COLLECTIVE_TIMEOUT_S or the session "
     "conf repair.collective.timeout_s)",
     lambda: _parses("DELPHI_COLLECTIVE_TIMEOUT_S",
                     "repair.collective.timeout_s", float)),
]

_OBSERVABILITY_SETTINGS = [
    ("the run report (DELPHI_METRICS_PATH or the session conf "
     "repair.metrics.path)",
     lambda: _path_set("DELPHI_METRICS_PATH", "repair.metrics.path")),
    ("live telemetry (DELPHI_METRICS_PORT or the session conf "
     "repair.metrics.port)",
     lambda: _parses("DELPHI_METRICS_PORT", "repair.metrics.port", int)),
    ("the stall watchdog (DELPHI_STALL_TIMEOUT_S or the session conf "
     "repair.metrics.stall_timeout_s)",
     lambda: _parses("DELPHI_STALL_TIMEOUT_S",
                     "repair.metrics.stall_timeout_s", float)),
    ("the run report's event stream (DELPHI_METRICS_EVENTS or the session "
     "conf repair.metrics.events)",
     lambda: _truthy("DELPHI_METRICS_EVENTS", "repair.metrics.events")),
    ("the launch planner's cost veto (DELPHI_PLAN_COST)",
     lambda: _truthy("DELPHI_PLAN_COST")),
    ("request traces (DELPHI_TRACE_DIR)",
     lambda: _path_set("DELPHI_TRACE_DIR")),
    ("request traces' sampling (DELPHI_TRACE_SAMPLE)",
     lambda: _parses("DELPHI_TRACE_SAMPLE", None, float)),
    ("device profiles (DELPHI_PROFILE_DIR or the session conf "
     "repair.profile.dir)",
     lambda: _path_set("DELPHI_PROFILE_DIR", "repair.profile.dir")),
    ("the phase heartbeat (DELPHI_PHASE_HEARTBEAT)",
     lambda: _truthy("DELPHI_PHASE_HEARTBEAT")),
    ("the resource sampler (DELPHI_RESOURCE_SAMPLER)",
     lambda: _truthy("DELPHI_RESOURCE_SAMPLER")),
]


class RepairModel:
    """Fluent repair-model builder."""

    _option = namedtuple("_option", "key default_value type_class validator err_msg")

    _opt_max_training_row_num = \
        _option("model.max_training_row_num", 10000, int,
                lambda v: v >= 10, "`{}` should be greater than and equal to 10")
    _opt_max_training_column_num = \
        _option("model.max_training_column_num", 65536, int,
                lambda v: v >= 2, "`{}` should be greater than 1")
    _opt_small_domain_threshold = \
        _option("model.small_domain_threshold", 12, int,
                lambda v: v >= 3, "`{}` should be greater than 2")
    _opt_repair_by_regex_disabled = \
        _option("model.rule.repair_by_regex.disabled", True, bool, None, None)
    _opt_repair_by_nearest_values_disabled = \
        _option("model.rule.repair_by_nearest_values.disabled", True, bool, None, None)
    _opt_merge_threshold = \
        _option("model.rule.merge_threshold", 2.0, float, None, None)
    _opt_repair_by_functional_deps_disabled = \
        _option("model.rule.repair_by_functional_deps.disabled", False, bool, None, None)
    _opt_max_domain_size = \
        _option("model.rule.max_domain_size", 1000, int,
                lambda v: v > 10, "`{}` should be greater than 10")
    _opt_cost_weight = \
        _option("repair.pmf.cost_weight", 0.1, float,
                lambda v: v > 0.0, "`{}` should be positive")
    _opt_prob_threshold = \
        _option("repair.pmf.prob_threshold", 0.0, float, None, None)
    _opt_prob_top_k = \
        _option("repair.pmf.prob_top_k", 32, int,
                lambda v: v >= 3, "`{}` should be greater than 2")
    _opt_checkpoint_path = \
        _option("model.checkpoint_path", "", str, None, None)
    _opt_snapshot_dir = \
        _option("repair.snapshot.dir", "", str, None, None)
    _opt_incremental = \
        _option("repair.incremental", False, bool, None, None)
    _opt_escalate = \
        _option("repair.escalate", False, bool, None, None)
    _opt_escalate_conf = \
        _option("repair.escalate.conf", 0.5, float,
                lambda v: 0.0 <= v <= 1.0, "`{}` should be in [0.0, 1.0]")
    _opt_escalate_budget = \
        _option("repair.escalate.budget", 256, int,
                lambda v: v >= 0, "`{}` should be greater than or equal to 0")
    _opt_escalate_iters = \
        _option("repair.escalate.iters", 8, int,
                lambda v: v >= 1, "`{}` should be greater than 0")
    _opt_escalate_adapter = \
        _option("repair.escalate.adapter", "", str, None, None)

    option_keys = set([
        _opt_max_training_row_num.key,
        _opt_max_training_column_num.key,
        _opt_small_domain_threshold.key,
        _opt_repair_by_regex_disabled.key,
        _opt_repair_by_nearest_values_disabled.key,
        _opt_merge_threshold.key,
        _opt_repair_by_functional_deps_disabled.key,
        _opt_max_domain_size.key,
        _opt_cost_weight.key,
        _opt_prob_threshold.key,
        _opt_prob_top_k.key,
        _opt_checkpoint_path.key,
        _opt_snapshot_dir.key,
        _opt_incremental.key,
        _opt_escalate.key,
        _opt_escalate_conf.key,
        _opt_escalate_budget.key,
        _opt_escalate_iters.key,
        _opt_escalate_adapter.key,
        *ErrorModel.option_keys,
        *train_option_keys])

    def __init__(self) -> None:
        self.db_name: str = ""
        self.input: Optional[Union[str, pd.DataFrame]] = None
        self.row_id: Optional[str] = None
        self.targets: List[str] = []

        self.error_cells: Optional[Union[str, pd.DataFrame]] = None
        self.error_detectors: List[ErrorDetector] = []
        self.discrete_thres: int = 80

        self.parallel_stat_training_enabled: bool = False
        self.training_data_rebalancing_enabled: bool = False
        self.repair_by_rules: bool = False

        self.repair_delta: Optional[int] = None
        self.repair_validation_enabled: bool = False

        self.cf: Optional[UpdateCostFunction] = None
        self.opts: Dict[str, str] = {}
        self._session = get_session()
        # phase 1's non-constraint detector frames (see `_detect_errors`)
        self._phase1_non_constraint_frames: Optional[List[pd.DataFrame]] = None
        # the cells the last one-tuple DC minimization reverted
        self._dc_reverted: set = set()

    # -- fluent setters ------------------------------------------------------

    @argtype_check  # type: ignore
    def setDbName(self, db_name: str) -> "RepairModel":
        """Sets the database prefix used to qualify ``table_name`` inputs."""
        if type(self.input) is pd.DataFrame:
            raise ValueError("Can not specify a database name when input is `DataFrame`")
        self.db_name = db_name
        return self

    @argtype_check  # type: ignore
    def setTableName(self, table_name: str) -> "RepairModel":
        """Sets the input by registered table name."""
        if not table_name:
            raise ValueError("`table_name` should have at least character")
        self.input = table_name
        return self

    @argtype_check  # type: ignore
    def setInput(self, input: Union[str, pd.DataFrame]) -> "RepairModel":
        """Sets the input table: a registered table name or a DataFrame."""
        if type(input) is str:
            self.setTableName(input)
        else:
            self.db_name = ""
            self.input = input
        return self

    @argtype_check  # type: ignore
    def setRowId(self, row_id: str) -> "RepairModel":
        """Names the column holding the unique row identifier."""
        if not row_id:
            raise ValueError("`row_id` should have at least character")
        self.row_id = row_id
        return self

    @argtype_check  # type: ignore
    def setTargets(self, attrs: List[str]) -> "RepairModel":
        """Restricts detection/repair to the given attributes."""
        if len(attrs) == 0:
            raise ValueError("`attrs` should have at least one attribute")
        self.targets = attrs
        return self

    @argtype_check  # type: ignore
    def setErrorCells(self, error_cells: Union[str, pd.DataFrame]) -> "RepairModel":
        """Supplies known error cells (``(row_id, attribute)`` columns)."""
        if type(error_cells) is str and not error_cells:
            raise ValueError("`error_cells` should have at least character")
        if self.row_id is None:
            raise ValueError("`setRowId` should be called before specifying error cells")
        df = error_cells if type(error_cells) is pd.DataFrame \
            else self._session.table(str(error_cells))
        if not all(c in df.columns for c in [self._row_id, "attribute"]):
            raise ValueError(
                f"Error cells should have `{self.row_id}` and `attribute` in columns")
        self.error_cells = error_cells
        return self

    @argtype_check  # type: ignore
    def setErrorDetectors(self, detectors: List[ErrorDetector]) -> "RepairModel":
        """Sets the detectors that propose noisy cells in phase 1."""
        self.error_detectors = detectors
        return self

    @argtype_check  # type: ignore
    def setDiscreteThreshold(self, thres: int) -> "RepairModel":
        """Sets the max domain size for an attribute to stay discrete."""
        if int(thres) < 2:
            raise ValueError(f"`thres` should be bigger than 1, got {thres}")
        self.discrete_thres = thres
        return self

    @argtype_check  # type: ignore
    def setParallelStatTrainingEnabled(self, enabled: bool) -> "RepairModel":
        """Selects batched multi-target training: the targets' CV searches
        and final fits share device launches."""
        self.parallel_stat_training_enabled = enabled
        return self

    @argtype_check  # type: ignore
    def setTrainingDataRebalancingEnabled(self, enabled: bool) -> "RepairModel":
        """Enables class rebalancing of training rows toward the median
        class size before fitting classifiers."""
        self.training_data_rebalancing_enabled = enabled
        return self

    @argtype_check  # type: ignore
    def setRepairByRules(self, enabled: bool) -> "RepairModel":
        """Enables rule-based repairs before model training: regex
        structure repair, nearest-value merging (with a cost function) and
        functional-dependency rules, each switched by a ``model.rule.*``
        option."""
        self.repair_by_rules = enabled
        return self

    @argtype_check  # type: ignore
    def setRepairDelta(self, delta: int) -> "RepairModel":
        """Caps how many repairs the maximal-likelihood mode keeps."""
        if delta <= 0:
            raise ValueError(f"Repair delta should be positive, got {delta}")
        self.repair_delta = int(delta)
        return self

    @argtype_check  # type: ignore
    def setUpdateCostFunction(self, cf: UpdateCostFunction) -> "RepairModel":
        """Sets the cost of changing value x into y, used by nearest-value
        repairs, to weight PMFs and in maximal-likelihood scores:
        :class:`Levenshtein` or a :class:`UserDefinedUpdateCostFunction`."""
        self.cf = cf
        return self

    @argtype_check  # type: ignore
    def option(self, key: str, value: str) -> "RepairModel":
        """Sets one expert option by key, validated against the registered
        ``model.*`` / ``error.*`` / ``repair.*`` keys."""
        if key not in self.option_keys:
            raise ValueError(f"Non-existent key specified: key={key}")
        self.opts[key] = value
        return self

    # -- internal helpers ----------------------------------------------------

    def _get_option_value(self, *args) -> Any:  # type: ignore
        return get_option_value(self.opts, *args)

    @property
    def _row_id(self) -> str:
        return str(self.row_id)

    @property
    def _input_frame(self) -> Tuple[pd.DataFrame, str]:
        if type(self.input) is pd.DataFrame:
            return self.input, "input"
        name = self._session.qualified_name(self.db_name, str(self.input))
        return self._session.table(name), name

    @property
    def _error_cells_frame(self) -> Optional[pd.DataFrame]:
        if self.error_cells is None:
            return None
        df = self.error_cells if type(self.error_cells) is pd.DataFrame \
            else self._session.table(str(self.error_cells))
        return df[[self._row_id, "attribute"]]

    @property
    def _repair_by_regex_enabled(self) -> bool:
        return not bool(self._get_option_value(*self._opt_repair_by_regex_disabled)) \
            and self.repair_by_rules

    @property
    def _repair_by_nearest_values_enabled(self) -> bool:
        return not bool(self._get_option_value(*self._opt_repair_by_nearest_values_disabled)) \
            and self.repair_by_rules and self.cf is not None

    @property
    def _repair_by_functional_deps_enabled(self) -> bool:
        return not bool(self._get_option_value(*self._opt_repair_by_functional_deps_disabled)) \
            and self.repair_by_rules

    def _filter_columns_from(self, df: pd.DataFrame, targets: List[str],
                             negate: bool = False) -> pd.DataFrame:
        mask = df["attribute"].isin(targets)
        return df[~mask if negate else mask].reset_index(drop=True)

    def _reject_unported(self) -> None:
        """Raises for every setting of the reference the port does not
        have yet, before any work starts: none is silently ignored. Each
        setting is read as the JAX package reads it (option, then
        environment, then session conf), so an explicit false spelling
        does not raise."""
        for settings, later in ((_MULTI_GPU_SETTINGS, _MULTI_GPU_ITEM),
                                (_OBSERVABILITY_SETTINGS,
                                 _OBSERVABILITY_ITEM)):
            for what, is_set in settings:
                if is_set():
                    raise NotImplementedError(
                        f"{what} is not ported to delphi_tpu_torch yet "
                        f"({later})")

    # -- phase 1: error detection --------------------------------------------

    def _detect_errors(self, table: EncodedTable, input_name: str,
                       continuous_columns: List[str]) -> Any:
        error_model = ErrorModel(
            row_id=self._row_id,
            targets=self.targets,
            discrete_thres=self.discrete_thres,
            error_detectors=self.error_detectors,
            error_cells=self._error_cells_frame,
            opts=self.opts)
        result = error_model.detect(table, input_name, continuous_columns)
        # keep ONLY phase 1's per-detector cell frames (not the whole
        # ErrorModel with its discretized table and stats) so the one-tuple
        # DC repair minimization never re-runs detection; they are None
        # unless a constraint detector ran
        self._phase1_non_constraint_frames = error_model._non_constraint_frames
        return result

    # -- phase 2 helpers: rule-based repairs ----------------------------------

    def _empty_repaired_cells_frame(self) -> pd.DataFrame:
        return pd.DataFrame(
            columns=[self._row_id, "attribute", "current_value", "repaired", ROW_IDX])

    def _repair_by_regexs(self, error_cells_df: pd.DataFrame) \
            -> Tuple[pd.DataFrame, pd.DataFrame]:
        regex_detectors = [d for d in self.error_detectors
                           if isinstance(d, RegExErrorDetector)]
        if not regex_detectors:
            return error_cells_df, self._empty_repaired_cells_frame()

        regexs = [(d.attr, d.regex) for d in regex_detectors]
        _logger.info(f"[Repairing Phase] Repairing data using regexs: {to_list_str(regexs)}")

        repaired_frames = []
        for attr, regex in regexs:
            target_cells = error_cells_df[error_cells_df["attribute"] == attr]
            if len(target_cells) == 0:
                continue
            try:
                repairer = RegexStructureRepair(regex)
            except Exception as e:
                _logger.warning(
                    f"Repairing using regex '{regex}' (attr='{attr}') failed because: {e}")
                continue
            # a NULL current value may read back as NaN (string-dtype
            # frames), which the regex cannot take: the JAX package raises
            # TypeError there; the port leaves such a cell to the models
            repaired = [repairer(cv) if not _is_null(cv) else None
                        for cv in target_cells["current_value"]]
            fixed = target_cells.assign(repaired=repaired)
            fixed = fixed[fixed["repaired"].notna()]
            if len(fixed):
                repaired_frames.append(fixed)

        if not repaired_frames:
            return error_cells_df, self._empty_repaired_cells_frame()
        repaired_cells_df = pd.concat(repaired_frames, ignore_index=True)
        keys = set(zip(repaired_cells_df[self._row_id], repaired_cells_df["attribute"]))
        keep = [
            (r, a) not in keys
            for r, a in zip(error_cells_df[self._row_id], error_cells_df["attribute"])
        ]
        return error_cells_df[keep].reset_index(drop=True), repaired_cells_df

    def _repair_by_nearest_values(self, masked: EncodedTable,
                                  error_cells_df: pd.DataFrame,
                                  target_columns: List[str],
                                  integral_columns: Set[str]) \
            -> Tuple[pd.DataFrame, pd.DataFrame]:
        assert self.cf is not None
        cf_targets = self.cf.targets
        targets = [c for c in target_columns if c in cf_targets] if cf_targets \
            else target_columns
        if not targets:
            return error_cells_df, self._empty_repaired_cells_frame()

        merge_threshold = self._get_option_value(*self._opt_merge_threshold)
        # Per-target domain = the vocab entries still present after masking.
        # Vocab spellings already match the distance space: str(int(v)) for
        # integral attrs ('100', not the NULL-padded float view's '100.0'),
        # str(float(v)) for fractional, raw strings otherwise (encode_column).
        domains: Dict[str, List[str]] = {}
        for c in targets:
            col = masked.column(c)
            present = np.unique(col.codes[col.codes >= 0])
            domains[c] = [str(v) for v in col.vocab[present]]

        # One nearest-value resolution per unique (attribute, current value):
        # every duplicate dirty cell reuses it, and each resolution is one
        # batched (native) Levenshtein call over the whole domain.
        ec = error_cells_df.reset_index(drop=True)
        attrs = ec["attribute"].to_numpy(dtype=object)
        curs = ec["current_value"].to_numpy(dtype=object)
        repaired_vals = np.full(len(ec), None, dtype=object)
        resolved: Dict[Tuple[str, Any], Optional[str]] = {}
        for i in range(len(ec)):
            dvs = domains.get(attrs[i])
            cur = curs[i]
            if not dvs or cur is None:
                continue
            key = (attrs[i], cur)
            if key not in resolved:
                resolved[key] = self._nearest_value(cur, dvs, merge_threshold)
            repaired_vals[i] = resolved[key]

        mask = np.array([v is not None for v in repaired_vals], dtype=bool)
        repaired_df = ec[mask].assign(repaired=repaired_vals[mask]) \
            if mask.any() else self._empty_repaired_cells_frame()
        error_df = ec[~mask].reset_index(drop=True) if (~mask).any() \
            else error_cells_df.iloc[0:0]
        return error_df, repaired_df

    def _nearest_value(self, cur: Any, dvs: List[str],
                       merge_threshold: float) -> Optional[str]:
        """Repairs to the unique lowest-cost domain value when it is under
        the merge threshold and strictly beats the runner-up."""
        assert self.cf is not None
        costs = self.cf.compute_many(cur, dvs)
        if costs is None:
            return None
        scored = sorted(((c, v) for c, v in zip(costs, dvs) if c is not None))
        if len(scored) >= 2 and scored[0][0] <= merge_threshold \
                and scored[0][0] < scored[1][0]:
            return scored[0][1]
        return None

    def _repair_by_rules(self, masked: EncodedTable,
                         error_cells_df: pd.DataFrame, target_columns: List[str],
                         integral_columns: Set[str]) \
            -> Tuple[pd.DataFrame, pd.DataFrame]:
        """Regex-structure repairs, then nearest-value repairs, of the error
        cells; returns (the cells still to repair, the rule repairs). The
        count of each goes to ``utils.counters`` (``rules.regex_repairs``,
        ``rules.nearest_value_repairs``)."""
        led = active_ledger()

        def _record_rule_repairs(frame: pd.DataFrame, reason: str) -> None:
            if led is not None and len(frame):
                led.record_decisions(
                    frame[self._row_id].to_numpy(),
                    frame["attribute"].to_numpy(dtype=object),
                    _prov.DECISION_REPAIRED, reason,
                    repaired=frame["repaired"].to_numpy(dtype=object))

        repaired_dfs = [self._empty_repaired_cells_frame()]
        if self._repair_by_regex_enabled:
            error_cells_df, by_regex = self._repair_by_regexs(error_cells_df)
            counter_inc("rules.regex_repairs", len(by_regex))
            _record_rule_repairs(by_regex, _prov.REASON_RULE_REGEX_STRUCTURE)
            repaired_dfs.append(by_regex)
        if self._repair_by_nearest_values_enabled:
            error_cells_df, by_nv = self._repair_by_nearest_values(
                masked, error_cells_df, target_columns, integral_columns)
            counter_inc("rules.nearest_value_repairs", len(by_nv))
            _record_rule_repairs(by_nv, _prov.REASON_RULE_NEAREST_VALUE)
            repaired_dfs.append(by_nv)
        repaired_by_rules = pd.concat(repaired_dfs, ignore_index=True)
        return error_cells_df, repaired_by_rules

    # -- phase 2: model training ----------------------------------------------

    def _select_features(self, pairwise_attr_stats: Dict[str, Any], y: str,
                         features: List[str]) -> List[str]:
        """Correlation-ranked feature pruning."""
        log_based_on_level(
            lambda: f"selecting features for y={y} from candidates {features} "
            f"using pairwise stats {pairwise_attr_stats.get(y)}")
        max_cols = int(self._get_option_value(*self._opt_max_training_column_num))
        if max_cols < len(features) and y in pairwise_attr_stats:
            heap: List[Tuple[float, str]] = []
            for f, corr in map(tuple, pairwise_attr_stats[y]):
                if f in features:
                    heapq.heappush(heap, (float(corr), f))
            fts = [heapq.heappop(heap) for _ in range(len(heap))]
            top_k: List[Tuple[float, str]] = []
            for corr, f in fts:
                if len(top_k) <= 1 or (float(corr) >= 0.0 and len(top_k) < max_cols):
                    top_k.append((float(corr), f))
            if not top_k:
                _logger.info(
                    "[Repair Model Training Phase] no pairwise stats for {}; "
                    "keeping the first {} of {} features".format(
                        y, min(max_cols, len(features)), len(features)))
                return features[:max_cols]
            _logger.info(
                "[Repair Model Training Phase] {} features ({}) selected from {} "
                "features".format(
                    len(top_k), to_list_str([f"{f}:{c}" for c, f in top_k]),
                    len(features)))
            features = [f for _, f in top_k]
        return features

    @staticmethod
    def _encode_features(transformers: List[Any], X: Any,
                         fit: bool = False, compact: bool = True) -> Any:
        """Runs the feature transformers, routing FeatureEncoder through the
        factored one-hot design (the logistic head's gather path) unless
        the caller needs a dense, row-indexable matrix (``compact=False``,
        e.g. rebalancing). Training and prediction both encode here."""
        for t in transformers:
            use_compact = compact and isinstance(t, FeatureEncoder)
            if fit:
                X = t.fit_transform_compact(X) if use_compact \
                    else t.fit_transform(X)
            else:
                X = t.transform_compact(X) if use_compact else t.transform(X)
        return X

    def _create_transformers(self, features: List[str],
                             continuous_columns: List[str],
                             is_discrete: bool = True,
                             num_class: int = 0) -> List[Any]:
        from delphi_tpu_torch.models.gbdt import gbdt_supported
        if gbdt_supported(is_discrete, num_class):
            # tree models consume ordinal codes + raw continuous values
            return [OrdinalEncoder(features, continuous_columns)]
        return [FeatureEncoder(features, continuous_columns)]

    def _get_functional_deps(self, column_names: List[str],
                             target_columns: List[str]) \
            -> Optional[Dict[str, List[str]]]:
        constraint_detectors = [d for d in self.error_detectors
                                if isinstance(d, ConstraintErrorDetector)]
        if len(constraint_detectors) == 1:
            ced = constraint_detectors[0]
            constraint_targets = [c for c in target_columns if c in ced.targets] \
                if ced.targets else target_columns
            return compute_functional_deps(
                pd.DataFrame(columns=column_names), ced.constraint_path,
                ced.constraints, constraint_targets)
        elif len(constraint_detectors) > 1:
            _logger.warning(
                "Multiple constraint classes not supported for detecting functional deps")
            return None
        return None

    def _sample_training_positions(self, positions: np.ndarray) -> np.ndarray:
        """Downsamples the candidate row positions to the training-row cap
        with the reference's draw (``pd.Series(...).sample(frac,
        random_state=42)``), so both packages train on the same rows."""
        training_data_num = len(positions)
        max_rows = int(self._get_option_value(*self._opt_max_training_row_num))
        if training_data_num > max_rows:
            ratio = float(max_rows) / training_data_num
            _logger.info(
                f"To reduce training data, extracts {ratio * 100.0}% samples "
                f"from {training_data_num} rows")
            return pd.Series(positions).sample(
                frac=ratio, random_state=42).to_numpy()
        return positions

    def _prepare_training_task(self, y: str, masked: EncodedTable,
                               float_cols: Tuple[str, ...],
                               continuous_columns: List[str],
                               feature_map: Dict[str, List[str]],
                               transformer_map: Dict[str, List[Any]]) \
            -> Optional[Tuple[Any, Any, int]]:
        """Training-set assembly for one target: sample to the row cap,
        decode only the sample, fit-encode features, optionally rebalance.
        Returns (X, y_series, n_rows) or None without clean rows."""
        y_codes = masked.column(y).codes
        valid_pos = np.flatnonzero(y_codes >= 0)
        if len(valid_pos) == 0:
            return None
        sel_pos = self._sample_training_positions(valid_pos)
        train_pdf = masked.to_pandas(
            rows=sel_pos, columns=list(feature_map[y]) + [y],
            integral_as_float=float_cols)
        is_discrete = y not in continuous_columns
        X, y_ = self._encode_training_frame(
            y, train_pdf, is_discrete, feature_map, transformer_map)
        return X, y_, len(train_pdf)

    def _encode_training_frame(self, y: str, train_pdf: pd.DataFrame,
                               is_discrete: bool,
                               feature_map: Dict[str, List[str]],
                               transformer_map: Dict[str, List[Any]]) \
            -> Tuple[Any, Any]:
        """Fit-encodes a decoded training frame (+ optional rebalancing).
        Linear-head targets train from the factored one-hot design;
        rebalancing needs row indexing, so it keeps dense."""
        X: Any = self._encode_features(
            transformer_map[y], train_pdf[feature_map[y]], fit=True,
            compact=not (is_discrete
                         and self.training_data_rebalancing_enabled))
        if is_discrete and self.training_data_rebalancing_enabled:
            return rebalance_training_data(X, train_pdf[y], y)
        return X, train_pdf[y]

    def _use_batched_training(self, n_pending: int) -> bool:
        """Whether phase 2 trains its targets through the batched path
        (`train.build_models_batched`). ``DELPHI_BATCH_TRAIN=1/0`` forces
        the choice, as in the JAX package; otherwise more than one pending
        target and ``setParallelStatTrainingEnabled(True)``. The reference
        also defaults to it on accelerators; the port pins its CPU choice
        (sequential) on the card too."""
        setting = os.environ.get("DELPHI_BATCH_TRAIN", "auto")
        if setting == "1":
            return True
        if setting == "0":
            return False
        return n_pending > 1 and self.parallel_stat_training_enabled

    def _build_repair_stat_models(
            self, models: Dict[str, Any], masked: EncodedTable,
            float_cols: Tuple[str, ...],
            target_columns: List[str], continuous_columns: List[str],
            num_class_map: Dict[str, int],
            feature_map: Dict[str, List[str]],
            transformer_map: Dict[str, List[Any]]) -> Dict[str, Any]:
        """Builds the remaining per-attribute stat models: batched (every
        target's CV search and final fit in shared launches) or one target
        at a time (`_use_batched_training`), the latter through the
        pipeline (:mod:`delphi_tpu_torch.parallel.pipeline`), which
        prepares the next target's training set on the host while the
        current one trains. A failed fit becomes a ``PoorModel(None)``."""
        pending = [c for c in target_columns if c not in models]

        def _prep_target(y: str) -> Any:
            # host featurization only (sampling, lazy decode, fit-encode):
            # under the pipeline it runs on the producer thread, which
            # must not touch the card
            return self._prepare_training_task(
                y, masked, float_cols, continuous_columns, feature_map,
                transformer_map)

        def _log_building(index: int, y: str, n_rows: int) -> None:
            _logger.info(
                "Building {}/{} model... type={} y={} features={} #rows={}{}".format(
                    index, len(target_columns),
                    "regressor" if y in continuous_columns else "classfier",
                    y, to_list_str(feature_map[y]), n_rows,
                    f" #class={num_class_map[y]}" if num_class_map[y] > 0 else ""))

        def _log_skipping(index: int, y: str) -> None:
            _logger.info(
                "Skipping {}/{} model... type=classfier y={} num_class={}".format(
                    index, len(target_columns), y, num_class_map[y]))

        if self._use_batched_training(len(pending)):
            tasks = []
            for y in pending:
                index = len(models) + len(tasks) + 1
                prep = _prep_target(y)
                if prep is None:
                    _log_skipping(index, y)
                    models[y] = (PoorModel(None), feature_map[y], None)
                    continue
                X, y_, n_rows = prep
                _log_building(index, y, n_rows)
                tasks.append((y, X, y_, y not in continuous_columns,
                              num_class_map[y]))
            if tasks:
                _logger.info(
                    f"Training {len(tasks)} models in batched device launches...")
                out = build_models_batched(tasks, self.opts)
                for y, *_ in tasks:
                    (model, score), elapsed = out[y]
                    _logger.info(
                        f"Finishes building '{y}' model...  score={score} "
                        f"elapsed={elapsed}s")
                    self._keep_model(models, y, model, feature_map,
                                     transformer_map)
            return models

        def _train_target(y: str, prep: Any) -> None:
            # runs in target order on the calling thread: progress logs and
            # the models dict change exactly as in the sequential loop
            index = len(models) + 1
            if prep is None:
                _log_skipping(index, y)
                models[y] = (PoorModel(None), feature_map[y], None)
                return
            X, y_, n_rows = prep
            _log_building(index, y, n_rows)
            (model, score), elapsed = build_model(
                X, y_, y not in continuous_columns, num_class_map[y],
                n_jobs=-1, opts=self.opts)
            _logger.info(
                f"Finishes building '{y}' model...  score={score} elapsed={elapsed}s")
            self._keep_model(models, y, model, feature_map, transformer_map)

        run_pipelined(pending, _prep_target, _train_target)
        return models

    @staticmethod
    def _keep_model(models: Dict[str, Any], y: str, model: Any,
                    feature_map: Dict[str, List[str]],
                    transformer_map: Dict[str, List[Any]]) -> None:
        """Stores a trained model (a failed fit becomes ``PoorModel(None)``)
        and appends its training record to ``utils.train_reports``."""
        if model is None:
            model = PoorModel(None)
        train_reports.append({"target": y, "model": model,
                              **getattr(model, "train_report_", {})})
        models[y] = (model, feature_map[y], transformer_map[y])

    def _resolve_prediction_order(self, models: Dict[str, Any],
                                  target_columns: List[str]) -> List[Any]:
        """Orders FD models after the attributes they depend on."""
        pred_ordered_models = []
        error_columns = copy.deepcopy(target_columns)

        for y in target_columns:
            (model, x, transformers) = models[y]
            if not isinstance(model, FunctionalDepModel):
                pred_ordered_models.append((y, models[y]))
                error_columns.remove(y)

        while len(error_columns) > 0:
            columns = copy.deepcopy(error_columns)
            for y in columns:
                (model, x, transformers) = models[y]
                if x[0] not in error_columns:
                    pred_ordered_models.append((y, models[y]))
                    error_columns.remove(y)
            assert len(error_columns) < len(columns)

        _logger.info("Resolved prediction order dependencies: {}".format(
            to_list_str([x[0] for x in pred_ordered_models])))
        assert len(pred_ordered_models) == len(target_columns)
        return pred_ordered_models

    @job_phase(name="repair model training")
    def _build_repair_models(self, masked: EncodedTable,
                             float_cols: Tuple[str, ...],
                             target_columns: List[str],
                             continuous_columns: List[str],
                             domain_stats: Dict[str, Any],
                             pairwise_attr_stats: Dict[str, Any]) -> List[Any]:
        """SCARE-style per-attribute conditional models P(e_y | clean attrs)
        trained on the rows whose y is clean; with ``setRepairByRules``, FD
        rules stand in for training where a clean attribute determines y."""
        train_columns = masked.column_names

        functional_deps = self._get_functional_deps(train_columns, target_columns) \
            if self._repair_by_functional_deps_enabled else None
        if functional_deps:
            _logger.info(f"Functional deps found: {functional_deps}")
        _logger.info(
            "[Repair Model Training Phase] Building {} models to repair the cells "
            "in {}".format(len(target_columns), to_list_str(target_columns)))

        models: Dict[str, Any] = {}
        train_reports.clear()  # the records of this run only
        num_class_map: Dict[str, int] = {}
        # the incremental executor pre-seeds frozen models for attributes
        # the drift gate cleared; those targets skip class counting and
        # training
        frozen: Dict[str, Any] = getattr(
            self, "_incremental_frozen_models", None) or {}
        for y, m in frozen.items():
            if y in target_columns:
                models[y] = m
        if models:
            _logger.info("Reusing {} frozen repair models: {}".format(
                len(models), to_list_str(sorted(models))))

        for y in target_columns:
            if y in models:
                continue
            index = len(models) + 1
            input_columns = [c for c in train_columns if c != y]
            is_discrete = y not in continuous_columns
            y_col = masked.column(y)
            y_valid = y_col.codes >= 0
            num_class_map[y] = int(len(np.unique(y_col.codes[y_valid]))) \
                if is_discrete else 0
            if is_discrete and num_class_map[y] <= 1:
                _logger.info(
                    "Skipping {}/{} model... type=rule y={} num_class={}".format(
                        index, len(target_columns), y, num_class_map[y]))
                v = None
                if num_class_map[y] == 1 and bool(y_valid.any()):
                    v = y_col.vocab[y_col.codes[int(np.argmax(y_valid))]]
                models[y] = (PoorModel(v), input_columns, None)

            if y not in models and functional_deps is not None and y in functional_deps:
                max_domain = int(self._get_option_value(*self._opt_max_domain_size))
                fx = [x for x in functional_deps[y]
                      if int(domain_stats[x]) < max_domain]
                if len(fx) > 0:
                    fd_frame = masked.to_pandas(
                        columns=[fx[0], y], integral_as_float=float_cols)
                    fd_map = compute_functional_dep_map(fd_frame, fx[0], y)
                    # Coverage guard: a FunctionalDepModel returns None (an
                    # unrepairable cell) for every x value absent from the
                    # map, so when masking left too many x groups without a
                    # surviving y, a trained stat model repairs y instead.
                    x_vals = fd_frame[fx[0]].dropna().astype(str)
                    coverage = float(x_vals.isin(fd_map.keys()).mean()) \
                        if len(x_vals) else 0.0
                    if coverage >= 0.8:
                        _logger.info(
                            "Building {}/{} model... type=rule(FD: X->y)  y={}(|y|={}) "
                            "X={}(|X|={})".format(
                                index, len(target_columns), y, num_class_map[y],
                                fx[0], domain_stats[fx[0]]))
                        models[y] = (FunctionalDepModel(fx[0], fd_map), [fx[0]], None)
                    else:
                        _logger.info(
                            f"Skipping FD rule for y={y} (X={fx[0]} covers only "
                            f"{coverage:.0%} of rows); falling back to a stat model")

        if len(models) != len(target_columns):
            feature_map: Dict[str, List[str]] = {}
            transformer_map: Dict[str, List[Any]] = {}
            for y in [c for c in target_columns if c not in models]:
                input_columns = [c for c in train_columns if c != y]
                features = self._select_features(pairwise_attr_stats, y, input_columns)
                feature_map[y] = features
                transformer_map[y] = self._create_transformers(
                    features, continuous_columns,
                    is_discrete=y not in continuous_columns,
                    num_class=num_class_map[y])
            models = self._build_repair_stat_models(
                models, masked, float_cols, target_columns, continuous_columns,
                num_class_map, feature_map, transformer_map)

        assert len(models) == len(target_columns)

        if any(isinstance(m, FunctionalDepModel) for m, _, _ in models.values()):
            return self._resolve_prediction_order(models, target_columns)
        return list(models.items())

    # -- phase 3: repair -------------------------------------------------------

    @job_phase(name="repairing")
    def _repair(self, models: List[Any], continuous_columns: List[str],
                dirty_rows_df: pd.DataFrame, error_cells_df: pd.DataFrame,
                compute_repair_candidate_prob: bool = False,
                maximal_likelihood_repair: bool = False) -> pd.DataFrame:
        """Batched repair inference: for each model (in dependency order)
        predict the NULL cells of its target column over the whole dirty-row
        block at once. In the PMF modes a discrete target's cells hold
        ``{"classes", "probs"}`` dicts from ``predict_proba`` instead. With
        a provenance ledger active, each cell's top-k posterior is
        recorded; outside the PMF modes that costs one more
        ``predict_proba`` per discrete target."""
        _logger.info(
            f"[Repairing Phase] Computing {len(error_cells_df)} repair updates in "
            f"{len(dirty_rows_df)} rows...")

        integral_columns = {
            c: True for c in dirty_rows_df.columns
            if pd.api.types.is_integer_dtype(dirty_rows_df[c].dtype)}
        need_pmf = compute_repair_candidate_prob or maximal_likelihood_repair
        led = active_ledger()
        pdf = dirty_rows_df.reset_index(drop=True).copy()
        for y, (model, features, transformers) in models:
            missing = pdf[y].isna()
            miss_idx = np.nonzero(missing.to_numpy())[0]
            if len(miss_idx) == 0:
                continue
            miss_rids = pdf[self._row_id].to_numpy()[miss_idx] \
                if led is not None else None
            X: Any = pdf[features].iloc[miss_idx]
            if transformers:
                X = self._encode_features(transformers, X)
            if need_pmf and y not in continuous_columns:
                predicted = model.predict_proba(X)
                classes_str = [str(c) for c in model.classes_.tolist()]
                if led is not None:
                    led.record_posterior(y, miss_rids, classes_str,
                                         np.asarray(predicted,
                                                    dtype=np.float64),
                                         domain_size=len(classes_str))

                def _to_pmf(probs: Any) -> Dict[str, Any]:
                    if probs is None:
                        return {"classes": [], "probs": []}
                    return {"classes": classes_str,
                            "probs": np.asarray(probs, dtype=np.float64)}

                filled = pdf[y].astype(object)
                filled.iloc[miss_idx] = [_to_pmf(p) for p in predicted]
                pdf[y] = filled
                continue
            predicted = np.asarray(model.predict(X))
            if led is not None:
                self._record_prediction(led, y, model, X, miss_rids,
                                        predicted, continuous_columns)
            if y in integral_columns:
                vals = np.round(pd.to_numeric(
                    pd.Series(predicted), errors="coerce").to_numpy())
                filled = pdf[y].astype("float64")
            elif pd.api.types.is_float_dtype(pdf[y].dtype):
                vals = pd.to_numeric(
                    pd.Series(predicted), errors="coerce").to_numpy(dtype=np.float64)
                filled = pdf[y].copy()
            else:
                vals = predicted.astype(object)
                filled = pdf[y].astype(object)
            filled.iloc[miss_idx] = vals
            pdf[y] = filled
        return pdf

    @staticmethod
    def _record_prediction(led: Any, y: str, model: Any, X: Any,
                           row_ids: np.ndarray, predicted: np.ndarray,
                           continuous_columns: List[str]) -> None:
        """The ledger's posterior for the plain prediction path, which
        never calls ``predict_proba``: its top-k comes from one extra call,
        paid only with a ledger active. Regressors and models without
        ``predict_proba`` record a top-1 without probability, as does an
        FD rule model whose posterior has no row for an unknown key."""
        if y in continuous_columns or not hasattr(model, "predict_proba") \
                or not hasattr(model, "classes_"):
            led.record_point_predictions(y, row_ids, predicted)
            return
        try:
            probs = np.asarray(model.predict_proba(X), dtype=np.float64)
        except (TypeError, ValueError):
            led.record_point_predictions(y, row_ids, predicted)
            return
        led.record_posterior(y, row_ids,
                             [str(c) for c in model.classes_.tolist()],
                             probs, domain_size=len(model.classes_))

    def _one_tuple_dc_plan(self, table: EncodedTable,
                           error_cells_df: pd.DataFrame) -> Optional[Dict[str, Any]]:
        """Precomputes what the one-tuple DC minimization needs, once per
        run: the parsed all-constant constraints, their violating rows, the
        flagged cells' current values, and the cells any NON-constraint
        detector also flagged (those repairs are never reverted; the set is
        captured during phase 1, never re-detected). Returns None when
        minimization does not apply: no ConstraintErrorDetector, no
        one-tuple DCs, or user-supplied error cells (ground truth is not
        ours to second-guess)."""
        if self.error_cells is not None:
            return None
        detectors = [d for d in self.error_detectors
                     if isinstance(d, ConstraintErrorDetector)]
        if not detectors:
            return None

        one_tuple = []
        for d in detectors:
            try:
                parsed = d.parsed_constraints(table, str(self.input))
            except Exception:
                continue
            one_tuple += [preds for preds in parsed.predicates
                          if all(isinstance(p.right, Constant) for p in preds)]
        if not one_tuple:
            return None

        frames = self._phase1_non_constraint_frames
        if frames is None:
            _logger.warning(
                "Skipping one-tuple DC minimization (phase-1 detector "
                "capture unavailable)")
            return None
        protected: set = set()
        for f in frames:
            protected |= set(zip(f[ROW_IDX].astype(int), f["attribute"]))

        flagged: Dict[int, Dict[str, Any]] = {}
        for r, a, cur in zip(error_cells_df[ROW_IDX].astype(int),
                             error_cells_df["attribute"],
                             error_cells_df["current_value"]):
            flagged.setdefault(int(r), {})[a] = cur

        plans = []
        for preds in one_tuple:
            viol = np.nonzero(_one_tuple_violations(table, preds))[0]
            if viol.size:
                plans.append((preds, viol))
        if not plans:
            return None
        return {"plans": plans, "flagged": flagged, "protected": protected,
                "kinds": {c.name: c.kind for c in table.columns}}

    def _minimize_one_tuple_dc_repairs(
            self, table: EncodedTable, plan: Optional[Dict[str, Any]],
            pos: np.ndarray, repaired_rows_df: pd.DataFrame,
            models: List[Any]) -> pd.DataFrame:
        """Constraint-aware minimal repair for one-tuple denial constraints.

        A one-tuple DC (all-constant predicates, e.g. Sex=Female &
        Relationship=Husband) flags EVERY referenced attribute of a violating
        row, and the models then repair each flagged cell independently —
        even though changing any ONE of them already satisfies the
        constraint. When several flagged cells of a row would individually
        satisfy the DC, keep only the repair the models are most confident
        in and revert the others to their (non-NULL) current values. Cells
        the constraint still needs, cells with NULL currents, and cells
        another detector flagged keep their repairs; rows where model
        confidence is unavailable for every option are left untouched.
        The reverted (row id, attribute) cells are kept in
        ``_dc_reverted``, their count in ``utils.counters``
        (``repair.dc_reverted``)."""
        if plan is None or not len(repaired_rows_df):
            return repaired_rows_df

        flagged = plan["flagged"]
        protected = plan["protected"]
        kinds = plan["kinds"]
        pos_index = {int(p): i for i, p in enumerate(pos)}

        def spell(attr: str, value: Any) -> Optional[str]:
            """The vocab spelling of a value — what _one_tuple_violations
            compares against the literal (str(int)/str(float) for numeric
            kinds, the raw string otherwise)."""
            if _is_null(value):
                return None
            kind = kinds.get(attr)
            try:
                if kind == KIND_INTEGRAL:
                    return str(int(float(value)))
                if kind == KIND_FRACTIONAL:
                    return str(float(value))
            except (TypeError, ValueError):
                pass
            return str(value)

        def pred_holds(p: Any, attr: str, value: Any) -> bool:
            s = spell(attr, value)
            lit = p.right.literal
            if s is None:
                # NULL <=> const is false; NOT(...) true; orders false
                return p.sign == "IQ"
            if p.sign == "EQ":
                return s == lit
            if p.sign == "IQ":
                return s != lit
            if kinds.get(attr) in (KIND_INTEGRAL, KIND_FRACTIONAL):
                try:
                    lv, rv = float(s), float(lit)
                except ValueError:
                    return False
                return lv < rv if p.sign == "LT" else lv > rv
            return s < lit if p.sign == "LT" else s > lit

        def batch_confidence(attr: str, row_is: List[int]) -> Optional[np.ndarray]:
            """P(model predicts the repaired value) for many rows in one
            predict_proba call; None disables minimization for these rows
            (a failed confidence must not degrade into an arbitrary pick)."""
            for y, (model, features, transformers) in models:
                if y != attr:
                    continue
                try:
                    X: Any = repaired_rows_df[features].iloc[row_is]
                    if transformers:
                        X = self._encode_features(transformers, X)
                    probs = np.asarray(model.predict_proba(X))
                    classes = [str(c) for c in model.classes_.tolist()]
                    vals = [str(repaired_rows_df.at[repaired_rows_df.index[i],
                                                    attr]) for i in row_is]
                    idx = [classes.index(v) if v in classes else -1
                           for v in vals]
                    return np.asarray(
                        [probs[j, k] if k >= 0 else np.nan
                         for j, k in enumerate(idx)], dtype=np.float64)
                except Exception:
                    return None
            return None

        led = active_ledger()

        def _record_keep_all(cands: List[Any]) -> None:
            # the distinct "confidence unavailable -> keep all repairs"
            # outcome, with the sticky reason explaining why no
            # minimization happened
            if led is None:
                return
            for _i, r, _row_flagged, fixable, _options in cands:
                rid = table.row_id_values[r]
                for a in fixable:
                    led.record_decision(
                        rid, a, _prov.DECISION_REPAIRED,
                        _prov.REASON_CONFIDENCE_UNAVAILABLE)

        out = repaired_rows_df
        # (frame position, attr) -> the ORIGINAL model repair, recorded the
        # first time any plan reverts that cell (later plans reverting the
        # same cell see the already-reverted value, which is not a repair) —
        # the post-pass below undoes reverts that overlapping-attribute
        # plans invalidated
        revert_log: Dict[Tuple[int, str], Any] = {}
        for preds, viol_rows in plan["plans"]:
            dc_attrs = [a for p in preds for a in p.references]
            # only this block's rows (the plan's rows are global)
            in_chunk = viol_rows[np.isin(viol_rows, pos)] \
                if len(viol_rows) > len(pos_index) // 4 else \
                [r for r in viol_rows if int(r) in pos_index]
            candidates = []  # (i, row, row_flagged, fixable, options)
            need_conf: Dict[str, List[int]] = {}
            for r in in_chunk:
                i = pos_index.get(int(r))
                if i is None:
                    continue
                row_flagged = flagged.get(int(r), {})
                fixable = [a for a in dc_attrs
                           if a in row_flagged and a in out.columns
                           and (int(r), a) not in protected
                           and not _is_null(row_flagged[a])]
                if len(fixable) < 2:
                    continue
                fixable_set = set(fixable)

                def satisfied_by(only: str) -> bool:
                    # `only` takes its repair, other revertible flagged cells
                    # take their current values; everything else (unflagged
                    # attrs, must-keep repairs) reads the repaired frame
                    def val(a: str) -> Any:
                        if a != only and a in fixable_set:
                            return row_flagged[a]
                        return out.at[out.index[i], a]
                    return not all(pred_holds(p, p.references[0],
                                              val(p.references[0]))
                                   for p in preds)

                options = [a for a in fixable if satisfied_by(a)]
                if len(options) < 1:
                    continue
                candidates.append((i, int(r), row_flagged, fixable, options))
                for a in options:
                    need_conf.setdefault(a, []).append(i)

            conf: Dict[Tuple[str, int], float] = {}
            usable = True
            for a, row_is in need_conf.items():
                scores = batch_confidence(a, row_is)
                if scores is None:
                    usable = False
                    break
                for i, sc in zip(row_is, scores):
                    conf[(a, i)] = float(sc)
            if not usable:
                _record_keep_all(candidates)
                continue

            for i, r, row_flagged, fixable, options in candidates:
                scored = [(conf.get((a, i), np.nan), a) for a in options]
                if any(np.isnan(sc) for sc, _ in scored):
                    _record_keep_all([(i, r, row_flagged, fixable, options)])
                    continue  # confidence unavailable -> keep all repairs
                best = max(scored)[1]
                reverted = []
                for a in fixable:
                    if a != best:
                        revert_log.setdefault(
                            (i, a), out.at[out.index[i], a])
                        out.at[out.index[i], a] = row_flagged[a]
                        reverted.append(a)
                if led is not None and reverted:
                    rid = table.row_id_values[r]
                    for a in reverted:
                        led.record_decision(rid, a, _prov.DECISION_KEPT,
                                            _prov.REASON_DC_MINIMIZED)
                if reverted:
                    _logger.info(
                        "[Repairing Phase] one-tuple DC on row {}: keeping "
                        "the '{}' repair and reverting {} (constraint "
                        "satisfied by a single change)".format(
                            table.row_id_values[r], best,
                            to_list_str(reverted, quote=True)))

        # Plans apply sequentially against the mutated frame, so with two
        # DCs sharing an attribute a later plan's revert can re-violate an
        # earlier constraint. Fixpoint pass: re-evaluate every processed
        # constraint on the FINAL row state; a still-violated constraint
        # gets ALL reverted cells among its referenced attributes restored
        # to their original model repairs. Each (row, cell) restores at most
        # once and restores only move the row toward the all-repairs state,
        # so the loop is monotone and terminates.
        if revert_log:
            touched_rows = {i for i, _ in revert_log}
            for _ in range(len(plan["plans"]) + 1):
                changed = False
                for preds, _ in plan["plans"]:
                    attrs = {a for p in preds for a in p.references}
                    for i in touched_rows:
                        restorable = [a for a in attrs
                                      if (i, a) in revert_log]
                        if not restorable:
                            continue
                        violated = all(
                            pred_holds(p, p.references[0],
                                       out.at[out.index[i],
                                              p.references[0]])
                            for p in preds)
                        if violated:
                            for a in restorable:
                                out.at[out.index[i], a] = \
                                    revert_log.pop((i, a))
                                if led is not None:
                                    # the revert was undone: the extraction
                                    # pass re-derives the cell's decision
                                    led.clear_decision(
                                        table.row_id_values[pos[i]], a)
                            changed = True
                if not changed:
                    break
        self._dc_reverted = {(table.row_id_values[pos[i]], a)
                             for i, a in revert_log}
        counter_inc("repair.dc_reverted", len(revert_log))
        return out

    def _flatten(self, df: pd.DataFrame) -> pd.DataFrame:
        """(row_id, attribute, value) long view (RepairMiscApi.scala:41-49);
        values keep their python objects (PMF dicts pass through). Column-
        vectorized: homogeneous columns convert with pandas ops, only
        mixed/object columns fall back to a per-element pass."""
        cols = [c for c in df.columns if c != self._row_id]
        n = len(df)
        mat = np.empty((n, len(cols)), dtype=object)
        for j, c in enumerate(cols):
            mat[:, j] = _flatten_column(df[c])
        return pd.DataFrame({
            self._row_id: np.repeat(df[self._row_id].to_numpy(dtype=object),
                                    len(cols)),
            "attribute": np.tile(np.array(cols, dtype=object), n),
            "value": mat.reshape(-1),
        }, columns=[self._row_id, "attribute", "value"])

    def _pmf_records_for_attr(self, attr: str, group: pd.DataFrame,
                              weighted: bool, weight: float,
                              threshold: float, top_k: int) -> np.ndarray:
        """Builds the per-cell PMF records of one attribute as matrix ops:
        all cells of an attribute share one model, hence one class list, so
        their probs stack into an (n, k) matrix. Cost weighting batches the
        Levenshtein calls per *unique* current value, normalization and
        top-k run as numpy array ops (replaces the reference's per-row
        Python loops, model.py:1174-1225)."""
        vals = group["value"].to_numpy(dtype=object)
        curs = group["current_value"].to_numpy(dtype=object)
        rids = group[self._row_id].to_numpy(dtype=object)
        n = len(vals)
        records = np.empty(n, dtype=object)

        classes_of = [v.get("classes", []) if isinstance(v, dict) else []
                      for v in vals]
        nonempty = np.array([len(c) > 0 for c in classes_of], dtype=bool)
        for i in np.nonzero(~nonempty)[0]:
            records[i] = {
                self._row_id: rids[i], "attribute": attr,
                "current_value": {"value": curs[i], "prob": 0.0}, "pmf": []}
        ne_idx = np.nonzero(nonempty)[0]
        if len(ne_idx) == 0:
            return records

        classes = classes_of[ne_idx[0]]
        k = len(classes)
        if any(len(classes_of[i]) != k for i in ne_idx):
            # distinct models for one attribute can't happen in this pipeline;
            # defensive split so a future caller still gets correct output
            for sub_k, sub in pd.Series(ne_idx).groupby(
                    [len(classes_of[i]) for i in ne_idx]):
                sub_group = group.iloc[sub.to_numpy()]
                records[sub.to_numpy()] = self._pmf_records_for_attr(
                    attr, sub_group, weighted, weight, threshold, top_k)
            return records

        P = np.stack([np.asarray(vals[i]["probs"], dtype=np.float64)[:k]
                      for i in ne_idx])
        curs_ne = curs[ne_idx]

        if weighted:
            codes, uniques = pd.factorize(pd.Series(curs_ne, dtype=object),
                                          use_na_sentinel=True)
            # one weight row per unique current value (batched Levenshtein),
            # plus a trailing all-ones row that null/falsy currents (code -1)
            # index into — those keep their unweighted probs, like the
            # reference's `costs is None` branch
            W = np.ones((len(uniques) + 1, k), dtype=np.float64)
            for u, cur in enumerate(uniques):
                costs = self.cf.compute_many(cur, classes) \
                    if self.cf is not None else None
                if costs is not None:
                    W[u] = [1.0 / (1.0 + weight * c) if c is not None else 1.0
                            for c in costs]
            P = P * W[codes]
            totals = P.sum(axis=1, keepdims=True)
            np.divide(P, totals, out=P, where=totals > 0)

        class_idx = {}
        for j, c in enumerate(classes):
            class_idx.setdefault(c, j)
        cur_pos = np.array([class_idx.get(c, -1) for c in curs_ne])
        cur_probs = np.where(
            cur_pos >= 0, P[np.arange(len(ne_idx)), np.where(
                cur_pos >= 0, cur_pos, 0)], 0.0)

        kk = min(int(top_k), k)
        order = np.argsort(-P, axis=1, kind="stable")[:, :kk]
        top_probs = np.take_along_axis(P, order, axis=1)
        classes_arr = np.array(classes, dtype=object)
        top_classes = classes_arr[order]
        counts = np.minimum((P > threshold).sum(axis=1), kk)

        for r, i in enumerate(ne_idx):
            records[i] = {
                self._row_id: rids[i], "attribute": attr,
                "current_value": {"value": curs[i],
                                  "prob": float(cur_probs[r])},
                "pmf": [{"class": top_classes[r, j],
                         "prob": float(top_probs[r, j])}
                        for j in range(counts[r])]}
        return records

    def _compute_repair_pmf(self, repaired_rows_df: pd.DataFrame,
                            error_cells_df: pd.DataFrame,
                            continuous_columns: List[str]) -> pd.DataFrame:
        """PMF extraction + cost weighting + top-k filtering
        (reference model.py:1174-1225), vectorized per attribute. Only the
        attributes that carry error cells flatten — the inner join discards
        every other column's cells anyway."""
        error_attrs = set(error_cells_df["attribute"].unique())
        flat = self._flatten(repaired_rows_df[
            [self._row_id]
            + [c for c in repaired_rows_df.columns if c in error_attrs]])
        keys = error_cells_df[[self._row_id, "attribute", "current_value"]]
        joined = flat.merge(keys, on=[self._row_id, "attribute"], how="inner")

        continuous = set(continuous_columns)
        discrete = joined[~joined["attribute"].isin(continuous)] \
            .reset_index(drop=True)

        threshold = float(self._get_option_value(*self._opt_prob_threshold))
        top_k = int(self._get_option_value(*self._opt_prob_top_k))
        weight = float(self._get_option_value(*self._opt_cost_weight))
        cf_targets = set(self.cf.targets) if self.cf is not None else set()
        if self.cf is not None and cf_targets:
            _logger.info(f"[Repairing Phase] {self.cf} computing weighting probs...")

        records = np.empty(len(discrete), dtype=object)
        for attr, group in discrete.groupby("attribute", sort=False):
            weighted = self.cf is not None and \
                (not cf_targets or attr in cf_targets)
            idx = group.index.to_numpy()
            records[idx] = self._pmf_records_for_attr(
                str(attr), group, weighted, weight, threshold, top_k)
        out = list(records)

        if continuous:
            cont = joined[joined["attribute"].isin(continuous)]
            for rid, a, v, cur in zip(
                    cont[self._row_id], cont["attribute"], cont["value"],
                    cont["current_value"]):
                out.append({
                    self._row_id: rid,
                    "attribute": a,
                    "current_value": {"value": cur, "prob": 0.0},
                    "pmf": [{"class": v, "prob": 1.0}],
                })

        pmf_df = pd.DataFrame(
            out, columns=[self._row_id, "attribute", "current_value", "pmf"])
        assert len(pmf_df) == len(error_cells_df)
        led = active_ledger()
        if led is not None and len(pmf_df):
            # the cost-weighted top-k the candidate selection ranks on
            # replaces the raw posterior
            for attr, group in pmf_df.groupby("attribute", sort=False):
                led.record_pmf_topk(str(attr),
                                    group[self._row_id].tolist(),
                                    group["pmf"].tolist())
        return pmf_df

    def _finish_candidate_prob(self, pmf_df: pd.DataFrame,
                               compute_repair_prob: bool) -> pd.DataFrame:
        """Result shaping for the candidate-probability modes (reference
        model.py:1204-1225), shared by the whole-block and the chunked
        at-scale paths."""
        pmf_df = pmf_df.assign(
            current_value=[cv["value"] for cv in pmf_df["current_value"]])
        if compute_repair_prob:
            return pd.DataFrame({
                self._row_id: pmf_df[self._row_id],
                "attribute": pmf_df["attribute"],
                "current_value": pmf_df["current_value"],
                "repaired": [p[0]["class"] if p else None
                             for p in pmf_df["pmf"]],
                "prob": [p[0]["prob"] if p else None for p in pmf_df["pmf"]],
            })
        return pmf_df

    def _compute_score(self, pmf_df: pd.DataFrame) -> pd.DataFrame:
        """Log-likelihood-ratio x cost-discount score (reference
        model.py:1227-1248). Vectorized: cost lookups dedupe to one
        `cf.compute` per unique (base, repaired) pair, the score math runs
        as numpy array ops."""
        assert self.cf is not None
        pmfs = pmf_df["pmf"].tolist()
        curs = pmf_df["current_value"].tolist()
        rep_class = [p[0]["class"] if p else None for p in pmfs]
        rep_prob = np.array([p[0]["prob"] if p else 1e-6 for p in pmfs],
                            dtype=np.float64)
        cur_val = [c["value"] for c in curs]
        cur_prob = np.array([c["prob"] for c in curs], dtype=np.float64)
        base = [cv if cv is not None else rc
                for cv, rc in zip(cur_val, rep_class)]

        pair_cost: Dict[Tuple[Any, Any], Optional[float]] = {}
        costs = np.empty(len(pmfs), dtype=np.float64)
        for i, key in enumerate(zip(base, rep_class)):
            if key not in pair_cost:
                pair_cost[key] = self.cf.compute(*key)
            c = pair_cost[key]
            costs[i] = c if c is not None else 256.0

        cur_prob = np.where(cur_prob > 0.0, cur_prob, 1e-6)
        score = np.log(np.maximum(rep_prob, 1e-300) / cur_prob) / (1.0 + costs)
        return pd.DataFrame({
            self._row_id: pmf_df[self._row_id].to_numpy(),
            "attribute": pmf_df["attribute"].to_numpy(),
            "current_value": np.array(cur_val, dtype=object),
            "repaired": np.array(rep_class, dtype=object),
            "score": score.astype(float),
        }, columns=[self._row_id, "attribute", "current_value", "repaired", "score"])

    def _maximal_likelihood_repair(self, score_df: pd.DataFrame,
                                   error_cells_df: pd.DataFrame) -> pd.DataFrame:
        """Keeps the top `repair_delta` updates by score percentile
        (reference model.py:1259-1277)."""
        assert self.repair_delta is not None
        num_error_cells = len(error_cells_df)
        percent = min(1.0, 1.0 - self.repair_delta / num_error_cells)
        thres = float(np.percentile(score_df["score"].to_numpy(), percent * 100.0)) \
            if len(score_df) else 0.0
        selected = score_df["score"].to_numpy() >= thres
        top = score_df[selected].drop(columns=["score"])
        led = active_ledger()
        if led is not None and len(score_df):
            rids = score_df[self._row_id].to_numpy()
            attrs = score_df["attribute"].to_numpy(dtype=object)
            reps = score_df["repaired"].to_numpy(dtype=object)
            if selected.any():
                led.record_decisions(rids[selected], attrs[selected],
                                     _prov.DECISION_REPAIRED,
                                     _prov.REASON_MAXIMAL_LIKELIHOOD,
                                     repaired=reps[selected])
            if (~selected).any():
                led.record_decisions(rids[~selected], attrs[~selected],
                                     _prov.DECISION_BELOW_THRESHOLD,
                                     _prov.REASON_BELOW_SCORE_THRESHOLD)
        _logger.info(
            "[Repairing Phase] {} repair updates (delta={}) selected among {} "
            "candidates".format(len(top), self.repair_delta, num_error_cells))
        return top.reset_index(drop=True)

    def _continuous_kind_map(self, table: EncodedTable) -> Dict[str, str]:
        return {c.name: c.kind for c in table.columns if c.is_numeric}

    def _repair_attrs(self, repair_updates: Union[str, pd.DataFrame],
                      base_table: Union[str, pd.DataFrame],
                      table: EncodedTable) -> pd.DataFrame:
        updates = repair_updates if type(repair_updates) is pd.DataFrame \
            else self._session.table(str(repair_updates))
        base = base_table if type(base_table) is pd.DataFrame \
            else self._session.table(str(base_table))
        return repair_attrs_from(updates, base, self._row_id,
                                 self._continuous_kind_map(table))

    @job_phase(name="validating")
    def _validate_repairs(self, repair_candidates: pd.DataFrame,
                          repaired_rows: pd.DataFrame,
                          clean_rows: pd.DataFrame,
                          original_rows: Optional[pd.DataFrame] = None
                          ) -> pd.DataFrame:
        """Post-repair constraint validation: the repaired dirty rows
        re-encode together with the clean context, every
        ConstraintErrorDetector's denial constraints re-evaluate over the
        result (the same device scans phase 1 uses), and candidates whose
        repaired cell introduces a violation are dropped — the cell stays
        unrepaired rather than swapping one violation for another.

        With ``original_rows`` (the UNMASKED dirty rows), a candidate is
        dropped only if its cell violates AFTER the repair and did NOT
        already violate BEFORE it."""
        _logger.info("[Validation Phase] Validating {} repair candidates...".format(
            len(repair_candidates)))
        detectors = [d for d in self.error_detectors
                     if isinstance(d, ConstraintErrorDetector)]
        if not detectors or not len(repair_candidates):
            return repair_candidates

        candidate_attrs = sorted(set(repair_candidates["attribute"]))

        def violating_cells(dirty_block: pd.DataFrame) -> Optional[set]:
            full = pd.concat([clean_rows, dirty_block], ignore_index=True)
            try:
                encoded = encode_table(full, self._row_id)
            except Exception as e:  # never fail the run on a validation error
                _logger.warning(
                    f"Repair validation skipped: {e.__class__}: {e}")
                return None
            cells: set = set()
            rid_vals = full[self._row_id].to_numpy()
            for d in detectors:
                try:
                    parsed = d.parsed_constraints(encoded, str(self.input))
                except Exception as e:
                    _logger.warning(
                        f"Repair validation skipped for {d}: {e}")
                    continue
                if parsed.is_empty:
                    continue
                for rows, attr in detect_constraint_violations(
                        encoded, parsed, candidate_attrs):
                    cells.update(
                        (rid, attr) for rid in rid_vals[rows].tolist())
            return cells

        after = violating_cells(repaired_rows)
        if after is None or not after:
            return repair_candidates
        before = violating_cells(original_rows) \
            if original_rows is not None else set()
        violating = after - (before or set())

        if not violating:
            return repair_candidates
        keys = list(zip(repair_candidates[self._row_id].tolist(),
                        repair_candidates["attribute"].tolist()))
        keep = np.array([k not in violating for k in keys])
        dropped = int((~keep).sum())
        if dropped:
            led = active_ledger()
            if led is not None:
                dropped_df = repair_candidates[~keep]
                led.record_decisions(
                    dropped_df[self._row_id].to_numpy(),
                    dropped_df["attribute"].to_numpy(dtype=object),
                    _prov.DECISION_KEPT, _prov.REASON_VALIDATION_VIOLATION)
            _logger.info(
                f"[Validation Phase] Dropped {dropped}/{len(keys)} repairs "
                "that introduce integrity-constraint violations")
        return repair_candidates[keep].reset_index(drop=True)

    def _extract_repair_candidates(self, repaired_rows_df: pd.DataFrame,
                                   error_cells_df: pd.DataFrame,
                                   target_columns: List[str],
                                   row_pos: np.ndarray) -> pd.DataFrame:
        """Result shaping for the candidates path: each error cell's
        repaired value by positional gather, stringified; row-major order;
        kept when `repaired IS NULL OR NOT(current <=> repaired)`."""
        empty = pd.DataFrame(
            columns=[self._row_id, "attribute", "current_value", "repaired"])
        cells_rows = error_cells_df[ROW_IDX].to_numpy().astype(np.int64)
        if not len(row_pos) or not len(cells_rows):
            return empty
        in_chunk = (cells_rows >= row_pos[0]) & (cells_rows <= row_pos[-1])
        if not in_chunk.all():
            error_cells_df = error_cells_df[in_chunk]
            cells_rows = cells_rows[in_chunk]
            if not len(cells_rows):
                return empty
        local = np.searchsorted(row_pos, cells_rows)
        attrs_np = error_cells_df["attribute"].to_numpy(dtype=object)
        curs_np = error_cells_df["current_value"].to_numpy(dtype=object)
        rid_np = error_cells_df[self._row_id].to_numpy(dtype=object)
        attr_codes, attr_uniques = pd.factorize(attrs_np)
        col_rank = {a: i for i, a in enumerate(repaired_rows_df.columns)}
        target_set = set(target_columns)
        repaired = np.empty(len(cells_rows), dtype=object)
        valid = np.zeros(len(cells_rows), dtype=bool)
        for ai, attr in enumerate(attr_uniques):
            if attr not in target_set or attr not in col_rank:
                continue
            m = attr_codes == ai
            repaired[m] = _flatten_column(
                repaired_rows_df[attr].iloc[local[m]])
            valid[m] = True
        keep = valid & np.fromiter(
            (_is_null(r) or not _null_safe_eq(c, r)
             for c, r in zip(curs_np, repaired)),
            dtype=bool, count=len(cells_rows))
        led = active_ledger()
        if led is not None and len(cells_rows):
            # sticky-aware: a reason a more specific pass recorded (DC
            # minimization, rules, the confidence fallback, escalation)
            # survives; the generic outcome fills in everything else
            rep_null = np.fromiter((_is_null(r) for r in repaired),
                                   dtype=bool, count=len(repaired))
            for mask, decision, reason, rep in (
                    (keep & ~rep_null, _prov.DECISION_REPAIRED,
                     _prov.REASON_MODEL_REPAIR, repaired),
                    (keep & rep_null, _prov.DECISION_KEPT,
                     _prov.REASON_NO_PREDICTION, None),
                    (valid & ~keep, _prov.DECISION_KEPT,
                     _prov.REASON_PREDICTION_MATCHES_CURRENT, None),
                    (~valid, _prov.DECISION_KEPT,
                     _prov.REASON_NOT_TARGETED, None)):
                if mask.any():
                    led.record_decisions(
                        rid_np[mask], attrs_np[mask], decision, reason,
                        repaired=rep[mask] if rep is not None else None,
                        sticky_aware=True)
        if not keep.any():
            return empty
        ranks = np.fromiter((col_rank.get(a, 0) for a in attrs_np),
                            dtype=np.int64, count=len(attrs_np))
        order = np.lexsort((ranks[keep], local[keep]))  # row-major
        idx = np.nonzero(keep)[0][order]
        return pd.DataFrame({
            self._row_id: rid_np[idx],
            "attribute": attrs_np[idx],
            "current_value": curs_np[idx],
            "repaired": repaired[idx],
        })

    # -- the run ---------------------------------------------------------------

    def _check_input_table(self) -> Tuple[EncodedTable, str, List[str]]:
        if isinstance(self.input, str):
            # chunk-ingested inputs are already encoded in the catalog: use
            # them directly instead of decoding + re-encoding
            name = self._session.qualified_name(self.db_name, str(self.input))
            entry = self._session.raw_entry(name)
            if isinstance(entry, EncodedTable):
                table, continuous_columns = check_encoded_table(
                    entry, self._row_id, name)
                _logger.info("input_table: {} ({} rows x {} columns)".format(
                    name, table.n_rows, len(table.columns)))
                return table, name, continuous_columns
        df, input_name = self._input_frame
        table, continuous_columns = check_input_table(df, self._row_id, input_name)
        _logger.info("input_table: {} ({} rows x {} columns)".format(
            input_name, table.n_rows, len(table.columns)))
        return table, input_name, continuous_columns

    @staticmethod
    def _count_models(models: List[Any]) -> None:
        """Counts the trained models by kind in ``utils.counters``."""
        for _, (model, _, _) in models:
            if isinstance(model, PoorModel):
                counter_inc("train.poor_models")
            elif isinstance(model, FunctionalDepModel):
                counter_inc("train.fd_rule_models")
            else:
                counter_inc("train.stat_models")
                is_discrete = getattr(model, "is_discrete", None)
                if is_discrete is False:
                    counter_inc("train.regressors")
                elif is_discrete is True:
                    counter_inc("train.classifiers")

    # -- checkpoint/resume -----------------------------------------------------
    #
    # `option("model.checkpoint_path", dir)` saves the trained models after
    # phase 2 and reuses them on a later run whose masked table, targets
    # and options match; `DELPHI_CHECKPOINT_DIR` / `repair.checkpoint.dir`
    # persists each phase's outputs keyed on the input table, so a run that
    # died resumes at its last completed phase. Both fingerprints equal the
    # JAX package's for the same table and options; the pickles hold this
    # package's classes, and tensors on the CPU only.

    def _checkpoint_file(self) -> str:
        path = self._get_option_value(*self._opt_checkpoint_path)
        return os.path.join(path, "repair_models.pkl") if path else ""

    @staticmethod
    def _table_content_sha1(table: EncodedTable) -> str:
        """Content hash of an encoded table: every vocabulary and a crc32 of
        every code column (``DELPHI_CHECKPOINT_SAMPLED_HASH=1``: a stride
        sample of about 65,536 rows instead), as the JAX package hashes."""
        sampled = os.environ.get("DELPHI_CHECKPOINT_SAMPLED_HASH") == "1"
        stride = max(1, table.n_rows // 65536) if sampled else 1
        h = hashlib.sha1()
        h.update(b"sampled" if sampled else b"full")
        h.update(np.int64(table.n_rows).tobytes())
        for c in table.columns:
            h.update(c.name.encode("utf-8", "replace"))
            h.update("\x00".join(str(v) for v in c.vocab).encode(
                "utf-8", "replace"))
            if sampled:
                h.update(np.ascontiguousarray(c.codes[::stride]).tobytes())
                if table.n_rows:
                    h.update(np.ascontiguousarray(c.codes[-1:]).tobytes())
            else:
                crc = zlib.crc32(np.ascontiguousarray(c.codes))
                h.update(np.uint32(crc).tobytes())
        return h.hexdigest()

    def _input_identity(self) -> str:
        return self._session.qualified_name(
            self.db_name,
            self.input if isinstance(self.input, str) else "<dataframe>")

    def _checkpoint_fingerprint(self, masked: EncodedTable,
                                target_columns: List[str]) -> Dict[str, Any]:
        """Identity of a trained-model set: the input's name, shape, schema
        and content, and every option but ``model.checkpoint_path`` (so a
        moved checkpoint directory still validates)."""
        return {
            "version": 4,
            "input": self._input_identity(),
            "targets": sorted(target_columns),
            "columns": [self._row_id] + masked.column_names,
            "n_rows": int(masked.n_rows),
            "content_sha1": self._table_content_sha1(masked),
            "opts": {k: v for k, v in sorted(self.opts.items())
                     if k != self._opt_checkpoint_path.key},
            "discrete_thres": int(self.discrete_thres),
            "repair_by_rules": bool(self.repair_by_rules),
            "rebalancing": bool(self.training_data_rebalancing_enabled),
        }

    def _load_model_checkpoint(self, fingerprint: Dict[str, Any]) \
            -> Optional[List[Any]]:
        # Pickles run code as they load: point `model.checkpoint_path` only
        # at directories this package wrote
        ckpt = self._checkpoint_file()
        if not ckpt:
            return None
        from delphi_tpu_torch.parallel import store as dstore
        payload, status = dstore.read_pickle(
            ckpt, schema="model_ckpt", site="store.model")
        if status == "missing":
            return None
        if status == "corrupt":
            _logger.warning(f"Ignoring corrupt model checkpoint {ckpt}")
            return None
        if not isinstance(payload, dict) or "models" not in payload:
            _logger.warning(
                f"Ignoring model checkpoint {ckpt}: unrecognized format")
            return None
        if payload.get("fingerprint") != fingerprint:
            _logger.warning(
                f"Ignoring stale model checkpoint {ckpt}: "
                "input/targets/options changed since it was written")
            return None
        _logger.info(f"Loaded {len(payload['models'])} repair models from {ckpt}")
        return payload["models"]

    def _save_model_checkpoint(self, models: List[Any],
                               fingerprint: Dict[str, Any]) -> None:
        ckpt = self._checkpoint_file()
        if not ckpt:
            return
        from delphi_tpu_torch.parallel import store as dstore
        try:
            dstore.write_pickle(
                ckpt, {"fingerprint": fingerprint, "models": models},
                schema="model_ckpt", site="store.model")
            _logger.info(f"Saved {len(models)} repair models to {ckpt}")
        except Exception as e:
            _logger.warning(f"Failed to write model checkpoint {ckpt}: {e}")

    def _phase_fingerprint(self, table: EncodedTable,
                           continuous_columns: List[str]) -> Dict[str, Any]:
        """Identity of a run's phase outputs: the input table (name,
        schema, content), the continuous columns and every option and
        setter that shapes them."""
        return {
            "version": 1,
            "input": self._input_identity(),
            "columns": [self._row_id] + table.column_names,
            "n_rows": int(table.n_rows),
            "content_sha1": self._table_content_sha1(table),
            "continuous": sorted(continuous_columns),
            "opts": dict(sorted(self.opts.items())),
            "targets": sorted(self.cf.targets) if self.cf is not None else [],
            "discrete_thres": int(self.discrete_thres),
            "repair_by_rules": bool(self.repair_by_rules),
            "rebalancing": bool(self.training_data_rebalancing_enabled),
        }

    def _phase_checkpoint_store(
            self, table: EncodedTable, continuous_columns: List[str]
    ) -> Optional[_resilience.PhaseCheckpointStore]:
        directory = _resilience.checkpoint_dir()
        if not directory:
            return None
        try:
            fp = self._phase_fingerprint(table, continuous_columns)
        except Exception as e:  # checkpointing never fails the run
            _logger.warning(f"phase checkpointing disabled: {e}")
            return None
        return _resilience.PhaseCheckpointStore(directory, fp)

    @staticmethod
    def _models_on_device(models: List[Any]) -> List[Any]:
        """Loaded models with their tensors on the run's device (the
        checkpoint holds them on the CPU)."""
        from delphi_tpu_torch.device import get_device
        from delphi_tpu_torch.incremental.executor import models_to
        moved = models_to(dict(models), get_device())
        return [(y, moved[y]) for y, _ in models]

    @elapsed_time  # type: ignore
    def _run(self, table: EncodedTable, input_name: str,
             continuous_columns: List[str], detect_errors_only: bool,
             compute_repair_candidate_prob: bool, compute_repair_prob: bool,
             compute_repair_score: bool, repair_data: bool,
             maximal_likelihood_repair: bool) -> pd.DataFrame:
        phase_store = self._phase_checkpoint_store(table, continuous_columns)

        #######################################################################
        # 1. Error Detection Phase
        #######################################################################
        detect_ckpt = phase_store.load("detect") if phase_store else None
        if detect_ckpt is not None:
            error_cells_df, target_columns, pairwise_attr_stats, \
                domain_stats = detect_ckpt
        else:
            _logger.info(
                f"[Error Detection Phase] Detecting errors in a table "
                f"`{input_name}`... ")
            error_cells_df, target_columns, pairwise_attr_stats, \
                domain_stats = self._detect_errors(
                    table, input_name, continuous_columns)
            if phase_store:
                phase_store.save("detect", (error_cells_df, target_columns,
                                            pairwise_attr_stats, domain_stats))
        # an abort lands between phases: the completed phase's checkpoint
        # is already on disk
        _resilience.maybe_abort()

        if detect_errors_only:
            return error_cells_df.drop(columns=[ROW_IDX], errors="ignore")

        if len(error_cells_df) == 0:
            _logger.info("Any error cell not found, so the input data is already clean")
            if repair_data:
                return table.to_pandas()
            return pd.DataFrame(
                columns=[self._row_id, "attribute", "current_value"])

        if len(target_columns) == 0:
            raise ValueError(
                "At least one valid discretizable feature is needed to repair error "
                "cells, but no such feature found")

        error_cells_df = self._filter_columns_from(error_cells_df, target_columns)

        #######################################################################
        # 2. Repair Model Training Phase
        #######################################################################
        masked = table.with_nulls_at_arrays(
            error_cells_df[ROW_IDX].to_numpy().astype(np.int64),
            error_cells_df["attribute"].to_numpy(dtype=object))
        # dtype snapshot: an integral column that carries NULLs after masking
        # decodes to float64 in every downstream frame, even if rule repairs
        # later fill all of its NULLs
        float_cols = tuple(
            c.name for c in masked.columns
            if c.kind == KIND_INTEGRAL and c.numeric is not None
            and bool(np.isnan(c.numeric).any()))

        repaired_by_rules_df = None
        if self.repair_by_rules:
            integral_columns = {
                c.name for c in table.columns if c.kind == KIND_INTEGRAL}
            error_cells_df, repaired_by_rules_df = self._repair_by_rules(
                masked, error_cells_df, target_columns, integral_columns)
            if len(repaired_by_rules_df):
                masked = masked.with_updates(list(zip(
                    repaired_by_rules_df[ROW_IDX].astype(int),
                    repaired_by_rules_df["attribute"],
                    repaired_by_rules_df["repaired"])))

        error_row_pos = np.unique(
            error_cells_df[ROW_IDX].to_numpy().astype(np.int64))

        fingerprint = self._checkpoint_fingerprint(masked, target_columns) \
            if self._checkpoint_file() else {}
        # resume layering: the phase store (keyed on the input table), then
        # the model checkpoint (keyed on the masked table), then training
        models = phase_store.load("train") if phase_store else None
        if models is None:
            models = self._load_model_checkpoint(fingerprint) \
                if fingerprint else None
            if models is None:
                models = self._build_repair_models(
                    masked, float_cols, target_columns, continuous_columns,
                    domain_stats, pairwise_attr_stats)
                if fingerprint:
                    self._save_model_checkpoint(models, fingerprint)
            else:
                counter_inc("train.checkpoint_hits")
                models = self._models_on_device(models)
            if phase_store:
                phase_store.save("train", models)
        else:
            models = self._models_on_device(models)
        # the incremental executor snapshots the trained models after the
        # run, so a later delta run can freeze undrifted attributes
        self._last_models = models
        _resilience.maybe_abort()
        self._count_models(models)

        #######################################################################
        # 3. Repair Phase
        #######################################################################
        need_pmf = compute_repair_candidate_prob or maximal_likelihood_repair
        dc_plan = self._one_tuple_dc_plan(table, error_cells_df) \
            if not need_pmf else None
        chunk_rows = int(os.environ.get("DELPHI_REPAIR_CHUNK_ROWS", "2000000"))
        chunked = 0 < chunk_rows < len(error_row_pos)
        # escalation applies only to the direct-repair paths: the PMF and
        # maximal-likelihood modes return distributions, not decisions
        escalate_requested = not need_pmf and _escalate.escalation_requested(self)
        ecf_rows = error_cells_df[ROW_IDX].to_numpy().astype(np.int64)

        def chunks() -> Any:
            """(row positions, their error cells, decoded dirty rows) of
            each block of ``chunk_rows`` dirty rows: error_row_pos is
            sorted-unique, so a block's cells are the cells in its row
            range."""
            for start in range(0, len(error_row_pos), chunk_rows):
                counter_inc("repair.chunks")
                pos = error_row_pos[start:start + chunk_rows]
                cells = error_cells_df[(ecf_rows >= pos[0]) & (ecf_rows <= pos[-1])]
                yield pos, cells, masked.to_pandas(
                    rows=pos, integral_as_float=float_cols)

        if need_pmf and not repair_data and chunked:
            # the dirty block, its repairs and the flattened PMF frames exist
            # per chunk; the PMF records and scores are error-cell-sized, and
            # the maximal-likelihood percentile runs once over all scores
            parts = []
            for pos, cells_chunk, dirty_chunk in chunks():
                repaired_chunk = self._repair(
                    models, continuous_columns, dirty_chunk, cells_chunk,
                    compute_repair_candidate_prob, maximal_likelihood_repair)
                if maximal_likelihood_repair:
                    parts.append(self._compute_score(self._compute_repair_pmf(
                        repaired_chunk, cells_chunk, [])))
                else:
                    parts.append(self._compute_repair_pmf(
                        repaired_chunk, cells_chunk, continuous_columns))
            if maximal_likelihood_repair:
                score_df = pd.concat(parts, ignore_index=True)
                if compute_repair_score:
                    return score_df
                return self._maximal_likelihood_repair(score_df, error_cells_df)
            return self._finish_candidate_prob(
                pd.concat(parts, ignore_index=True), compute_repair_prob)

        if not (need_pmf or repair_data or self.repair_validation_enabled
                or self.repair_by_rules or escalate_requested) and chunked:
            # candidates only: decode, repair, minimize and extract per chunk,
            # so no whole dirty block materializes; row-major per chunk and
            # ascending chunks give the one-shot path's global row order
            parts = []
            for pos, cells_chunk, dirty_chunk in chunks():
                repaired_chunk = self._repair(
                    models, continuous_columns, dirty_chunk, cells_chunk)
                repaired_chunk = self._minimize_one_tuple_dc_repairs(
                    table, dc_plan, pos, repaired_chunk, models)
                parts.append(self._extract_repair_candidates(
                    repaired_chunk, cells_chunk, target_columns, pos))
            return pd.concat(parts, ignore_index=True)

        counter_inc("repair.chunks")
        dirty_rows_df = masked.to_pandas(
            rows=error_row_pos, integral_as_float=float_cols)
        repaired_rows_df = self._repair(
            models, continuous_columns, dirty_rows_df, error_cells_df,
            compute_repair_candidate_prob, maximal_likelihood_repair)
        repaired_rows_df = self._minimize_one_tuple_dc_repairs(
            table, dc_plan, error_row_pos, repaired_rows_df, models)

        if escalate_requested:
            # after DC minimization, before the result frames are shaped:
            # the escalated values flow into the repaired table and the
            # candidate extraction alike
            with phase_span("escalation"):
                self._last_escalation = _escalate.maybe_escalate(
                    self, masked, error_cells_df, error_row_pos,
                    repaired_rows_df, target_columns, continuous_columns)

        if compute_repair_candidate_prob and not maximal_likelihood_repair:
            pmf_df = self._compute_repair_pmf(
                repaired_rows_df, error_cells_df, continuous_columns)
            return self._finish_candidate_prob(pmf_df, compute_repair_prob)

        if maximal_likelihood_repair:
            score_df = self._compute_score(self._compute_repair_pmf(
                repaired_rows_df, error_cells_df, []))
            if compute_repair_score:
                return score_df
            top_delta_repairs_df = self._maximal_likelihood_repair(
                score_df, error_cells_df)
            if not repair_data:
                return top_delta_repairs_df
            repaired_rows_df = repair_attrs_from(
                top_delta_repairs_df, dirty_rows_df, self._row_id,
                {c.name: c.kind for c in table.columns if c.is_numeric})

        if repair_data:
            clean_pos = np.setdiff1d(
                np.arange(table.n_rows, dtype=np.int64), error_row_pos,
                assume_unique=True)
            clean_rows_df = masked.to_pandas(
                rows=clean_pos, integral_as_float=float_cols)
            clean_df = pd.concat([clean_rows_df, repaired_rows_df], ignore_index=True)
            assert len(clean_df) == table.n_rows
            return clean_df

        repair_candidates_df = self._extract_repair_candidates(
            repaired_rows_df, error_cells_df, target_columns, error_row_pos)
        if repaired_by_rules_df is not None and len(repaired_by_rules_df):
            # rule repairs go after the model repairs
            repair_candidates_df = pd.concat(
                [repair_candidates_df, repaired_by_rules_df[
                    [self._row_id, "attribute", "current_value", "repaired"]]],
                ignore_index=True)
        if self.repair_validation_enabled:
            clean_pos = np.setdiff1d(
                np.arange(table.n_rows, dtype=np.int64), error_row_pos,
                assume_unique=True)
            clean_rows_df = masked.to_pandas(
                rows=clean_pos, integral_as_float=float_cols)
            # the UNMASKED dirty rows: the before-frame of the validation
            # diff, so a cell that already violated pre-repair can't get a
            # correct repair dropped for a violation it didn't introduce
            original_rows_df = table.to_pandas(
                rows=error_row_pos, integral_as_float=float_cols)
            repair_candidates_df = self._validate_repairs(
                repair_candidates_df, repaired_rows_df, clean_rows_df,
                original_rows_df)
        return repair_candidates_df

    def run(self, detect_errors_only: bool = False,
            compute_repair_candidate_prob: bool = False,
            compute_repair_prob: bool = False, compute_repair_score: bool = False,
            repair_data: bool = False,
            maximal_likelihood_repair: bool = False) -> pd.DataFrame:
        """Runs the pipeline on the port's device (``cuda`` unless the CPU
        was asked for). Returns the repair candidates ``[row_id, attribute,
        current_value, repaired]``, the detected error cells with
        ``detect_errors_only``, the repaired table with ``repair_data``,
        each error cell's top-k candidate PMF with
        ``compute_repair_candidate_prob``, its most likely repair and
        probability with ``compute_repair_prob``, scored repairs with
        ``compute_repair_score``, or the ``setRepairDelta`` best-scoring
        repairs with ``maximal_likelihood_repair``.

        ``DELPHI_PROVENANCE_PATH`` (or ``repair.provenance.path``) records a
        per-cell provenance ledger — detectors, domain size, top-k
        posterior, final decision — written as JSONL when the run ends,
        whether it succeeds or fails (``:memory:`` keeps it in-process).
        ``repair.escalate`` (option, ``DELPHI_ESCALATE`` or session conf)
        re-repairs the cells the models are unsure about through the
        escalation tiers; the pass's summary is kept in
        ``_last_escalation``. ``repair.incremental`` (option,
        ``DELPHI_INCREMENTAL`` or session conf) with a snapshot directory
        (``repair.snapshot.dir``, ``DELPHI_SNAPSHOT_DIR``) repairs only the
        rows that changed since the snapshot and updates it; the delta's
        summary is kept in ``_last_incremental``."""
        if self.input is None or self.row_id is None:
            raise ValueError("`setInput` and `setRowId` should be called before repairing")

        if maximal_likelihood_repair and self.repair_delta is None:
            raise ValueError(
                "`setRepairDelta` should be called when enabling "
                "maximal likelihood repairing")
        if maximal_likelihood_repair and self.cf is None:
            raise ValueError(
                "`setUpdateCostFunction` should be called when enabling "
                "maximal likelihood repairing")
        if maximal_likelihood_repair and len(self.cf.targets) > 0:  # type: ignore
            raise ValueError(
                "`UpdateCostFunction.targets` cannot be used when enabling "
                "maximal likelihood repairing")

        exclusive_params = [
            ("detect_errors_only", detect_errors_only),
            ("compute_repair_candidate_prob", compute_repair_candidate_prob),
            ("compute_repair_prob", compute_repair_prob),
            ("compute_repair_score", compute_repair_score),
            ("repair_data", repair_data),
        ]
        selected = [name for name, value in exclusive_params if value]
        if len(selected) > 1:
            raise ValueError("{} cannot be set to true simultaneously".format(
                to_list_str(selected, sep="/", quote=True)))

        if self._repair_by_nearest_values_enabled and \
                (maximal_likelihood_repair or compute_repair_candidate_prob or
                 compute_repair_prob or compute_repair_score):
            raise ValueError(
                "Cannot repair data by nearest values when enabling "
                "`maximal_likelihood_repair`, `compute_repair_candidate_prob`, "
                "`compute_repair_prob`, or `compute_repair_score`")

        if compute_repair_prob or compute_repair_score:
            compute_repair_candidate_prob = True
        if compute_repair_score:
            maximal_likelihood_repair = True
        self._reject_unported()
        # a run starts with clear latches: an earlier run's abort or CPU
        # rung must not leak in (a request scope keeps its own)
        if _resilience.current_scope() is None:
            _resilience.clear_abort()
            _resilience.clear_cpu_fallback()

        holder = _prov.maybe_start()
        # the escalation router reads the live ledger: a run that escalates
        # without a configured ledger routes through an in-memory one of
        # its own, written nowhere
        esc_scope: Any = contextlib.nullcontext()
        if not detect_errors_only and _escalate.escalation_requested(self) \
                and _prov.active_ledger() is None \
                and not _prov.provenance_configured():
            esc_scope = _prov.scoped_ledger(
                _prov.ProvenanceLedger(_prov.MEMORY_PATH))
        try:
            with esc_scope:
                return self._run_validated(
                    detect_errors_only, compute_repair_candidate_prob,
                    compute_repair_prob, compute_repair_score, repair_data,
                    maximal_likelihood_repair)
        finally:
            _prov.finalize(holder)

    def _run_validated(self, detect_errors_only: bool,
                       compute_repair_candidate_prob: bool,
                       compute_repair_prob: bool, compute_repair_score: bool,
                       repair_data: bool,
                       maximal_likelihood_repair: bool) -> pd.DataFrame:
        with phase_span("input validation"):
            table, input_name, continuous_columns = self._check_input_table()

            if maximal_likelihood_repair and len(continuous_columns) != 0:
                raise ValueError(
                    "Cannot enable the maximal likelihood repair mode "
                    "when continous attributes found")

            if self.targets and \
                    len(set(self.targets) & set(table.column_names)) == 0:
                raise ValueError(
                    f"Target attributes not found in {input_name}: "
                    f"{to_list_str(self.targets)}")

        # launch plans persist per table fingerprint when a plan store is
        # armed (DELPHI_PLAN_DIR) and no fingerprint scope is open; a
        # collision is harmless (the signature re-validates the pieces)
        plan_scope: Any = contextlib.nullcontext()
        if planner.current_fingerprint() is None \
                and planner.get_plan_store() is not None:
            plan_scope = planner.plan_fingerprint(
                planner.table_plan_fingerprint(
                    input_name, table.n_rows,
                    [c.name for c in table.columns]))
        run_flags = (detect_errors_only, compute_repair_candidate_prob,
                     compute_repair_prob, compute_repair_score, repair_data,
                     maximal_likelihood_repair)
        self._last_incremental = None
        with plan_scope:
            # the prewarm thread loads the kernel library while detection
            # runs; it stops when the run ends
            prewarm = compile_plane.maybe_start_prewarm(
                table, continuous_columns, self._row_id, self.targets,
                int(self._get_option_value(
                    *self._opt_max_training_row_num)),
                self.opts)
            try:
                if _incremental.incremental_requested(self):
                    df, elapsed, self._last_incremental = \
                        _incremental.run_incremental(
                            self, table, input_name, continuous_columns,
                            run_flags)
                else:
                    df, elapsed = self._run(table, input_name,
                                            continuous_columns, *run_flags)
            finally:
                if prewarm is not None:
                    prewarm.stop()
        _logger.info(f"!!!Total Processing time is {elapsed}(s)!!!")
        return df


def _flatten_value(v: Any) -> Any:
    if v is not None and not isinstance(v, dict) and pd.isna(v):
        return None
    elif isinstance(v, (bool, np.bool_)):
        return str(int(v))
    elif isinstance(v, (int, np.integer)):
        return str(int(v))
    elif isinstance(v, (float, np.floating)):
        return str(float(v))
    elif not isinstance(v, dict) and v is not None:
        return str(v)
    return v


def _flatten_column(s: pd.Series) -> np.ndarray:
    """Stringifies one column without per-row Python work where the dtype
    allows (str(int)/str(float) formatting preserved)."""
    if pd.api.types.is_bool_dtype(s.dtype):
        return s.astype("int64").astype(str).to_numpy(dtype=object)
    if pd.api.types.is_integer_dtype(s.dtype) or pd.api.types.is_float_dtype(s.dtype):
        na = s.isna().to_numpy()
        out = s.astype(str).to_numpy(dtype=object)
        out[na] = None
        return out
    if s.dtype == object:
        inferred = pd.api.types.infer_dtype(s, skipna=True)
        if inferred in ("string", "empty"):
            arr = s.to_numpy(dtype=object).copy()
            arr[s.isna().to_numpy()] = None
            return arr
        arr = s.to_numpy(dtype=object)
        return np.array([_flatten_value(v) for v in arr], dtype=object)
    na = s.isna().to_numpy()
    out = s.astype(str).to_numpy(dtype=object)
    out[na] = None
    return out


def _is_null(v: Any) -> bool:
    return v is None or (not isinstance(v, (list, dict)) and pd.isna(v))


def _null_safe_eq(a: Any, b: Any) -> bool:
    a_null = _is_null(a)
    b_null = _is_null(b)
    if a_null or b_null:
        return a_null and b_null
    return str(a) == str(b)
