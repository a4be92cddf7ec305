"""Shared host utilities: logging, option parsing, runtime argument type
checks, timing. A copy of the reference package's helpers (minus the
profiler hooks, which were XLA-specific), so the port imports nothing of
the JAX package."""

import functools
import inspect
import logging
import os
import threading
import time
import typing
from typing import Any, Dict, List, Optional

_LOGGER_NAME = "delphi_tpu_torch"


def setup_logger() -> logging.Logger:
    """Returns the library logger. Only a ``NullHandler`` is attached by
    default; ``DELPHI_LOG_LEVEL`` (e.g. ``INFO``) installs one timestamped
    stderr handler at that level."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(logging.INFO)
    level_name = os.environ.get("DELPHI_LOG_LEVEL")
    if level_name:
        level = logging.getLevelName(level_name.strip().upper())
        if isinstance(level, int):
            logger.setLevel(level)
        else:
            logger.warning(f"Unknown DELPHI_LOG_LEVEL: {level_name}")
        if not any(getattr(h, "_delphi_stderr", False)
                   for h in logger.handlers):
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            handler._delphi_stderr = True  # type: ignore[attr-defined]
            logger.addHandler(handler)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


_logger = setup_logger()


def to_list_str(d: List[Any], sep: str = ",", quote: bool = False) -> str:
    return sep.join(f"'{e}'" if quote else str(e) for e in d)


def is_testing() -> bool:
    return os.environ.get("DELPHI_TESTING") is not None \
        or os.environ.get("SPARK_TESTING") is not None


def get_option_value(opts: Dict[str, str], key: str, default_value: Any,
                     type_class: Any = str, validator: Optional[Any] = None,
                     err_msg: Optional[str] = None) -> Any:
    """Typed lookup of a string-keyed expert option with validation: a bad
    value raises under testing and falls back to the default (with a
    warning) otherwise."""
    assert type(default_value) is type_class, f"key={key}"

    if key not in opts:
        return default_value

    raw = opts[key]
    try:
        if type_class is bool and isinstance(raw, str):
            # Python truthiness of the raw string, as in the reference
            value = bool(raw)
        else:
            value = type_class(raw)
    except Exception:
        msg = f'Failed to cast "{raw}" into {type_class.__name__} data: key={key}'
        if is_testing():
            raise ValueError(msg)
        _logger.warning(msg)
        return default_value

    if validator and not validator(value):
        msg = f"{str(err_msg).format(key)}, got {value}"
        if is_testing():
            raise ValueError(msg)
        _logger.warning(msg)
        return default_value

    return value


def _pretty_type_name(t: Any) -> str:
    origin = getattr(t, "__origin__", None)
    if origin is list:
        return f"list[{_pretty_type_name(t.__args__[0])}]"
    if origin is dict:
        kt, vt = t.__args__
        return f"dict[{_pretty_type_name(kt)},{_pretty_type_name(vt)}]"
    return getattr(t, "__name__", str(t))


def _type_matches(v: Any, annot: Any) -> bool:
    origin = getattr(annot, "__origin__", None)
    if origin is list:
        return isinstance(v, list) and all(_type_matches(x, annot.__args__[0]) for x in v)
    if origin is dict:
        kt, vt = annot.__args__
        return isinstance(v, dict) \
            and all(_type_matches(k, kt) for k in v.keys()) \
            and all(_type_matches(x, vt) for x in v.values())
    if origin is typing.Union:
        return any(_type_matches(v, t) for t in annot.__args__)
    try:
        return type(v) is annot or isinstance(v, annot)
    except TypeError:
        return False


def argtype_check(f):  # type: ignore
    """Runtime type checking of public API arguments based on annotations;
    raises ``TypeError`` with a '`arg` should be provided as T, got U'
    message."""

    @functools.wraps(f)
    def wrapper(self, *args, **kwargs):  # type: ignore
        sig = inspect.signature(f)
        for name, value in sig.bind(self, *args, **kwargs).arguments.items():
            annot = sig.parameters[name].annotation
            if annot is inspect.Signature.empty or name == "self":
                continue
            if not _type_matches(value, annot):
                origin = getattr(annot, "__origin__", None)
                if origin is typing.Union:
                    req = "/".join(_pretty_type_name(t) for t in annot.__args__)
                else:
                    req = _pretty_type_name(annot)
                raise TypeError(
                    f"`{name}` should be provided as {req}, got {type(value).__name__}")
        return f(self, *args, **kwargs)

    return wrapper


def elapsed_time(f):  # type: ignore
    """Wraps a function so it returns ``(result, wall_seconds)``."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):  # type: ignore
        start = time.perf_counter()
        ret = f(*args, **kwargs)
        return ret, time.perf_counter() - start

    return wrapper


def log_based_on_level(msg: Any) -> None:
    """Routes a message at the level named by the ``repair.logLevel``
    session config key (TRACE, i.e. DEBUG, by default). ``msg`` may be a
    zero-arg callable, only invoked when the level is enabled."""
    from delphi_tpu_torch.session import get_session

    level_name = get_session().conf.get("repair.logLevel", "TRACE").upper()
    level = {"ERROR": logging.ERROR, "WARN": logging.WARNING,
             "INFO": logging.INFO, "DEBUG": logging.DEBUG,
             "TRACE": logging.DEBUG}.get(level_name, logging.DEBUG)
    if not _logger.isEnabledFor(level):
        return
    _logger.log(level, msg() if callable(msg) else msg)


# Wall seconds of every phase_span closed in this process, keyed by phase
# name (summed over repeats). Callers that report per-phase walls (the chip
# smoke test) clear it before a run and read it after.
phase_walls: Dict[str, float] = {}

# Event counts of this process by name (batched training launches, fallbacks);
# read and cleared the same way.
counters: Dict[str, int] = {}

# One record per repair model the latest run trained (target, model, CV
# choice and seconds; see ``train.py``), appended by ``model.py``, which
# clears it when phase 2 starts.
train_reports: List[Dict[str, Any]] = []


# Last values of this process's gauges by name (the store's root size, the
# streams' lag), set where the JAX package sets its gauges.
gauges: Dict[str, float] = {}


# Every value observed per histogram name (the resilience plane's backoff
# delays); read and cleared like the counters.
histograms: Dict[str, List[float]] = {}


# the pipeline's producer and the prewarm worker count from their own
# threads: a read-modify-write of a shared dict needs the lock
_metrics_lock = threading.Lock()


def counter_inc(name: str, n: int = 1) -> None:
    with _metrics_lock:
        counters[name] = counters.get(name, 0) + n


def histogram_observe(name: str, value: float) -> None:
    with _metrics_lock:
        histograms.setdefault(name, []).append(float(value))


def gauge_set(name: str, value: float) -> None:
    gauges[name] = value


_spans = threading.local()


def current_phase() -> Optional["phase_span"]:
    """The innermost :class:`phase_span` open on this thread, or None
    outside every phase (the resilience plane scopes its CPU latch by
    it)."""
    stack = getattr(_spans, "stack", None)
    return stack[-1] if stack else None


class phase_span:
    """Phase-scoped timing span: logs the phase's wall time and adds it to
    :data:`phase_walls`. When the port's device is a card, the span
    synchronises it on exit so the wall covers the phase's device work.
    ``open`` is True from entry to exit."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.open = False
        self._t0 = 0.0

    def __enter__(self) -> "phase_span":
        stack = getattr(_spans, "stack", None)
        if stack is None:
            stack = _spans.stack = []
        stack.append(self)
        self.open = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.open = False
        stack = _spans.stack
        if self in stack:
            # pop through any span an exception left open below this one
            while stack.pop() is not self:
                pass
        import torch
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - self._t0
        phase_walls[self.name] = phase_walls.get(self.name, 0.0) + elapsed
        _logger.info(f"Elapsed time (name: {self.name}) is {elapsed}(s)")


def job_phase(name: str):  # type: ignore
    def decorator(f):  # type: ignore
        @functools.wraps(f)
        def wrapper(self, *args, **kwargs):  # type: ignore
            with phase_span(name):
                return f(self, *args, **kwargs)
        return wrapper
    return decorator
