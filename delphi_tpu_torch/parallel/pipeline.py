"""Bounded producer/consumer pipelining of the training phase's host
preparation and device work.

The port of the JAX package's ``parallel/pipeline.py``. Training alternates
host featurization (pandas and numpy: decode the training sample,
fit-encode features, bin the folds) with device launches (CV chunks,
boosting chunks). Run in sequence, the card idles during every prepare and
the host during every launch; :func:`run_pipelined` overlaps them with ONE
background prepare thread feeding a bounded queue while the calling thread
consumes in order.

Determinism contract (frames are bit-identical with the pipeline on and
off):

- ``prepare`` runs in item order on the single producer thread;
- ``consume`` runs in item order on the CALLING thread, so device dispatch
  order, logging order and model-side effects are the sequential loop's;
- an exception from ``prepare(k)`` or ``consume(k)`` surfaces at the same
  item index it would have in the sequential loop; results prepared ahead
  of a failure are discarded, never consumed.

``prepare`` must be host-only (no upload, no guarded launch, no CUDA call:
the producer never touches the card) and must not depend on side effects
of later ``consume`` calls.

The disabled path is a plain sequential loop: no queue, no thread. The
toggle is ``DELPHI_PIPELINE`` (1/0), then the ``repair.pipeline.enabled``
session conf, then auto: on when the run's device is ``cuda`` (the JAX
package's "not the CPU backend"), where producer and consumer do not fight
for the same cores.
"""

import os
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from delphi_tpu_torch.utils import counter_inc, histogram_observe

_TRUTHY = ("1", "true", "on", "yes")
_FALSY = ("0", "false", "off", "no")

# How many items the producer may run ahead of the consumer. 2 is enough to
# hide one prepare behind one launch; more only grows peak host memory
# (each queued slot holds a full prepared training set).
_DEFAULT_DEPTH = 2


def _flag_state() -> Optional[bool]:
    """Tri-state toggle: True/False when forced, None for auto.
    ``DELPHI_PIPELINE`` beats the ``repair.pipeline.enabled`` session
    conf; a value that is neither true nor false means auto."""
    raw = os.environ.get("DELPHI_PIPELINE")
    if raw is None:
        from delphi_tpu_torch.session import get_session
        raw = get_session().conf.get("repair.pipeline.enabled")
    if raw is None:
        return None
    v = str(raw).strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    return None


def enabled() -> bool:
    """Whether the prepare/launch overlap is on (see the module
    docstring)."""
    state = _flag_state()
    if state is not None:
        return state
    from delphi_tpu_torch.device import get_device
    return get_device().type == "cuda"


def run_pipelined(items: Sequence[Any],
                  prepare: Callable[[Any], Any],
                  consume: Callable[[Any, Any], Any],
                  depth: int = _DEFAULT_DEPTH) -> List[Any]:
    """Runs ``consume(item, prepare(item))`` over ``items``, overlapping
    ``prepare`` of the next items with ``consume`` of the current one.
    Returns the ``consume`` results in item order."""
    from delphi_tpu_torch.parallel.resilience import maybe_abort

    items = list(items)
    if len(items) <= 1 or not enabled():
        # the sequential loop IS the disabled path: no thread, no queue
        out = []
        for it in items:
            maybe_abort()
            out.append(consume(it, prepare(it)))
        return out

    counter_inc("pipeline.runs")
    counter_inc("pipeline.items", len(items))
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))

    def _producer() -> None:
        for idx, it in enumerate(items):
            if stop.is_set():
                return
            try:
                prep = prepare(it)
            except BaseException as e:
                # delivered (and re-raised) at idx, as in the sequential
                # loop; nothing past a failed prepare runs
                q.put((idx, None, e))
                return
            q.put((idx, prep, None))

    producer = threading.Thread(target=_producer, daemon=True,
                                name="delphi-pipeline-prepare")
    producer.start()
    results: List[Any] = []
    try:
        for _ in range(len(items)):
            # stop dispatching queued work as soon as an abort is armed
            # (items prepared ahead are discarded)
            maybe_abort()
            t0 = time.perf_counter()
            idx, prep, err = q.get()
            histogram_observe("pipeline.consumer_wait_seconds",
                              time.perf_counter() - t0)
            if err is not None:
                raise err
            results.append(consume(items[idx], prep))
        return results
    finally:
        stop.set()
        # unblock a producer parked on a full queue, then wait for it to
        # exit so no prepare thread outlives its call
        while producer.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=0.05)
