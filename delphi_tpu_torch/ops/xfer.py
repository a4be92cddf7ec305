"""Host→device seam: each encoded column's int32 codes upload once and stay
cached as a tensor on the port's device.

The cache lives on the column OBJECT. Table copies replace changed columns
with fresh objects (``dataclasses.replace`` copies declared fields only) and
keep unchanged ones, so invalidation is object identity: a masked column can
never serve a stale device buffer, and an untouched column keeps its buffer
across every phase.

Every upload runs behind the resilience plane's guarded seam (site
``xfer.upload``, :func:`delphi_tpu_torch.parallel.resilience.run_guarded`).

Every upload also enters the transfer ledger under the JAX package's names
(its ``ops/xfer.py``): ``transfer.calls`` and ``transfer.bytes`` (the
bytes of the uploaded array in its device dtype), and
``transfer.phase.<phase>.calls|bytes`` under the active run recorder's
current span; a tensor already on the device (:func:`to_device`) or a
cached column (:func:`device_codes`) counts ``transfer.reuses`` instead,
and dropped column buffers ``transfer.evictions``. The port has no
content-addressed layer, so it never counts ``transfer.content_hits``.
"""

import os
import re
from typing import Any

import numpy as np
import torch

from delphi_tpu_torch.device import get_device
from delphi_tpu_torch.observability.spans import current_recorder
from delphi_tpu_torch.parallel.resilience import run_guarded
from delphi_tpu_torch.utils import counter_inc

_DEVICE_CODES_ATTR = "_delphi_torch_codes"

_PHASE_SAN = re.compile(r"[^A-Za-z0-9_.-]+")


_FALSY = frozenset({"0", "false", "no", "off"})


def device_table_enabled() -> bool:
    """Whether domain scoring takes the bucketed route over the resident
    codes (the default), as the JAX package reads it:
    ``DELPHI_DEVICE_TABLE`` beats the ``repair.device_table`` session conf,
    and 0/false/no/off select the legacy per-group route."""
    env = os.environ.get("DELPHI_DEVICE_TABLE")
    if env is not None:
        return env.strip().lower() not in _FALSY
    from delphi_tpu_torch.session import get_session
    conf = get_session().conf.get("repair.device_table")
    if conf is not None:
        return str(conf).strip().lower() not in _FALSY
    return True


def record_transfer(nbytes: int, calls: int = 1) -> None:
    """Ledger entry for one host→device upload: the totals, and the same
    counts under the run recorder's current span when one is active."""
    counter_inc("transfer.calls", calls)
    counter_inc("transfer.bytes", int(nbytes))
    rec = current_recorder()
    if rec is not None:
        phase = _PHASE_SAN.sub("_", str(rec.current_phase))
        counter_inc(f"transfer.phase.{phase}.calls", calls)
        counter_inc(f"transfer.phase.{phase}.bytes", int(nbytes))


def to_device(x: Any, dtype: Any = None) -> torch.Tensor:
    """Uploads a host array to the port's device, under the guarded seam:
    a transient or transfer fault retries with backoff. A tensor already on
    the device passes through (``transfer.reuses``)."""
    if isinstance(x, torch.Tensor) and x.device == get_device():
        counter_inc("transfer.reuses")
        return x if dtype is None else x.to(dtype)
    arr = np.asarray(x)
    size = torch.empty(0, dtype=dtype).element_size() if dtype is not None \
        else arr.itemsize
    record_transfer(arr.size * size)
    return run_guarded(
        "xfer.upload",
        lambda: torch.as_tensor(arr, dtype=dtype, device=get_device()))


def evict_device_codes(cols) -> None:
    """Drops the cached device codes of ``cols`` and returns the freed
    blocks to the card (the ``evict`` rung of a guarded site that reads
    them); the next :func:`device_codes` uploads afresh."""
    n = 0
    for col in cols:
        if getattr(col, _DEVICE_CODES_ATTR, None) is not None:
            setattr(col, _DEVICE_CODES_ATTR, None)
            n += 1
    if n:
        counter_inc("transfer.evictions", n)
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def device_codes(col) -> torch.Tensor:
    """Device-resident int32 codes of one encoded column, uploaded on first
    use. The upload checks that every code lies in ``[-1, domain_size)``:
    the count kernels index their histograms with these codes unchecked."""
    cached = getattr(col, _DEVICE_CODES_ATTR, None)
    if cached is not None and cached.device == get_device():
        counter_inc("transfer.reuses")
        return cached
    codes = np.ascontiguousarray(col.codes, dtype=np.int32)
    if codes.size and (int(codes.min()) < -1
                       or int(codes.max()) >= col.domain_size):
        raise ValueError(
            f"column '{col.name}': codes outside [-1, {col.domain_size})")
    record_transfer(codes.nbytes)
    arr = run_guarded("xfer.upload",
                      lambda: torch.from_numpy(codes).to(get_device()))
    setattr(col, _DEVICE_CODES_ATTR, arr)
    return arr
