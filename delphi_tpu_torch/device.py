"""The port's one device decision.

Every tensor the pipeline creates lives on :func:`get_device`. The default
is ``cuda``; callers that want the CPU (the tests, a cross-check run) ask
for it explicitly, through :func:`set_device` or ``DELPHI_TORCH_DEVICE=cpu``.
Asking for ``cuda`` on a host without a card raises: the port never carries
on silently on the CPU. The first time a process resolves ``cuda`` it
probes the card under the resilience plane's init deadline
(:func:`delphi_tpu_torch.parallel.resilience.probe_backend`).
"""

import os
from typing import Optional, Union

import torch

from delphi_tpu_torch.parallel.resilience import probe_backend

_override: Optional[torch.device] = None
_configured = False
_probed = False


def _configure_precision() -> None:
    # The reference pins full f32 matmuls (models/gbdt.py in the JAX
    # package) because reduced precision flipped split ties; TF32 would do
    # the same on the card.
    global _configured
    if not _configured:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _configured = True


def _resolve(name: Union[str, torch.device]) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"delphi_tpu_torch: device '{dev}' requested but CUDA is not "
            "available; ask for the CPU explicitly with "
            "DELPHI_TORCH_DEVICE=cpu or set_device('cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    global _probed
    if dev.type == "cuda" and not _probed:
        probe_backend()
        _probed = True
    if dev.type == "cuda" and dev.index is None:
        # the index a tensor reports: "cuda" and "cuda:0" compare unequal,
        # and the device-code cache compares devices
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(name: Optional[Union[str, torch.device]]) -> None:
    """Pins the port's device (``None`` returns to the environment /
    ``cuda`` default)."""
    global _override
    _override = None if name is None else _resolve(name)


def get_device() -> torch.device:
    """The device every pipeline tensor is created on: the pinned one, else
    ``DELPHI_TORCH_DEVICE``, else ``cuda``."""
    _configure_precision()
    if _override is not None:
        return _override
    return _resolve(os.environ.get("DELPHI_TORCH_DEVICE", "cuda"))
