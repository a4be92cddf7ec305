"""delphi_tpu_torch — the PyTorch / CUDA port of delphi_tpu.

The same public surface as the JAX package:

    from delphi_tpu_torch import (delphi, ConstraintErrorDetector,
                                  NullErrorDetector)
    repaired = delphi.repair \\
        .setInput(df).setRowId("tid") \\
        .setErrorDetectors([
            NullErrorDetector(),
            ConstraintErrorDetector(constraints="city->state")]) \\
        .run()

Tensors live on the port's device (:mod:`delphi_tpu_torch.device`):
``cuda`` unless the caller asks for the CPU (``DELPHI_TORCH_DEVICE=cpu``).
The phase-1 statistics run through hand-written CUDA kernels
(:mod:`delphi_tpu_torch.ops.kernels`). This package imports neither JAX nor
any module of ``delphi_tpu``.
"""

from delphi_tpu_torch.api import Delphi
from delphi_tpu_torch.costs import (Levenshtein, UpdateCostFunction,
                                    UserDefinedUpdateCostFunction)
from delphi_tpu_torch.device import get_device, set_device
from delphi_tpu_torch.errors import (
    ConstraintErrorDetector, DomainValues, ErrorDetector,
    GaussianOutlierErrorDetector, LOFOutlierErrorDetector, NullErrorDetector,
    RegExErrorDetector, ScikitLearnBackedErrorDetector,
    ScikitLearnBasedErrorDetector)
from delphi_tpu_torch.misc import RepairMisc
from delphi_tpu_torch.model import FunctionalDepModel, PoorModel, RepairModel

delphi = Delphi.getOrCreate()

__version__ = "0.1.0"

__all__ = [
    "Delphi", "delphi", "RepairModel", "RepairMisc", "PoorModel",
    "FunctionalDepModel", "UpdateCostFunction", "Levenshtein",
    "UserDefinedUpdateCostFunction", "ErrorDetector",
    "NullErrorDetector", "DomainValues", "RegExErrorDetector",
    "ConstraintErrorDetector", "GaussianOutlierErrorDetector",
    "ScikitLearnBasedErrorDetector", "ScikitLearnBackedErrorDetector",
    "LOFOutlierErrorDetector", "get_device", "set_device",
]
