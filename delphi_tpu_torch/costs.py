"""Update-cost functions: the cost of changing a value x into y.

`compute(x, y)` returns None when either side is falsy. The batched
`compute_many` path serves PMF cost weighting and nearest-value repairs;
`Levenshtein` routes it through the native C++ batch distance when the
library is built, else through the python-Levenshtein extension or a
two-row dynamic program (identical distances). Host-only code.
"""

import pickle
from abc import ABCMeta, abstractmethod
from typing import Callable, List, Optional, Sequence, Union

from delphi_tpu_torch.utils.native import get_levenshtein

Value = Union[str, int, float]


class UpdateCostFunction(metaclass=ABCMeta):

    def __init__(self, targets: List[str] = []) -> None:
        self.targets: List[str] = targets

    @abstractmethod
    def _compute_impl(self, x: Value, y: Value) -> Optional[float]:
        pass

    def compute(self, x: Optional[Value], y: Optional[Value]) -> Optional[float]:
        return self._compute_impl(x, y) if x and y else None

    def compute_many(self, x: Optional[Value], ys: Sequence[Optional[Value]]) \
            -> Optional[List[Optional[float]]]:
        if not x or ys is None:
            return None
        return [self.compute(x, y) for y in ys]


class Levenshtein(UpdateCostFunction):
    """Edit-distance cost."""

    def __init__(self, targets: List[str] = []) -> None:
        UpdateCostFunction.__init__(self, targets)

    def __str__(self) -> str:
        params = f'targets={",".join(self.targets)}' if self.targets else ""
        return f"{self.__class__.__name__}({params})"

    def _compute_impl(self, x: Value, y: Value) -> Optional[float]:
        return float(_levenshtein_distance(str(x), str(y)))

    def compute_many(self, x: Optional[Value], ys: Sequence[Optional[Value]]) \
            -> Optional[List[Optional[float]]]:
        if not x or ys is None:
            return None
        return _batch_levenshtein(str(x), ys)


class UserDefinedUpdateCostFunction(UpdateCostFunction):
    """Wraps a user function f(x, y) -> float."""

    def __init__(self, f: Callable[[str, str], float], targets: List[str] = []) -> None:
        UpdateCostFunction.__init__(self, targets)
        try:
            ret = f("x", "y")
            if type(ret) is not float:
                raise TypeError
        except Exception:
            raise ValueError("`f` should take two values and return a float cost value")
        # pickle for executor transport parity; cloudpickle when available
        try:
            import cloudpickle
            self.pickled_f = cloudpickle.dumps(f)
            self._loads = cloudpickle.loads
        except ImportError:
            self.pickled_f = pickle.dumps(f)
            self._loads = pickle.loads

    def __str__(self) -> str:
        params = f'targets={",".join(self.targets)}' if self.targets else ""
        return f"{self.__class__.__name__}({params})"

    def _compute_impl(self, x: Value, y: Value) -> Optional[float]:
        if not hasattr(self, "_f"):
            self._f = self._loads(self.pickled_f)
        try:
            return float(self._f(str(x), str(y)))
        except Exception:
            return None


# -- Levenshtein backends ----------------------------------------------------

def _python_levenshtein(x: str, y: str) -> int:
    try:
        import Levenshtein as _lev
        return int(_lev.distance(x, y))
    except ImportError:
        # classic two-row DP fallback
        if len(x) < len(y):
            x, y = y, x
        prev = list(range(len(y) + 1))
        for i, cx in enumerate(x, 1):
            cur = [i]
            for j, cy in enumerate(y, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (cx != cy)))
            prev = cur
        return prev[-1]


def _levenshtein_distance(x: str, y: str) -> int:
    native = get_levenshtein()
    if native is not None:
        return native.distance(x, y)
    return _python_levenshtein(x, y)


def _batch_levenshtein(x: str, ys: Sequence[Optional[Value]]) -> List[Optional[float]]:
    native = get_levenshtein()
    if native is not None:
        return native.batch_distance(x, ys)
    return [float(_python_levenshtein(x, str(y))) if y else None for y in ys]


