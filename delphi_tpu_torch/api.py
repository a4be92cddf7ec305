"""Delphi API façade of the PyTorch port.

    from delphi_tpu_torch import delphi
    repaired = delphi.repair.setInput(df).setRowId("tid").run()

`delphi` is the singleton; `.repair` returns a fresh RepairModel and
`.misc` a fresh RepairMisc (the helper utilities). `register_table` feeds
pandas inputs by name.
"""

from typing import Any

import pandas as pd

from delphi_tpu_torch.misc import RepairMisc
from delphi_tpu_torch.model import RepairModel
from delphi_tpu_torch.session import get_session


class Delphi:
    """A Delphi API set for data repairing.

    * ``repair``: detect errors in input data and infer correct ones.
    * ``misc``: provide helper functionalities.
    """

    _instance: Any = None

    def __new__(cls, *args: Any, **kwargs: Any) -> "Delphi":
        if cls._instance is None:
            cls._instance = super(Delphi, cls).__new__(cls)
        return cls._instance

    @staticmethod
    def getOrCreate() -> "Delphi":
        return Delphi()

    @property
    def repair(self) -> RepairModel:
        """Returns :class:`RepairModel` to repair input data."""
        return RepairModel()

    @property
    def misc(self) -> RepairMisc:
        """Returns :class:`RepairMisc` for misc helper functions."""
        return RepairMisc()

    @staticmethod
    def register_table(name: str, df: pd.DataFrame) -> str:
        """Registers a pandas DataFrame under a catalog name."""
        return get_session().register(name, df)

    @staticmethod
    def table(name: str) -> pd.DataFrame:
        return get_session().table(name)

    @staticmethod
    def setConf(key: str, value: str) -> None:
        """Sets a framework config key (``repair.logLevel`` routes pipeline
        narration, default TRACE)."""
        get_session().conf[key] = value

    @staticmethod
    def getConf(key: str, default: str = "") -> str:
        return get_session().conf.get(key, default)

    @staticmethod
    def version() -> str:
        return "0.1.0-torch-EXPERIMENTAL"
