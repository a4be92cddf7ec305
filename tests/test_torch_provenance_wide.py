"""The provenance ledger of the gauntlet's ``wide`` scenario (56 columns,
11 targets, 2,000 rows) in both packages on the CPU, held as
``tests/test_torch_provenance.py`` holds the other four scenarios. A file
of its own: the port's CPU tree builder takes about 100 s on this
scenario's eleven fits (its stable sorts of the histogram keys), so the
test runs beside the others.
"""

import pytest
import torch

import delphi_tpu_torch as T

from test_torch_provenance import check_scenario_ledger


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def test_gauntlet_ledger_matches_jax_wide(monkeypatch):
    check_scenario_ledger("wide", monkeypatch)
