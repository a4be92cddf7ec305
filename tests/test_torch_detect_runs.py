"""Full ``run()`` frames at default options with the gauntlet runner's
detectors, the port against the JAX package on the CPU, for the two
scenarios that train longest: correlated_multi (NULL, regex and FD
constraints; equal apart from NEAR_TIE logistic repairs) and
numeric_regression (NULL and Gaussian outliers; regression repairs within
1e-5, as in tests/test_torch_pipeline.py). Split from
tests/test_torch_detect_pipeline.py to keep each file's run short.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import delphi_tpu as J
import delphi_tpu_torch as T
from delphi_tpu_torch.utils import counters

from test_torch_detect_pipeline import (assert_runs_match, scenario_model,
                                        traced_run)


@pytest.fixture(autouse=True)
def _cpu_device():
    T.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    T.set_device(None)


def test_full_run_correlated_multi_matches_jax():
    want, _, ties = traced_run(J, scenario_model(J, "correlated_multi"))
    got, _, _ = traced_run(T, scenario_model(T, "correlated_multi"))
    assert len(got) > 0
    assert_runs_match(got, want, ties)


def test_full_run_numeric_regression_within_tolerance():
    """The outlier cells and NULLs repaired by regression: the same cells,
    each repaired value within 1e-5 of the JAX package's, or of its
    column's mean magnitude for values near zero (the known last-ulp leaf
    sum differences of the two tree builders)."""
    want = scenario_model(J, "numeric_regression").run()
    counters.clear()
    got = scenario_model(T, "numeric_regression").run()
    assert counters["detect.percentile"] == 1
    key = ["tid", "attribute", "current_value"]
    pd.testing.assert_frame_equal(got[key], want[key])
    for attr in want["attribute"].unique():
        sel = (want["attribute"] == attr).to_numpy()
        rj = want["repaired"][sel].astype(float).to_numpy()
        rt = got["repaired"][sel].astype(float).to_numpy()
        assert np.isfinite(rt).all() and len(rt) > 0
        np.testing.assert_allclose(rt, rj, rtol=1e-5,
                                   atol=1e-5 * np.abs(rj).mean())
