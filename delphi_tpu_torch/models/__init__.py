"""Repair models of the port: the GBDT heads (:mod:`.gbdt`), the logistic
and MLP heads (:mod:`.linear`) and the host feature encoders
(:mod:`.encoding`)."""

from delphi_tpu_torch.models.encoding import FeatureEncoder
from delphi_tpu_torch.models.linear import (LogisticRegressionModel,
                                            MLPRegressorModel)
