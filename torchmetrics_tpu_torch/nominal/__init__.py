"""Nominal association metrics of the port (counterpart of ``torchmetrics_tpu/nominal``)."""

from torchmetrics_tpu_torch.nominal.cramers import CramersV
from torchmetrics_tpu_torch.nominal.fleiss_kappa import FleissKappa
from torchmetrics_tpu_torch.nominal.pearson import PearsonsContingencyCoefficient
from torchmetrics_tpu_torch.nominal.theils_u import TheilsU
from torchmetrics_tpu_torch.nominal.tschuprows import TschuprowsT

__all__ = [
    "CramersV",
    "FleissKappa",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
