"""Functional nominal metrics of the port (counterpart of ``torchmetrics_tpu/functional/nominal``)."""

from torchmetrics_tpu_torch.functional.nominal.cramers import cramers_v, cramers_v_matrix
from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import fleiss_kappa
from torchmetrics_tpu_torch.functional.nominal.pearson import (
    pearsons_contingency_coefficient,
    pearsons_contingency_coefficient_matrix,
)
from torchmetrics_tpu_torch.functional.nominal.theils_u import theils_u, theils_u_matrix
from torchmetrics_tpu_torch.functional.nominal.tschuprows import tschuprows_t, tschuprows_t_matrix

__all__ = [
    "cramers_v",
    "cramers_v_matrix",
    "fleiss_kappa",
    "pearsons_contingency_coefficient",
    "pearsons_contingency_coefficient_matrix",
    "theils_u",
    "theils_u_matrix",
    "tschuprows_t",
    "tschuprows_t_matrix",
]
