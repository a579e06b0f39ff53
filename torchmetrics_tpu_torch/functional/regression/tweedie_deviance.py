"""Tweedie deviance score (counterpart of ``torchmetrics_tpu/functional/regression/tweedie_deviance.py``).

The domain checks read the inputs on the host on every eager update, whatever
``validate_args`` is, as in the JAX package; inside an update body the compiled engine
runs (``engine.compiled.in_traced_body``: its guarded first step, its capture) they
are skipped, as the JAX package skips them under a tracer, so the update is captured
at every power.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.engine.compiled import in_traced_body
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy


def _tweedie_power_validation(power: float) -> None:
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")


def _tweedie_tensor_validation(preds: torch.Tensor, targets: torch.Tensor, power: float) -> None:
    """The domain of each power (host reads); skipped inside the engine's update body."""
    if in_traced_body():
        return

    def any_(x: torch.Tensor) -> bool:
        return bool(x.any())

    if power == 1 and (any_(preds <= 0) or any_(targets < 0)):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and (any_(preds <= 0) or any_(targets <= 0)):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    if power < 0 and any_(preds <= 0):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    if 1 < power < 2 and (any_(preds <= 0) or any_(targets < 0)):
        raise ValueError(f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative.")
    if power >= 2 and power != 2 and (any_(preds <= 0) or any_(targets <= 0)):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(
    preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ deviance and the int32 number of elements."""
    _check_same_shape(preds, targets)
    _tweedie_power_validation(power)
    _tweedie_tensor_validation(preds, targets, power)

    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(torch.clamp(targets, min=0.0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    count = torch.full((), deviance_score.numel(), dtype=torch.int32, device=deviance_score.device)
    return deviance_score.sum(), count


def _tweedie_deviance_score_compute(sum_deviance_score: torch.Tensor, num_observations: torch.Tensor) -> torch.Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0) -> torch.Tensor:
    """Tweedie deviance of order ``power``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(tweedie_deviance_score(preds, target, power=1.5)), 4)
        0.112
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
