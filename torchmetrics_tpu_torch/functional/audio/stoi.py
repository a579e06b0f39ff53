"""STOI through the ``pystoi`` package (counterpart of ``torchmetrics_tpu/functional/audio/stoi.py``).

Runs on the host, as in the JAX package: the inputs are read once, the scores come
back on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.audio._host import host_pair, to_input_device
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE

__doctest_requires__ = {("short_time_objective_intelligibility",): ["pystoi"]}


def short_time_objective_intelligibility(
    preds: torch.Tensor, target: torch.Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> torch.Tensor:
    """STOI score per sample via ``pystoi``."""
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "STOI metric requires that pystoi is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pystoi`."
        )
    from pystoi import stoi as stoi_backend

    _check_same_shape(preds, target)
    preds_np, target_np = host_pair(preds, target)

    if preds.ndim == 1:
        return to_input_device(stoi_backend(target_np, preds_np, fs, extended), preds)
    preds_np = preds_np.reshape(-1, preds.shape[-1])
    target_np = target_np.reshape(-1, preds.shape[-1])
    stoi_val_np = np.empty(shape=(preds_np.shape[0]))
    for b in range(preds_np.shape[0]):
        stoi_val_np[b] = stoi_backend(target_np[b, :], preds_np[b, :], fs, extended)
    return to_input_device(stoi_val_np, preds).reshape(preds.shape[:-1])
