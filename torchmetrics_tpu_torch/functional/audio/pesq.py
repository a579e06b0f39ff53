"""PESQ through the ``pesq`` package (counterpart of ``torchmetrics_tpu/functional/audio/pesq.py``).

The ITU-T P.862 pipeline runs on the host in the ``pesq`` C extension, as in the JAX
package: the inputs are read once, the scores come back on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.audio._host import host_pair, to_input_device
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE

__doctest_requires__ = {("perceptual_evaluation_speech_quality",): ["pesq"]}


def perceptual_evaluation_speech_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> torch.Tensor:
    """PESQ score per sample via the ``pesq`` package."""
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    _check_same_shape(preds, target)
    preds_np, target_np = host_pair(preds, target)

    if preds.ndim == 1:
        return to_input_device(pesq_backend.pesq(fs, target_np, preds_np, mode), preds)
    preds_np = preds_np.reshape(-1, preds.shape[-1])
    target_np = target_np.reshape(-1, preds.shape[-1])
    if n_processes != 1:
        pesq_val_np = np.array(pesq_backend.pesq_batch(fs, target_np, preds_np, mode, n_processor=n_processes))
    else:
        pesq_val_np = np.empty(shape=(preds_np.shape[0]))
        for b in range(preds_np.shape[0]):
            pesq_val_np[b] = pesq_backend.pesq(fs, target_np[b, :], preds_np[b, :], mode)
    return to_input_device(pesq_val_np, preds).reshape(preds.shape[:-1])
