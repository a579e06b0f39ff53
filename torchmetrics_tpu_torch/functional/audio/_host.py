"""What the host-backed audio metrics share: one device-to-host read of both inputs."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def host_pair(preds: torch.Tensor, target: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """``(preds, target)`` as host arrays, read in one copy (their shapes are equal)."""
    both = torch.stack([preds, target]).detach().cpu().numpy()
    return both[0], both[1]


def to_input_device(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host scores back on the device of the inputs, as float32."""
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(like.device)
