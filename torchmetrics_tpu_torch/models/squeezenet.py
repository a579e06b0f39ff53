"""SqueezeNet-1.1 feature slices for LPIPS (counterpart of ``torchmetrics_tpu/models/squeezenet.py``).

torchvision's ``squeezenet1_1().features`` under its own indices (``features.3.squeeze.weight``),
with seven taps at the slice ends [0:2), [2:5), [5:8), [8:10), [10:11), [11:12),
[12:13) (64 / 128 / 256 / 384 / 384 / 512 / 512 channels), feeding the bundled
``squeeze`` LPIPS heads. The pools are ``MaxPool2d(3, 2, ceil_mode=True)``, which equals
the JAX trunk's right / bottom ``-inf`` pad.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.models._common import (
    conv_from_flax,
    default_trunk,
    features_prefix,
    frozen,
    load_trunk,
    tensors,
    to_nchw,
)

# torchvision squeezenet1_1.features: Fire(squeeze, expand1x1, expand3x3) per index
_FIRES = {3: (16, 64, 64), 4: (16, 64, 64), 6: (32, 128, 128), 7: (32, 128, 128),
          9: (48, 192, 192), 10: (48, 192, 192), 11: (64, 256, 256), 12: (64, 256, 256)}
_POOLS = (2, 5, 8)  # MaxPool2d(3, 2, ceil_mode=True)
_TAPS = (1, 4, 7, 9, 10, 11, 12)  # last features-index of each of the 7 slices
_SUBCONVS = ("squeeze", "expand1x1", "expand3x3")


class Fire(nn.Module):
    """squeeze 1x1 -> ReLU -> [expand 1x1 | expand 3x3] -> ReLU -> concat."""

    def __init__(self, in_channels: int, squeeze: int, expand1: int, expand3: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], 1)


class SqueezeNetFeatures(nn.Module):
    """``forward`` maps NCHW / NHWC images to the 7 slice maps (NCHW)."""

    def __init__(self) -> None:
        super().__init__()
        layers: List[nn.Module] = [nn.Conv2d(3, 64, 3, stride=2), nn.ReLU()]
        in_ch = 64
        for i in range(2, 13):
            if i in _POOLS:
                layers.append(nn.MaxPool2d(3, 2, ceil_mode=True))
            else:
                s, e1, e3 = _FIRES[i]
                layers.append(Fire(in_ch, s, e1, e3))
                in_ch = e1 + e3
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = to_nchw(x)
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAPS:
                outs.append(x)
        return outs


def _conv_keys(prefix: str):
    yield from (f"{prefix}0.{k}" for k in ("weight", "bias"))
    for i in _FIRES:
        for sub in _SUBCONVS:
            yield from (f"{prefix}{i}.{sub}.{k}" for k in ("weight", "bias"))


def from_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``squeezenet1_1`` (or bare ``features``) weights as the port's state dict."""
    prefix = features_prefix(state_dict)
    return {f"features.{k[len(prefix):]}": v for k, v in tensors(state_dict, _conv_keys(prefix)).items()}


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SqueezeNetFeatures`` flax variables as the port's state dict."""
    params = variables["params"]
    out = conv_from_flax(params["conv0"], "features.0")
    for i in _FIRES:
        for sub in _SUBCONVS:
            out.update(conv_from_flax(params[f"fire{i}"][sub], f"features.{i}.{sub}"))
    return out


def squeezenet_lpips_extractor(
    state_dict: Optional[Mapping[str, Any]] = None,
    variables: Optional[Mapping[str, Any]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> SqueezeNetFeatures:
    """The ``feats_fn`` the LPIPS pipeline takes: NCHW in, 7 NCHW slice maps out, frozen on
    ``device``. Without weights, the port's seeded random init."""
    model = default_trunk(SqueezeNetFeatures, "cpu")
    if variables is not None:
        load_trunk(model, state_dict_from_flax(variables))
    elif state_dict is not None:
        load_trunk(model, from_torch_state_dict(state_dict))
    return frozen(model, device)
