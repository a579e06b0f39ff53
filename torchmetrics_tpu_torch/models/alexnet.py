"""AlexNet feature slices for LPIPS (counterpart of ``torchmetrics_tpu/models/alexnet.py``).

torchvision's ``alexnet().features`` under its own indices (``features.0.weight``), with
five taps at the post-ReLU activations of the convs at 0 / 3 / 6 / 8 / 10 (64 / 192 /
384 / 256 / 256 channels), which feed the bundled ``alex`` LPIPS heads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import torch
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

# torchvision alexnet.features conv layers: index -> (width, kernel, stride, pad)
_CONVS = {0: (64, 11, 4, 2), 3: (192, 5, 1, 2), 6: (384, 3, 1, 1), 8: (256, 3, 1, 1), 10: (256, 3, 1, 1)}
_TAPS = (1, 4, 7, 9, 11)  # the ReLU after each conv
_POOLS = (2, 5, 12)  # MaxPool2d(3, 2)


class AlexNetFeatures(nn.Module):
    """``forward`` maps NCHW / NHWC images to the 5 post-ReLU slice maps (NCHW)."""

    def __init__(self) -> None:
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for i in range(13):
            if i in _CONVS:
                width, k, s, p = _CONVS[i]
                layers.append(nn.Conv2d(in_ch, width, k, stride=s, padding=p))
                in_ch = width
            elif i in _POOLS:
                layers.append(nn.MaxPool2d(3, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = to_nchw(x)
        outs = []
        for i, layer in enumerate(self.features[: _TAPS[-1] + 1]):
            x = layer(x)
            if i in _TAPS:
                outs.append(x)
        return outs


def from_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``alexnet`` (or bare ``features``) weights as the port's state dict."""
    prefix = features_prefix(state_dict)
    out = tensors(state_dict, [f"{prefix}{i}.{k}" for i in _CONVS for k in ("weight", "bias")])
    return {f"features.{k[len(prefix):]}": v for k, v in out.items()}


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``AlexNetFeatures`` flax variables as the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i in _CONVS:
        out.update(conv_from_flax(variables["params"][f"conv{i}"], f"features.{i}"))
    return out


def alexnet_lpips_extractor(
    state_dict: Optional[Mapping[str, Any]] = None,
    variables: Optional[Mapping[str, Any]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> AlexNetFeatures:
    """The ``feats_fn`` the LPIPS pipeline takes: NCHW in, 5 NCHW slice maps out, frozen
    on ``device`` (``None``: the card). Without weights, the port's seeded random init."""
    model = default_trunk(AlexNetFeatures, "cpu")
    if variables is not None:
        load_trunk(model, state_dict_from_flax(variables))
    elif state_dict is not None:
        load_trunk(model, from_torch_state_dict(state_dict))
    return frozen(model, device)
