"""VGG16 feature slices for LPIPS (counterpart of ``torchmetrics_tpu/models/vgg.py``).

torchvision's ``vgg16().features`` under its own indices, with five taps at relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3 (64 / 128 / 256 / 512 / 512 channels); a 2 x 2 max
pool between stages, none after the last.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

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

# torchvision vgg16.features conv layer indices, grouped by stage
_STAGES: Tuple[Tuple[int, ...], ...] = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_WIDTHS: Tuple[int, ...] = (64, 128, 256, 512, 512)
_TAPS = tuple(stage[-1] + 1 for stage in _STAGES)  # the ReLU closing each stage

# ImageNet normalisation baked into the LPIPS scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """``forward`` maps NCHW / NHWC images to the 5 post-ReLU stage maps (NCHW).

    ``apply_scaling=True`` applies the LPIPS scaling layer to raw [-1, 1] inputs; use
    ``False`` under a pipeline that already scaled (the LPIPS functional does).
    """

    def __init__(self, apply_scaling: bool = True) -> None:
        super().__init__()
        self.apply_scaling = apply_scaling
        layers: List[nn.Module] = []  # conv, ReLU per layer; a pool closes each stage but the last
        in_ch = 3
        for si, stage in enumerate(_STAGES):
            for _ in stage:
                layers += [nn.Conv2d(in_ch, _WIDTHS[si], 3, padding=1), nn.ReLU()]
                in_ch = _WIDTHS[si]
            if si < len(_STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = to_nchw(x)
        if self.apply_scaling:
            shift = x.new_tensor(_SHIFT).view(1, -1, 1, 1)
            scale = x.new_tensor(_SCALE).view(1, -1, 1, 1)
            x = (x - shift) / scale
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAPS:
                outs.append(x)
        return outs


def from_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16`` (or bare ``features``) weights as the port's state dict."""
    prefix = features_prefix(state_dict)
    keys = [f"{prefix}{li}.{k}" for stage in _STAGES for li in stage for k in ("weight", "bias")]
    return {f"features.{k[len(prefix):]}": v for k, v in tensors(state_dict, keys).items()}


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VGG16Features`` flax variables as the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for stage in _STAGES:
        for li in stage:
            out.update(conv_from_flax(variables["params"][f"conv{li}"], f"features.{li}"))
    return out


def vgg16_lpips_extractor(
    state_dict: Optional[Mapping[str, Any]] = None,
    variables: Optional[Mapping[str, Any]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> VGG16Features:
    """The ``feats_fn`` the LPIPS pipeline takes (scaling off: the pipeline scales): NCHW
    in, 5 NCHW stage maps out, frozen on ``device``. Without weights, the port's seeded
    random init."""
    model = default_trunk(lambda: VGG16Features(apply_scaling=False), "cpu")
    if variables is not None:
        load_trunk(model, state_dict_from_flax(variables))
    elif state_dict is not None:
        load_trunk(model, from_torch_state_dict(state_dict))
    return frozen(model, device)
