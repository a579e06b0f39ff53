"""LPIPS distance pipeline (counterpart of ``torchmetrics_tpu/functional/image/lpips.py``).

The pipeline: input scaling, per-layer unit normalisation along channels, squared
difference, the learned 1x1 heads, spatial average (or an upsampled map), layer sum.
The backbones are ``models/{alexnet,vgg,squeezenet}.py``; the learned heads are bundled
in the port's own copy of the JAX package's ``_weights/lpips_heads.npz`` (the same 17
arrays). Backbone ImageNet weights are not bundled: a string ``net_type`` without them
raises unless ``allow_random_backbone=True``, which builds the port's seeded random
backbone (shared per (net, spatial, device)) and warns.

LPIPS is differentiable: gradients flow through autograd to the images. The backbone's
forward runs at full float32 (no TF32); its backward follows the caller's flags. The
input range check reads one verdict over both images from the device (the extrema
only on the error path).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.models._common import SharedTrunk, device_key, full_float32, moved
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_HEADS_FILE = Path(__file__).resolve().parent / "_weights" / "lpips_heads.npz"
_N_HEADS = {"alex": 5, "vgg": 5, "squeeze": 7}

# ImageNet-derived scaling constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def normalize_tensor(in_feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise along channels (dim 1).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image.lpips import normalize_tensor
        >>> normalize_tensor(torch.rand(2, 3, 16, 16)).shape
        torch.Size([2, 3, 16, 16])
    """
    norm_factor = torch.sqrt(torch.sum(in_feat**2, dim=1, keepdim=True))
    return in_feat / (norm_factor + eps)


def spatial_average(in_tens: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Mean over H and W."""
    return in_tens.mean(dim=(2, 3), keepdim=keepdim)


def upsample(in_tens: torch.Tensor, out_hw: Tuple[int, int] = (64, 64)) -> torch.Tensor:
    """Bilinear upsample to ``out_hw`` (half-pixel centres, as ``jax.image.resize``)."""
    return F.interpolate(in_tens, size=tuple(out_hw), mode="bilinear", align_corners=False)


@lru_cache(maxsize=None)
def _scaling_constants(device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    shift = torch.tensor(_SHIFT, dtype=dtype).view(1, -1, 1, 1)
    scale = torch.tensor(_SCALE, dtype=dtype).view(1, -1, 1, 1)
    return shift.to(device), scale.to(device)


def scaling_layer(inp: torch.Tensor) -> torch.Tensor:
    """Shift and scale RGB input (the constants are made once per device and dtype)."""
    shift, scale = _scaling_constants(inp.device, inp.dtype)
    return (inp - shift) / scale


def _lpips_distance(
    feats_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    img1: torch.Tensor,
    img2: torch.Tensor,
    lin_weights: Optional[Sequence[torch.Tensor]] = None,
    normalize: bool = False,
    spatial: bool = False,
) -> torch.Tensor:
    """The full LPIPS forward for a backbone: ``(N, 1, 1, 1)``, or ``(N, 1, H, W)`` with
    ``spatial``."""
    if normalize:  # [0, 1] -> [-1, 1]
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    with full_float32():
        outs0, outs1 = feats_fn(scaling_layer(img1)), feats_fn(scaling_layer(img2))

    val: Optional[torch.Tensor] = None
    for kk in range(len(outs0)):
        diff = (normalize_tensor(outs0[kk]) - normalize_tensor(outs1[kk])) ** 2
        if lin_weights is not None:
            lin_out = (diff * lin_weights[kk].reshape(1, -1, 1, 1)).sum(dim=1, keepdim=True)
        else:
            lin_out = diff.sum(dim=1, keepdim=True)
        layer = upsample(lin_out, out_hw=img1.shape[2:]) if spatial else spatial_average(lin_out, keepdim=True)
        val = layer if val is None else val + layer
    return val


class LPIPSNet(SharedTrunk):
    """``net(img1, img2, normalize=False)``: a backbone and its heads. Shared, not copied
    (``models/_common.SharedTrunk``): a default network comes from one cache per (net,
    spatial, device); any other one moves as a copy (its backbone through
    ``models/_common.moved``, its heads by ``Tensor.to``)."""

    def __init__(
        self,
        feats_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
        lin_weights: Optional[Sequence[torch.Tensor]] = None,
        spatial: bool = False,
        default: Optional[str] = None,
    ) -> None:
        self.feats_fn = feats_fn
        self.lin_weights = None if lin_weights is None else list(lin_weights)
        self.spatial = spatial
        self.default = default  # the net type of a default (seeded) network

    @property
    def device(self) -> torch.device:
        return self.lin_weights[0].device if self.lin_weights else torch.device("cpu")

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        return _lpips_distance(self.feats_fn, img1, img2, self.lin_weights, normalize, self.spatial)

    def _cache_entry(self, device: str) -> Optional[Tuple[Callable[..., Any], tuple]]:
        return None if self.default is None else (_default_lpips_network, (self.default, self.spatial, device))

    def _moved(self, device: torch.device) -> "LPIPSNet":
        heads = None if self.lin_weights is None else [w.to(device) for w in self.lin_weights]
        return LPIPSNet(moved(self.feats_fn, device), heads, self.spatial)

    def _fields(self) -> tuple:
        return (self.feats_fn, self.lin_weights, self.spatial)


def make_lpips_net(
    feats_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
    lin_weights: Optional[Sequence[torch.Tensor]] = None,
    spatial: bool = False,
) -> LPIPSNet:
    """Compose a backbone and heads into the ``net(img1, img2, normalize=...)`` callable."""
    return LPIPSNet(feats_fn, lin_weights, spatial)


def load_lpips_heads(net_type: str = "alex") -> List[torch.Tensor]:
    """The bundled learned 1x1 head weights of a backbone, as flat ``(C,)`` float32 CPU
    tensors (the LPIPS paper's heads, converted by the JAX package's
    ``scripts/convert_lpips_heads.py``)."""
    if net_type not in _N_HEADS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_N_HEADS)}, but got {net_type}.")
    with np.load(_HEADS_FILE) as data:
        return [torch.from_numpy(np.array(data[f"{net_type}_lin{i}"])) for i in range(_N_HEADS[net_type])]


def _lpips_backbone_builder(net_type: str) -> Callable[..., Any]:
    if net_type == "alex":
        from torchmetrics_tpu_torch.models.alexnet import alexnet_lpips_extractor as build
    elif net_type == "vgg":
        from torchmetrics_tpu_torch.models.vgg import vgg16_lpips_extractor as build
    else:
        from torchmetrics_tpu_torch.models.squeezenet import squeezenet_lpips_extractor as build
    return build


def lpips_network(
    net_type: str = "alex",
    backbone_state_dict: Optional[Mapping[str, Any]] = None,
    backbone_variables: Optional[Mapping[str, Any]] = None,
    spatial: bool = False,
    allow_random_backbone: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> LPIPSNet:
    """The default ``net(img1, img2, normalize=...)`` of a string backbone on ``device``
    (``None``: the card): the bundled heads and the backbone. Without
    ``backbone_state_dict`` (a torchvision checkpoint) or ``backbone_variables`` (the JAX
    package's flax variables) this RAISES unless ``allow_random_backbone=True``, which
    builds the seeded random backbone and warns."""
    if net_type not in _N_HEADS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(_N_HEADS)}, but got {net_type}.")
    if backbone_state_dict is None and backbone_variables is None:
        if not allow_random_backbone:
            raise RuntimeError(
                f"No pretrained `{net_type}` backbone weights were supplied and none are bundled (the learned"
                " LPIPS heads are), so scores would come from a randomly-initialised backbone —"
                " plausible-looking but not canonical LPIPS. Pass `backbone_state_dict=` (a torchvision"
                " checkpoint) or `backbone_variables=` for exact values, or opt in explicitly with"
                " `allow_random_backbone=True`."
            )
        rank_zero_warn(
            f"Using a deterministic randomly-initialised `{net_type}` backbone (`allow_random_backbone=True`):"
            " scores are self-consistent but not canonical LPIPS."
        )
        return _default_lpips_network(net_type, spatial, device_key(device))
    feats_fn = _lpips_backbone_builder(net_type)(
        state_dict=backbone_state_dict, variables=backbone_variables, device=device
    )
    heads = [w.to(resolve_device(device)) for w in load_lpips_heads(net_type)]
    return make_lpips_net(feats_fn, lin_weights=heads, spatial=spatial)


@lru_cache(maxsize=None)
def _default_lpips_network(net_type: str, spatial: bool, device: str) -> LPIPSNet:
    """One seeded backbone per (net, spatial, device), shared by every caller."""
    feats_fn = _lpips_backbone_builder(net_type)(device=device)
    heads = [w.to(device) for w in load_lpips_heads(net_type)]
    return LPIPSNet(feats_fn, heads, spatial, default=net_type)


def _valid_img(img1: torch.Tensor, img2: torch.Tensor, normalize: bool) -> bool:
    """Input domain check of both images: ``[N, 3, H, W]``, values in [0, 1]
    (``normalize``) or >= -1; the values are read in one transfer (one 0-d verdict)."""
    if not all(img.ndim == 4 and img.shape[1] == 3 for img in (img1, img2)):
        return False
    lo = torch.minimum(img1.amin(), img2.amin())
    ok = (lo >= 0) & (torch.maximum(img1.amax(), img2.amax()) <= 1) if normalize else lo >= -1
    return bool(ok)


def _lpips_update(
    img1: torch.Tensor, img2: torch.Tensor, net: Callable[..., torch.Tensor], normalize: bool
) -> Tuple[torch.Tensor, int]:
    """Per-pair distances and the pair count."""
    if not _valid_img(img1, img2, normalize):
        lo1, hi1, lo2, hi2 = torch.stack([img1.amin(), img1.amax(), img2.amin(), img2.amax()]).tolist()
        raise ValueError(
            "Expected both input arguments to be normalized tensors with shape [N, 3, H, W]."
            f" Got input with shape {tuple(img1.shape)} and {tuple(img2.shape)} and values in range"
            f" {[lo1, hi1]} and {[lo2, hi2]} when all values are"
            f" expected to be in the {[0, 1] if normalize else [-1, 1]} range."
        )
    loss = net(img1, img2, normalize=normalize).squeeze()
    return loss, img1.shape[0]


def _lpips_compute(sum_scores: torch.Tensor, total: Union[torch.Tensor, int], reduction: str = "mean") -> torch.Tensor:
    """Reduce the accumulated scores."""
    return sum_scores / total if reduction == "mean" else sum_scores


def learned_perceptual_image_patch_similarity(
    img1: torch.Tensor,
    img2: torch.Tensor,
    net: Union[str, Callable[..., torch.Tensor]] = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    allow_random_backbone: bool = False,
) -> torch.Tensor:
    """LPIPS with a string backbone (bundled heads, built on the images' device) or an
    injected net. A string ``net`` without pretrained backbone weights raises unless
    ``allow_random_backbone=True`` (see :func:`lpips_network`)."""
    if isinstance(net, str):
        net = lpips_network(net, allow_random_backbone=allow_random_backbone, device=img1.device)
    elif not callable(net):
        raise ValueError(
            f"Argument `net={net!r}` must be a backbone name in {tuple(_N_HEADS)} or a callable built with"
            " `make_lpips_net(feats_fn, lin_weights)`."
        )
    loss, total = _lpips_update(img1, img2, net, normalize)
    return _lpips_compute(loss.sum(), total, reduction)
