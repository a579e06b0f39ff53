"""InceptionV3 feature trunks for FID / KID / InceptionScore (counterpart of
``torchmetrics_tpu/models/inception.py``).

``torch.nn`` modules under torchvision's module and parameter names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``, ``fc.weight``), so
a torchvision ``inception_v3`` or a torch-fidelity ``pt_inception-2015-12-05`` state dict
loads with ``load_state_dict`` as it is. ``BasicConv2d`` is a conv without bias, a batch
norm with eps 1e-3 on its stored statistics, and a ReLU; the trunks are inference only
(no dropout, the aux head is carried for loading and never run).

``FIDInceptionV3`` is torch-fidelity's "inception-v3-compat" trunk: the TF1 bilinear
resize to 299 x 299 (``src = dst * in / out``, no half-pixel offset) as two interpolation
matrices applied with ``torch.matmul`` and cached per (in, out, device), ``(x - 128) /
128``, the FID pooling variants (``count_include_pad=False`` in the A and C blocks and in
``Mixed_7b``, a 3 x 3 stride-1 max pool in ``Mixed_7c``) and a 1008-way fc, with the taps
64 / 192 / 768 / 2048 / ``logits_unbiased`` / ``logits``. ``InceptionV3`` is the torchvision
trunk (uint8 inputs / 255, then ``2x - 1``) returning the 2048 pooled features.

Both take NCHW, or NHWC (read as the JAX trunks read it). ``state_dict_from_flax`` maps
the JAX package's flax variables (numpy leaves) into the port's state dict, which is how
the tests make both packages compute the same function.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchmetrics_tpu_torch.models._common import (
    SharedTrunk,
    conv_from_flax,
    default_trunk,
    device_key,
    frozen,
    full_float32,
    load_trunk,
    moved,
    tensors,
    to_float32,
    to_nchw,
)
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_BN_EPS = 1e-3
TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")


class BasicConv2d(nn.Module):
    """conv (no bias) -> batch norm (eps 1e-3, stored statistics) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs: Any) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, bias=False, **kwargs)
        self.bn = nn.BatchNorm2d(out_channels, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    """3 x 3 / stride 1 / pad 1 average; ``count_include_pad=False`` divides a border
    window by its real pixels (torch-fidelity's FID blocks)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, fid_pool: bool = False) -> None:
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid_pool))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, fid_pool: bool = False) -> None:
        super().__init__()
        c7 = channels_7x7
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(self.branch7x7dbl_2(bd))))
        bp = self.branch_pool(_avg_pool(x, count_include_pad=not self.fid_pool))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool``: ``"avg"`` (torchvision), ``"fid_avg"`` (``Mixed_7b`` of the FID trunk:
    ``count_include_pad=False``) or ``"max"`` (its ``Mixed_7c``: the TF implementation's
    max pool, kept so converted weights reproduce the scores)."""

    def __init__(self, in_channels: int, pool: str = "avg") -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)  # pads with -inf
        else:
            bp = _avg_pool(x, count_include_pad=self.pool == "avg")
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionAux(nn.Module):
    """torchvision's auxiliary head: carried so its state dict loads, never run."""

    def __init__(self, in_channels: int, num_classes: int) -> None:
        super().__init__()
        self.conv0 = BasicConv2d(in_channels, 128, kernel_size=1)
        self.conv1 = BasicConv2d(128, 768, kernel_size=5)
        self.fc = nn.Linear(768, num_classes)


class _Trunk(nn.Module):
    """The stem and the eleven mixed blocks, with the FID pooling variants or not."""

    def __init__(self, fid: bool) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32, fid_pool=fid)
        self.Mixed_5c = InceptionA(256, 64, fid_pool=fid)
        self.Mixed_5d = InceptionA(288, 64, fid_pool=fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid_pool=fid)
        self.Mixed_6c = InceptionC(768, 160, fid_pool=fid)
        self.Mixed_6d = InceptionC(768, 160, fid_pool=fid)
        self.Mixed_6e = InceptionC(768, 192, fid_pool=fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="fid_avg" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, pool="max" if fid else "avg")

    def _taps(self, x: torch.Tensor, need: Sequence[str]) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        if "64" in need:
            out["64"] = x.mean(dim=(2, 3))
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        if "192" in need:
            out["192"] = x.mean(dim=(2, 3))
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6e(self.Mixed_6d(self.Mixed_6c(self.Mixed_6b(self.Mixed_6a(x)))))
        if "768" in need:
            out["768"] = x.mean(dim=(2, 3))
        out["2048"] = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x))).mean(dim=(2, 3))
        return out


class InceptionV3(_Trunk):
    """torchvision's InceptionV3 trunk: NCHW or NHWC, uint8 or float images -> (N, 2048).

    Integer images are divided by 255, then ``2x - 1`` (torchvision's
    ``transform_input=False`` path). ``AuxLogits`` and ``fc`` are carried so a torchvision
    state dict loads as it is; neither runs.
    """

    def __init__(self) -> None:
        super().__init__(fid=False)
        self.AuxLogits = InceptionAux(768, 1000)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"Expected 4d image batch, got shape {tuple(x.shape)}")
        x = to_nchw(x)
        if not x.is_floating_point():
            x = x.to(torch.float32) / 255.0
        return self._taps(x * 2.0 - 1.0, ())["2048"]


class FIDInceptionV3(_Trunk):
    """torch-fidelity's "inception-v3-compat" trunk: ``forward(x, request)`` maps NCHW or
    NHWC images (any dtype, values in [0, 255]) to a dict of the requested taps."""

    def __init__(self) -> None:
        super().__init__(fid=True)
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor, request: Sequence[str] = ("2048",)) -> Dict[str, torch.Tensor]:
        if x.ndim != 4:
            raise ValueError(f"Expected 4d image batch, got shape {tuple(x.shape)}")
        x = to_nchw(x).to(torch.float32)
        x = (tf1_bilinear_resize(x, (299, 299)) - 128.0) / 128.0
        out = self._taps(x, request)
        if "logits_unbiased" in request or "logits" in request:
            unbiased = out["2048"] @ self.fc.weight.T
            out["logits_unbiased"] = unbiased
            out["logits"] = unbiased + self.fc.bias
        return {t: out[t] for t in request}


_RESIZE: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _tf1_resize_matrix(in_size: int, out_size: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """The ``(out, in)`` float32 interpolation matrix of one axis, made on ``device`` by
    device operations (no host copy) and cached per (in, out, device)."""
    device = torch.device("cpu" if device is None else device)
    key = (in_size, out_size, device)
    m = _RESIZE.get(key)
    if m is None:
        src = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
        x0 = src.floor().to(torch.int64).clamp(0, in_size - 1)
        x1 = (x0 + 1).clamp(max=in_size - 1)
        frac = src - x0.to(torch.float32)
        m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
        m.scatter_add_(1, x0[:, None], (1.0 - frac)[:, None])
        m.scatter_add_(1, x1[:, None], frac[:, None])
        m = _RESIZE.setdefault(key, m)
    return m


def tf1_bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` with TF1 ``align_corners=False`` semantics
    (``src = dst * in / out``, no half-pixel offset), as two matmuls: rows, then columns."""
    mh = _tf1_resize_matrix(x.shape[-2], out_hw[0], x.device)
    mw = _tf1_resize_matrix(x.shape[-1], out_hw[1], x.device)
    return torch.matmul(torch.matmul(mh, x), mw.T)


_STEM = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
_BLOCK_CONVS: Dict[str, Sequence[str]] = {
    "Mixed_5b": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "Mixed_6b": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7b": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"],
}
_BLOCK_ALIASES = {
    "Mixed_5c": "Mixed_5b",
    "Mixed_5d": "Mixed_5b",
    "Mixed_6c": "Mixed_6b",
    "Mixed_6d": "Mixed_6b",
    "Mixed_6e": "Mixed_6b",
    "Mixed_7c": "Mixed_7b",
}
_ALL_BLOCKS = ["Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"]
_BN = {"weight": "scale", "bias": "bias"}
_BN_STATS = {"running_mean": "mean", "running_var": "var"}


def _basic_convs():
    """``(prefix, path)`` of every ``BasicConv2d``: its torchvision key prefix and its
    path in the flax tree."""
    for name in _STEM:
        yield name, (name,)
    for block in _ALL_BLOCKS:
        for conv in _BLOCK_CONVS[_BLOCK_ALIASES.get(block, block)]:
            yield f"{block}.{conv}", (block, conv)


def _trunk_keys():
    for prefix, _ in _basic_convs():
        yield f"{prefix}.conv.weight"
        for k in (*_BN, *_BN_STATS):
            yield f"{prefix}.bn.{k}"


def from_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state dict (tensors or arrays) as the port's trunk
    tensors, float32 on the CPU; the aux head, ``fc`` and ``num_batches_tracked`` are
    left out."""
    return tensors(state_dict, _trunk_keys())


def from_fidelity_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch-fidelity ``pt_inception-2015-12-05`` state dict as the port's tensors: the
    trunk, plus the 1008-way ``fc`` when present."""
    out = from_torch_state_dict(state_dict)
    if "fc.weight" in state_dict:
        out.update(tensors(state_dict, ("fc.weight", "fc.bias")))
    return out


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``InceptionV3`` / ``FIDInceptionV3`` flax variables (numpy or
    jax leaves) as the port's state dict: HWIO kernels to OIHW, batch norm ``scale`` /
    ``bias`` / ``mean`` / ``var`` to ``weight`` / ``bias`` / ``running_mean`` /
    ``running_var``, ``fc_kernel`` transposed into ``fc.weight`` and ``fc_bias`` into
    ``fc.bias``. A tree without ``fc_*`` leaves ``fc`` as the trunk has it."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for prefix, path in _basic_convs():
        p, s = params, stats
        for part in path:
            p, s = p[part], s[part]
        out.update(conv_from_flax(p["conv"], f"{prefix}.conv"))
        for k, flax_k in _BN.items():
            out[f"{prefix}.bn.{k}"] = to_float32(p["bn"][flax_k])
        for k, flax_k in _BN_STATS.items():
            out[f"{prefix}.bn.{k}"] = to_float32(s["bn"][flax_k])
    if "fc_kernel" in params:
        out["fc.weight"] = to_float32(params["fc_kernel"]).T.contiguous()
        out["fc.bias"] = to_float32(params["fc_bias"])
    return out


class FIDExtractor(SharedTrunk):
    """The ``imgs -> features`` callable that FID, KID and IS hold: a frozen
    ``FIDInceptionV3`` run in ``eval`` mode under ``torch.no_grad()``, its float32
    convolutions and matmuls at full float32 (the caller's TF32 flags come back after).
    Shared, not copied (``models/_common.SharedTrunk``): a default trunk comes from one
    cache per (taps, device), a trunk with weights moves as a copy.
    """

    def __init__(self, model: FIDInceptionV3, taps: Tuple[str, ...], single: bool, default: bool = False) -> None:
        self.model = model
        self.taps = taps
        self.single = single
        self.default = default

    @property
    def device(self) -> torch.device:
        return self.model.fc.weight.device

    def __call__(self, imgs: torch.Tensor) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        with torch.no_grad(), full_float32():
            out = self.model(imgs, self.taps)
        return out[self.taps[0]] if self.single else tuple(out[t] for t in self.taps)

    def _cache_entry(self, device: str) -> Optional[Tuple[Callable[..., Any], tuple]]:
        return (_default_fid_extractor, (self.taps, device)) if self.default else None

    def _moved(self, device: torch.device) -> "FIDExtractor":
        return FIDExtractor(moved(self.model, device), self.taps, self.single)

    def _fields(self) -> tuple:
        return (self.model, self.taps, self.single)


def _fid_model(state: Mapping[str, torch.Tensor], taps: Sequence[str], device: Any) -> FIDInceptionV3:
    """A ``FIDInceptionV3`` holding ``state``; ``fc`` may be missing unless logits are asked."""
    needs_fc = "logits" in taps or "logits_unbiased" in taps
    model = default_trunk(FIDInceptionV3, "cpu")
    return frozen(load_trunk(model, state, optional=() if needs_fc else ("fc.",)), device)


def fid_inception_v3_extractor(
    request: Union[str, Sequence[str]] = "2048",
    state_dict: Optional[Mapping[str, Any]] = None,
    variables: Optional[Mapping[str, Any]] = None,
    allow_random: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> FIDExtractor:
    """Build the torch-fidelity-compat ``imgs -> (N, d)`` callable for FID / KID / IS.

    ``request`` is one tap name or a sequence of them (a single name returns that tensor;
    a sequence returns a tuple in order). Without ``state_dict`` / ``variables`` this
    RAISES unless ``allow_random=True``: a random trunk gives plausible-looking but
    non-canonical scores. With the opt-in, the trunk is the port's own deterministic
    random init (one per (taps, device), shared), and it warns. ``state_dict`` is a
    torch-fidelity ``pt_inception-2015-12-05`` checkpoint; ``variables`` the JAX
    package's flax variables. ``device``: ``None`` means the card.
    """
    single = isinstance(request, str)
    taps = (request,) if single else tuple(request)
    if not set(taps) <= set(TAPS):
        raise ValueError(f"Requested taps {taps} must be a subset of {sorted(TAPS)}")
    if variables is None and state_dict is None:
        if not allow_random:
            raise RuntimeError(
                "No pretrained InceptionV3 weights were supplied and none are bundled (zero-egress"
                " environment), so FID/KID/IS scores would come from a randomly-initialised trunk —"
                " plausible-looking but meaningless. Pass `state_dict=` (a torch-fidelity"
                " pt_inception-2015-12-05 checkpoint, converted via `from_fidelity_state_dict`) or"
                " `variables=` for canonical scores, or opt in to the random trunk explicitly with"
                " `allow_random_features=True` (metric constructors) / `allow_random=True` (this builder)."
            )
        rank_zero_warn(
            "Using a deterministic randomly-initialised FID-compat trunk (`allow_random=True`): scores"
            " are self-consistent but NOT comparable to canonical FID/KID/IS values."
        )
        return _default_fid_extractor(taps, device_key(device))
    state = state_dict_from_flax(variables) if variables is not None else from_fidelity_state_dict(state_dict)
    return FIDExtractor(_fid_model(state, taps, device), taps, single)


@lru_cache(maxsize=None)
def _default_fid_extractor(taps: Tuple[str, ...], device: str) -> FIDExtractor:
    """One seeded trunk per (taps, device): FID, KID and IS with default arguments share it."""
    return FIDExtractor(default_trunk(FIDInceptionV3, device), taps, len(taps) == 1, default=True)


def inception_v3_extractor(
    state_dict: Optional[Mapping[str, Any]] = None,
    variables: Optional[Mapping[str, Any]] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
):
    """Build the torchvision ``imgs -> (N, 2048)`` callable. ``state_dict``: a torchvision
    ``inception_v3`` checkpoint; ``variables``: the JAX package's flax variables; neither:
    the port's seeded random init (real shapes, meaningless values). Integer images keep
    their dtype (the trunk divides them by 255); float images are cast to ``dtype``."""
    model = default_trunk(InceptionV3, "cpu")
    if variables is not None:
        load_trunk(model, state_dict_from_flax(variables), optional=("fc.", "AuxLogits."))
    elif state_dict is not None:
        load_trunk(model, from_torch_state_dict(state_dict), optional=("fc.", "AuxLogits."))
    model = frozen(model, device)

    def apply(imgs: torch.Tensor) -> torch.Tensor:
        if imgs.is_floating_point():
            imgs = imgs.to(dtype)
        with torch.no_grad(), full_float32():
            return model(imgs)

    return apply
