"""What the feature trunks share: the port's own deterministic init, full-float32
inference, the layout rule and the flax-variable conversions.

The JAX package initialises a trunk with flax's ``model.init(PRNGKey(0), ...)``. The port
does not reproduce flax's draws: a default trunk is built on the ``meta`` device (no
draw from the global generator), given storage on the CPU, filled from a
``torch.Generator`` seeded 0 and only then moved, so the card and the CPU hold the same
weights. Convolutions draw He-normal weights (variance 2 / fan-in: activations stay
O(1) through a ReLU stack), linear layers variance 1 / fan-in, biases zero, batch norms
the identity (weight 1, bias 0, mean 0, variance 1).
"""

from __future__ import annotations

import copy
import itertools
import math
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchmetrics_tpu_torch.metric import resolve_device


def seeded_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer of ``module`` (on the CPU) from a generator
    seeded ``seed``, in ``modules()`` order."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * math.sqrt(gain / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def default_trunk(make: Callable[[], nn.Module], device: Union[str, torch.device, None]) -> nn.Module:
    """``make()`` built without a draw from the global generator, filled by
    ``seeded_init`` on the CPU, frozen in ``eval`` mode and moved to ``device``."""
    with torch.device("meta"):
        module = make()
    return frozen(seeded_init(module.to_empty(device="cpu")), device)


@contextmanager
def full_float32() -> Iterator[None]:
    """Float32 convolutions and matmuls at full float32 (no TF32) for the block; the
    caller's flags come back afterwards."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW as it is; anything else is read as NHWC (the JAX trunks' rule: NCHW when
    dim 1 holds 3 channels and the last dim does not)."""
    if x.shape[1] == 3 and x.shape[-1] != 3:
        return x
    return x.permute(0, 3, 1, 2)


def to_float32(value: Any) -> torch.Tensor:
    """A tensor or array as a float32 CPU tensor (a copy)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def conv_from_flax(leaf: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A flax ``nn.Conv`` leaf (HWIO ``kernel``, optional ``bias``) as ``prefix.weight``
    (OIHW) and ``prefix.bias``."""
    out = {f"{prefix}.weight": to_float32(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()}
    if "bias" in leaf:
        out[f"{prefix}.bias"] = to_float32(leaf["bias"])
    return out


def tensors(state_dict: Mapping[str, Any], keys: Any) -> Dict[str, torch.Tensor]:
    """``state_dict``'s entries under ``keys`` (tensors or arrays) as float32 CPU tensors."""
    return {k: to_float32(state_dict[k]) for k in keys}


def features_prefix(state_dict: Mapping[str, Any]) -> str:
    """``"features."`` when the keys carry torchvision's ``features.`` prefix, else ``""``."""
    return "features." if any(k.startswith("features.") for k in state_dict) else ""


def load_trunk(module: nn.Module, state: Mapping[str, torch.Tensor], optional: Tuple[str, ...] = ()) -> nn.Module:
    """Load ``state`` into ``module``; only keys starting with one of ``optional`` (and
    batch norms' ``num_batches_tracked``) may be missing."""
    missing, unexpected = module.load_state_dict(dict(state), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked") and not k.startswith(optional)]
    if missing or unexpected:
        raise KeyError(f"state dict does not match the trunk: missing {missing}, unexpected {unexpected}")
    return module


def device_key(device: Union[str, torch.device, None]) -> str:
    """The cache key of a device (``None``: the card): ``"cuda"`` and ``"cuda:<current>"``
    name the same card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def frozen(module: nn.Module, device: Optional[Union[str, torch.device]]) -> nn.Module:
    """``module`` in ``eval`` mode, without parameter gradients, on ``device``."""
    return module.eval().requires_grad_(False).to(resolve_device(device))


def moved(obj: Any, device: Union[str, torch.device]) -> Any:
    """``obj`` on ``device``, never moved in place: a module not already there is copied
    and the copy moved; another object with ``to`` gives what its ``to`` returns; a plain
    function stays as it is."""
    if isinstance(obj, nn.Module):
        first = next(itertools.chain(obj.parameters(), obj.buffers()), None)
        if first is None or device_key(first.device) == device_key(device):
            return obj
        return copy.deepcopy(obj).to(resolve_device(device))
    to = getattr(obj, "to", None)
    return obj if to is None else to(device)


class SharedTrunk:
    """A frozen network that metrics share, not copy: ``deepcopy`` returns the same
    object. A default one (the port's seeded init) lives in a cache per (key, device):
    ``to`` returns the new device's cached one and a pickle rebuilds it from that cache.
    Any other one is never moved in place: ``to`` returns a moved copy, so a clone moved
    elsewhere leaves the metric it was cloned from as it was.

    A subclass says where its defaults come from (``_cache_entry``), how it moves
    (``_moved``), what rebuilds it (``_fields``) and where it lives (``device``).
    """

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def _cache_entry(self, device: str) -> Optional[Tuple[Callable[..., Any], tuple]]:
        """``(cache, args)`` giving this default trunk on ``device``; None for any other."""
        raise NotImplementedError

    def _moved(self, device: torch.device) -> "SharedTrunk":
        raise NotImplementedError

    def _fields(self) -> tuple:
        raise NotImplementedError

    def to(self, device: Union[str, torch.device]) -> "SharedTrunk":
        entry = self._cache_entry(device_key(device))
        if entry is not None:
            cache, args = entry
            return cache(*args)
        return self._moved(resolve_device(device))

    def __deepcopy__(self, memo: dict) -> "SharedTrunk":
        return self

    def __reduce__(self) -> tuple:
        entry = self._cache_entry(device_key(self.device))
        return entry if entry is not None else (type(self), self._fields())
