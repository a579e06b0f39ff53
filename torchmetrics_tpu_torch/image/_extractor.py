"""Pluggable feature-extractor resolution for the model-backed image metrics
(counterpart of ``torchmetrics_tpu/image/_extractor.py``).

An integer or string ``feature`` (64 / 192 / 768 / 2048 / ``'logits_unbiased'`` /
``'logits'``) builds the FID-compat InceptionV3 trunk (``models/inception.py``) on the
metric's device. No weights are bundled: the builder RAISES unless the caller opts in
with ``allow_random_features=True``, and then the trunk is the port's own seeded random
init (shared per (taps, device)) and it warns. Any callable ``imgs -> (N, d)`` is
accepted as a custom extractor; its width is probed on the metric's device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.models._common import moved

_FID_TAP_DIMS = {"64": 64, "192": 192, "768": 768, "2048": 2048, "logits_unbiased": 1008, "logits": 1008}


def resolve_feature_extractor(
    feature: Union[int, str, Callable],
    num_features: Optional[int] = None,
    probe_shape: Tuple[int, ...] = (1, 3, 299, 299),
    allow_random_features: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Callable, int]:
    """Return ``(extractor, num_features)`` for a pluggable ``feature`` argument.

    Args:
        feature: one of the integer / string taps (builds the FID-compat trunk on
            ``device``), or a callable ``imgs -> (N, d)``.
        num_features: feature width; for a callable probed with a zero uint8 batch of
            ``probe_shape`` on ``device`` when ``None``.
        probe_shape: shape of that probe.
        allow_random_features: opt-in for the seeded random trunk; without it the builder
            raises.
        device: the metric's device (``None``: the card).
    """
    if isinstance(feature, (int, str)):
        tap = str(feature)
        if tap not in _FID_TAP_DIMS:
            raise ValueError(
                f"Integer/str input to argument `feature` must be one of {sorted(_FID_TAP_DIMS)}, got {feature!r}"
            )
        from torchmetrics_tpu_torch.models.inception import fid_inception_v3_extractor

        return fid_inception_v3_extractor(tap, allow_random=allow_random_features, device=device), _FID_TAP_DIMS[tap]
    if not callable(feature):
        raise TypeError("Got unknown input to argument `feature`")
    if num_features is None:
        probe = torch.zeros(probe_shape, dtype=torch.uint8, device=device)
        num_features = int(feature(probe).shape[-1])
    return feature, num_features


class ExtractorFollowsDevice:
    """Mixin for a metric holding a network in the attribute ``_follows_device`` names
    (``inception`` by default): ``to`` / ``cpu`` move it with the states (``Metric.to``
    moves states only; the network is not a submodule) through
    ``models/_common.moved``, which never moves a shared network in place."""

    _follows_device: str = "inception"

    def to(self, device: Union[str, torch.device]) -> Any:
        super().to(device)  # type: ignore[misc]
        setattr(self, self._follows_device, moved(getattr(self, self._follows_device), self.device))  # type: ignore[attr-defined]
        return self
