"""Bootstrapped confidence intervals for any metric (counterpart of
``torchmetrics_tpu/wrappers/bootstrapping.py``).

The JAX package draws each copy's row indices on the host with
``np.random.RandomState`` and copies them to the device. Here they are drawn on the
metric's device from the wrapper's ``torch.Generator`` (``_generator``, the
counterpart of ``_rng``): ``"multinomial"`` is one ``torch.randint``, with no host read;
``"poisson"`` repeats each row by a Poisson(1) count, an output sized by the data, so
each copy reads the host once per update, as many reads as the JAX package's host draws.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import apply_to_collection


def _bootstrap_sampler(
    size: int,
    sampling_strategy: str = "poisson",
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Row indices of one resample with replacement, on ``generator``'s device."""
    device = generator.device if generator is not None else torch.device("cpu")
    if sampling_strategy == "poisson":
        counts = torch.poisson(torch.ones(size, device=device), generator=generator).long()
        total = int(counts.sum())  # the one host read; given the size, repeat_interleave reads nothing
        return torch.repeat_interleave(torch.arange(size, device=device), counts, output_size=total)
    if sampling_strategy == "multinomial":
        return torch.randint(0, size, (size,), generator=generator, device=device)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(Metric):
    """Keep ``num_bootstraps`` copies of a metric, each updated on a resample of the
    batch's rows; ``compute`` gives the ``mean``, ``std`` (ddof 1), ``quantile`` and ``raw``
    values over the copies, as asked. Lives on the base metric's device unless
    ``device=`` says otherwise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import BootStrapper, MeanMetric
        >>> boot = BootStrapper(MeanMetric(device="cpu"), num_bootstraps=4)
        >>> _ = boot._generator.manual_seed(0)  # seeded for a reproducible example
        >>> boot.update(torch.tensor([1.0, 2.0, 3.0, 4.0]))
        >>> out = boot.compute()
        >>> sorted(out.keys())
        ['mean', 'std']
        >>> bool(out['std'] >= 0)
        True
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float], torch.Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._generator = torch.Generator(device=self.device)
        self._generator.seed()

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the inputs along dim 0 for each copy, then update the copy."""
        args_sizes = apply_to_collection(args, torch.Tensor, lambda x: x.shape[0])
        kwargs_sizes = apply_to_collection(kwargs, torch.Tensor, lambda x: x.shape[0])
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = next(iter(kwargs_sizes.values()))
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self.sampling_strategy, self._generator)
            if sample_idx.numel() == 0:
                continue
            new_args = apply_to_collection(args, torch.Tensor, torch.index_select, 0, sample_idx)
            new_kwargs = apply_to_collection(kwargs, torch.Tensor, torch.index_select, 0, sample_idx)
            self.metrics[idx].update(*new_args, **new_kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """``mean`` / ``std`` / ``quantile`` / ``raw`` over the copies' values."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        """Reset every copy."""
        for m in self.metrics:
            m.reset()
        super().reset()

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
