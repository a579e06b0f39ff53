"""Fréchet Inception Distance (counterpart of ``torchmetrics_tpu/image/fid.py``).

- Streaming float64 sum / Σxxᵀ / count states per stream, summed across processes.
- The update is **row-additive and branchless**: the real / fake flag selects with
  ``torch.where``, so a 0-d tensor flag replays one captured graph for both streams and
  a ragged tail rides the engine's shape buckets (``_engine_row_additive``). A Python
  bool runs the same body eagerly (``non-tensor-input``), as in the JAX engine. The
  extractor must map each image independently: that is what the declaration asserts.
  A zero pad row's features are not zero, so the pad-subtract identity holds up to
  float64 rounding there, and float32 features may differ with the batch size (other
  convolution algorithms). A batch that fills its bucket takes a graph of its exact
  shape: with the 0-d flag the pad rows' unit would be one more trunk forward in every
  replay (``engine/compiled.py``), and there is nothing to subtract; it is bit-equal to
  the eager update.
- ``trace(sqrtm(Σ₁Σ₂))`` by two symmetric eigendecompositions on the device, in float64:
  for PSD Σ₁, Σ₂ the eigenvalues of Σ₁Σ₂ are those of Σ₁^½ Σ₂ Σ₁^½. (The JAX package's
  ``TORCHMETRICS_TPU_FID_HOST_EIGH`` host route works round a TPU fault; CUDA has none,
  and the port reads no such knob.)
- The <2-sample guard reads both counts in one transfer in the ``_engine_compute``
  hook; the compute then runs eagerly (``eigh`` reads its status on the host on CUDA,
  so no graph holds it), where the JAX package caches it as one executable.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.image._extractor import ExtractorFollowsDevice, resolve_feature_extractor
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel.sharding import local_rows


def _compute_fid(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    """d² = ‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2√(Σ₁Σ₂)) on the device."""
    a = ((mu1 - mu2) ** 2).sum(dim=-1)
    b = torch.trace(sigma1) + torch.trace(sigma2)
    w1, v1 = torch.linalg.eigh(sigma1)
    s1_half = (v1 * w1.clamp(min=0.0).sqrt()) @ v1.T
    eig = torch.linalg.eigvalsh(s1_half @ sigma2 @ s1_half)
    c = eig.clamp(min=0.0).sqrt().sum(dim=-1)
    return a + b - 2 * c


class _DtypeSeen:
    """The extractor's output dtype, noted by every update. A holder, not an attribute:
    an engine step may not rebind a non-state attribute, and the note must survive a
    graph's first step; it is copied with the metric."""

    __slots__ = ("dtype",)

    def __init__(self) -> None:
        self.dtype: Optional[torch.dtype] = None


class FrechetInceptionDistance(ExtractorFollowsDevice, Metric):
    """FID with streaming covariance states.

    Args:
        feature: an integer / string tap of the FID-compat trunk, or a callable
            ``imgs -> (N, d)`` (see ``image/_extractor.py``).
        reset_real_features: whether ``reset`` clears the real-distribution states.
        normalize: if True, float [0, 1] inputs are scaled to [0, 255] uint8 first.
        num_features: feature width; probed from a zero batch when ``None``.
        allow_random_features: opt in to the seeded random trunk (no weights are bundled).

    Pass ``real`` as a 0-d tensor on the metric's device to replay the captured update;
    a Python bool runs the same branchless body eagerly.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> proj = torch.randn(3 * 8 * 8, 16, generator=torch.Generator().manual_seed(0))
        >>> fid = FrechetInceptionDistance(lambda x: x.float().flatten(1) @ proj, num_features=16, device="cpu")
        >>> gen = torch.Generator().manual_seed(1)
        >>> fid.update(torch.randint(0, 200, (40, 3, 8, 8), dtype=torch.uint8, generator=gen), real=True)
        >>> fid.update(torch.randint(50, 255, (40, 3, 8, 8), dtype=torch.uint8, generator=gen), real=False)
        >>> float(fid.compute()) > 0
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    # every state sums over the batch's rows: the pad-subtract identity holds, provided
    # the extractor maps each image independently
    _engine_row_additive: bool = True
    # placement (parallel/sharding.py): the (d, d) covariance sums split their rows over
    # the state mesh; each rank forms only its rows of the batch's product
    _engine_shard_rules = {
        "real_features_cov_sum": "row_sharded",
        "fake_features_cov_sum": "row_sharded",
    }

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        allow_random_features: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, num_features = resolve_feature_extractor(
            feature, num_features, allow_random_features=allow_random_features, device=self.device
        )
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.num_features = num_features
        self._seen = _DtypeSeen()

        mx = (num_features, num_features)
        for side in ("real", "fake"):
            self.add_state(f"{side}_features_sum", torch.zeros(num_features, dtype=torch.float64), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", torch.zeros(mx, dtype=torch.float64), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", 0, dist_reduce_fx="sum")

    @property
    def orig_dtype(self) -> Optional[torch.dtype]:
        """The extractor's output dtype, which ``compute`` returns (None before an update)."""
        return self._seen.dtype

    def update(self, imgs: torch.Tensor, real: Union[bool, torch.Tensor]) -> None:
        """Extract features and fold them into the streaming moments of the side ``real``
        selects; the other side is selected unchanged (a non-finite batch cannot leak
        into it)."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        features = self.inception(imgs)
        self._seen.dtype = features.dtype
        features = features.to(torch.float64)
        if features.ndim == 1:
            features = features[None, :]
        n = features.shape[0]
        fsum = features.sum(dim=0)
        rows = local_rows(self, "real_features_cov_sum")
        fcov = (features.T if rows is None else features[:, rows[0] : rows[1]].T) @ features
        r = torch.as_tensor(real, device=features.device)
        cnt = self.real_features_num_samples.dtype
        self.real_features_sum = torch.where(r, self.real_features_sum + fsum, self.real_features_sum)
        self.real_features_cov_sum = torch.where(r, self.real_features_cov_sum + fcov, self.real_features_cov_sum)
        self.real_features_num_samples = self.real_features_num_samples + r.to(cnt) * n
        self.fake_features_sum = torch.where(r, self.fake_features_sum, self.fake_features_sum + fsum)
        self.fake_features_cov_sum = torch.where(r, self.fake_features_cov_sum, self.fake_features_cov_sum + fcov)
        self.fake_features_num_samples = self.fake_features_num_samples + (~r).to(cnt) * n

    def _epoch_sync_for_compute(self) -> None:
        """Decline the fused sync-and-compute: it returns a value without entering
        ``_engine_compute``, which would skip the <2-sample guard. The packed sync still
        runs through ``sync_context`` and the guard reads the synced counts."""
        return None

    def _engine_compute(self, compute: Callable, args: tuple, kwargs: dict) -> Any:
        """The <2-sample guard (one read of both counts), then the compute, eagerly: on
        CUDA ``torch.linalg.eigh`` reads its solver's status on the host inside the
        operation, which a captured graph cannot hold (the engine's guard sees only the
        operation), so the epoch engine never captures it."""
        from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

        with transfer_allowed("fid-sample-guard"):
            n_real, n_fake = torch.stack([self.real_features_num_samples, self.fake_features_num_samples]).tolist()
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        return compute(*args, **kwargs)

    def compute(self) -> torch.Tensor:
        """FID between the two accumulated gaussians, in the extractor's dtype."""
        n_real = self.real_features_num_samples
        n_fake = self.fake_features_num_samples
        mean_real = (self.real_features_sum / n_real)[None, :]
        mean_fake = (self.fake_features_sum / n_fake)[None, :]
        cov_real = (self.real_features_cov_sum - n_real * (mean_real.T @ mean_real)) / (n_real - 1)
        cov_fake = (self.fake_features_cov_sum - n_fake * (mean_fake.T @ mean_fake)) / (n_fake - 1)
        out = _compute_fid(mean_real.squeeze(0), cov_real, mean_fake.squeeze(0), cov_fake)
        return out.to(self.orig_dtype or out.dtype)

    def reset(self) -> None:
        """Reset, keeping the real-distribution statistics unless ``reset_real_features``."""
        if self.reset_real_features:
            super().reset()
            return
        kept = {k: getattr(self, k) for k in ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")}
        super().reset()
        for k, v in kept.items():
            setattr(self, k, v)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
