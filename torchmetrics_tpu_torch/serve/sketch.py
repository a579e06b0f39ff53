"""Fixed-memory sketch states as metric states (counterpart of
``torchmetrics_tpu/serve/sketch.py``).

- :class:`CardinalitySketch`: HyperLogLog distinct counting in ``2**p`` int32
  registers; the cross-rank merge is an elementwise ``max``, which gives the registers
  of the union stream bit for bit.
- :class:`HeavyHitters`: a count-min grid and a top-k candidate list. The grid folds
  across ranks by ``sum`` (CMS(A) + CMS(B) == CMS(A ∪ B)); the ``(ids, counts)`` pair
  folds jointly against the merged grid through the ``hh-ids`` / ``hh-counts`` roles
  its ``add_state(spec=...)`` declares, which ``parallel/packing.py`` resolves.

The hashes are the JAX package's bit for bit. Torch has few kernels for ``uint32``, so
a hash lane is carried in int64 holding a value in ``[0, 2**32)``: each step masks
with ``0xFFFFFFFF``, and each multiply by a 32-bit constant is split into its 16-bit
halves, so no product passes ``2**63``. ``jax.lax.clz`` has no torch counterpart: the
rank ``clz + 1`` comes from ``torch.frexp`` of the float64 value, exact on 32-bit
integers (a zero word gives 33). ``lax.top_k`` puts the lower index first among equal
values, and so does a stable descending sort, which ``merge_topk`` uses (``torch.topk``
fixes no tie order on the card).

Ids must be non-negative (-1 is the empty-slot sentinel in the top-k list).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.metric import Metric

__all__ = ["CardinalitySketch", "HeavyHitters", "canon_u32", "cms_query", "hash_u32"]

#: independent seed constants (odd, high-entropy) for the hash family
_SEED_INDEX = 0x9E3779B9
_SEED_RHO = 0x85EBCA6B
_CMS_SEEDS = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 lanes in ``[0, 2**32)``: the constant's 16-bit
    halves keep every product below ``2**48``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The murmur3 finalizer over uint32 lanes carried in int64 (values in
    ``[0, 2**32)``): a seeded, well-mixed 32-bit hash, bit-equal to the JAX one."""
    x = (x.to(torch.int64) & _MASK32) ^ seed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_u32_host(value: int, seed: int) -> int:
    """:func:`hash_u32` for one Python int, in host arithmetic: a scrape-path slot
    lookup dispatches nothing and reads nothing back (bit-equal to the device hash)."""
    x = (int(value) ^ seed) & _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    x ^= x >> 16
    return x


def canon_u32_host(value: int) -> int:
    """:func:`canon_u32` for one non-negative Python int (host mirror)."""
    value = int(value)
    lo = value & _MASK32
    hi = (value >> 32) & _MASK32
    return lo if hi == 0 else lo ^ hash_u32_host(hi, _SEED_INDEX)


def canon_u32(ids: torch.Tensor) -> torch.Tensor:
    """An id tensor as uint32 hash input (int64 lanes in ``[0, 2**32)``), as the JAX
    package canonicalizes it.

    64-bit integer ids fold their high word in only when it is nonzero, so any id that
    fits 32 bits hashes the same as int32 or int64. Floats hash their float32 bit
    pattern. Narrower integers wrap as a ``uint32`` cast does.
    """
    if ids.is_floating_point():
        x = ids.to(torch.float32)
        if ids.dtype == torch.float64:
            # the JAX package's (XLA's) float64 -> float32 conversion flushes a float32
            # subnormal to a zero of the same sign; torch's keeps it
            x = torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0.0, x)
        return x.view(torch.int32).to(torch.int64) & _MASK32
    if ids.dtype == torch.int64:
        lo = ids & _MASK32
        hi = (ids >> 32) & _MASK32
        return torch.where(hi == 0, lo, lo ^ hash_u32(hi, _SEED_INDEX))
    return ids.to(torch.int64) & _MASK32


def _rho(h: torch.Tensor) -> torch.Tensor:
    """``clz(h) + 1`` of a 32-bit word as int32 (33 for zero): ``frexp``'s exponent of
    the float64 value is the bit length, exactly."""
    _, exponent = torch.frexp(h.to(torch.float64))
    return (33 - exponent).to(torch.int32)


def cms_query(cms: torch.Tensor, u32: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """Point-estimate counts for hashed ids: the min over the depth rows."""
    est = None
    for d in range(depth):
        idx = hash_u32(u32, _CMS_SEEDS[d]) & (width - 1)
        row = cms[d].index_select(0, idx.reshape(-1)).reshape(idx.shape)
        est = row if est is None else torch.minimum(est, row)
    return est


def _cms_add(cms: torch.Tensor, u32: torch.Tensor, weights: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """Scatter-add ``weights`` into every depth row of the count-min grid."""
    flat = torch.cat([(hash_u32(u32, _CMS_SEEDS[d]) & (width - 1)) + d * width for d in range(depth)])
    return cms.reshape(-1).index_add(0, flat, weights.repeat(depth)).reshape(cms.shape)


def _rank_zero_fold(stacked: torch.Tensor) -> torch.Tensor:
    """The eager-sync fold of the top-k pair: keep rank 0's list. The exact joint fold
    (candidates re-estimated against the merged grid) exists on the packed plan only,
    where the merged grid is in the same fold; the eager per-state path keeps rank 0's
    list, approximate by design, as in the JAX package."""
    return stacked[0]


class CardinalitySketch(Metric):
    """HyperLogLog distinct counter in ``2**p`` int32 registers.

    ``update(ids)`` hashes every id and scatter-maxes the leading-zero rank into its
    register; ``compute()`` returns the bias-corrected estimate with the
    linear-counting small-range correction. Standard error ``1.04 / sqrt(2**p)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.serve import CardinalitySketch
        >>> sketch = CardinalitySketch(device="cpu")
        >>> sketch.update(torch.arange(1000))
        >>> bool(abs(float(sketch.compute()) - 1000) < 100)
        True
    """

    full_state_update = True
    higher_is_better = None
    is_differentiable = False

    def __init__(self, p: int = 11, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, int) and 4 <= p <= 18):
            raise ValueError(f"Expected argument `p` to be an int in [4, 18] but got {p}")
        self.p = p
        self.m = 1 << p
        self.add_state("registers", default=torch.zeros((self.m,), dtype=torch.int32), dist_reduce_fx="max")
        from torchmetrics_tpu_torch.serve import stats as _serve_stats

        _serve_stats.register_sketch(self)

    def update(self, ids: Any) -> None:
        """Fold a batch of (non-negative integer or float) ids into the registers."""
        u = canon_u32(torch.as_tensor(ids, device=self.device)).reshape(-1)
        idx = hash_u32(u, _SEED_INDEX) & (self.m - 1)
        rho = _rho(hash_u32(u, _SEED_RHO))
        self.registers = self.registers.scatter_reduce(0, idx, rho, reduce="amax", include_self=True)

    def compute(self) -> torch.Tensor:
        """Bias-corrected harmonic-mean estimate with the small-range correction."""
        regs = self.registers.to(torch.float32)
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        raw = alpha * m * m / torch.exp2(-regs).sum()
        zeros = (self.registers == 0).sum().to(torch.float32)
        linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)

    def fill_ratio(self) -> float:
        """Fraction of touched registers: the scrape-side saturation gauge."""
        from torchmetrics_tpu_torch.serve.snapshot import read_host

        regs = read_host(self, ("registers",))["registers"]
        return float((regs > 0).mean())


class HeavyHitters(Metric):
    """Count-min sketch and a top-k heavy-hitter list in fixed memory.

    ``update(ids, weights=None)`` scatter-adds every id into the ``(depth, width)``
    grid, estimates the union of the current top-k and the batch's ids against the
    updated grid, dedupes (sort, then mask every repeat) and keeps the new top-k: no
    host read, ids as data. ``compute()`` returns ``(ids, counts)``; empty slots are
    ``-1`` / ``0``. Counts are CMS estimates, over by at most ``e * N / width`` with
    probability ``1 - e**-depth``.

    Ids and counts are ``count_dtype()`` (int64): wide ids store whole and a cell
    cannot wrap negative.
    """

    full_state_update = True
    higher_is_better = None
    is_differentiable = False

    def __init__(self, k: int = 32, depth: int = 4, width: int = 2048, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(k, int) and k > 0):
            raise ValueError(f"Expected argument `k` to be a positive int but got {k}")
        if not (isinstance(depth, int) and 1 <= depth <= len(_CMS_SEEDS)):
            raise ValueError(f"Expected argument `depth` to be an int in [1, {len(_CMS_SEEDS)}] but got {depth}")
        if not (isinstance(width, int) and width >= 2 and (width & (width - 1)) == 0):
            raise ValueError(f"Expected argument `width` to be a power-of-two int >= 2 but got {width}")
        self.k = k
        self.depth = depth
        self.width = width
        from torchmetrics_tpu_torch.engine.numerics import count_dtype

        idt = count_dtype()
        # registration order matters: the packed fold estimates the pair against the
        # merged grid, so the grid comes first and the pair is adjacent
        self.add_state(
            "cms", default=torch.zeros((depth, width), dtype=idt), dist_reduce_fx="sum",
            spec={"role": "hh-grid", "dtype_policy": "count"},
        )
        self.add_state(
            "hh_ids", default=torch.full((k,), -1, dtype=idt), dist_reduce_fx=_rank_zero_fold,
            spec={"role": "hh-ids", "hh": ("cms", k, depth, width), "dtype_policy": "count"},
        )
        self.add_state(
            "hh_counts", default=torch.zeros((k,), dtype=idt), dist_reduce_fx=_rank_zero_fold,
            spec={"role": "hh-counts", "dtype_policy": "count"},
        )
        from torchmetrics_tpu_torch.serve import stats as _serve_stats

        _serve_stats.register_sketch(self)

    def update(self, ids: Any, weights: Optional[Any] = None) -> None:
        """Fold a batch of non-negative integer ids (optionally weighted) in. The grid
        hashes the same canonicalization the top-k stores (the id dtype, int64)."""
        ids_cast = torch.as_tensor(ids, device=self.device).reshape(-1).to(self.hh_ids.dtype)
        u = canon_u32(ids_cast)
        w = torch.ones_like(ids_cast, dtype=self.cms.dtype) if weights is None else torch.as_tensor(weights, device=self.device).reshape(-1).to(self.cms.dtype)
        cms = _cms_add(self.cms, u, w, self.depth, self.width)
        self.cms = cms
        self.hh_ids, self.hh_counts = merge_topk(cms, torch.cat([self.hh_ids, ids_cast]), self.k, self.depth, self.width)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The current top-k as ``(ids, counts)`` (empty slots ``-1`` / ``0``)."""
        return self.hh_ids, self.hh_counts

    def fill_ratio(self) -> float:
        """Fraction of touched count-min cells: the scrape-side saturation gauge."""
        from torchmetrics_tpu_torch.serve.snapshot import read_host

        cms = read_host(self, ("cms",))["cms"]
        return float((cms > 0).mean())


def merge_topk(cms: torch.Tensor, candidate_ids: torch.Tensor, k: int, depth: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a candidate id set, counts estimated from ``cms``.

    Fixed shapes: duplicates collapse by a stable sort and a mask on every repeat (all
    copies of one id carry the same estimate, so keeping the first is exact); ``-1``
    empties rank last; among equal estimates the lower sorted position wins, as
    ``lax.top_k`` orders. Shared by :class:`HeavyHitters`, the tenancy's spill path and
    the packed ``hh-ids`` fold.
    """
    est = cms_query(cms, canon_u32(candidate_ids), depth, width).to(cms.dtype)
    est = torch.where(candidate_ids < 0, -1, est)
    order = torch.argsort(candidate_ids, stable=True)
    sid = candidate_ids[order]
    sest = est[order]
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=sid.device), sid[1:] == sid[:-1]])
    sest = torch.where(dup, -1, sest)
    top_est, top_pos = torch.sort(sest, descending=True, stable=True)
    top_est, top_pos = top_est[:k], top_pos[:k]
    ids = torch.where(top_est >= 0, sid[top_pos], -1)
    counts = torch.clamp(top_est, min=0)
    return ids, counts
