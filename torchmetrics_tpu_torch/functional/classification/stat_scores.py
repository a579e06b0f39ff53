"""Stat scores (tp/fp/tn/fn) for binary, multiclass and multilabel tasks, the base of
the accuracy, precision, recall and F-beta families.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``: the same
staged decomposition (arg validation -> tensor validation -> format -> update ->
compute). ``ignore_index`` is handled by masking (ignored targets become ``-1``, which
counts in none of the four counters), so shapes stay static.

Multiclass 2-D float logits with top-1 and global accumulation take kernel K1
(``ops/stat_counts.py``), one pass over the logits straight to per-class counts;
every other configuration runs the staged format and update in plain PyTorch. Binary
and multilabel float inputs that are not all in [0, 1] go through a sigmoid, chosen
on the device (``torch.where``), so with ``validate_args=False`` their updates make no
device -> host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops.stat_counts import _argmax_nan_first, stat_counts
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _is_floating
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, _sigmoid
from torchmetrics_tpu_torch.utilities.data import _bincount, _one_hot, select_topk
from torchmetrics_tpu_torch.utilities.enums import _route_task

Counts4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _sigmoid_if_logits(preds: torch.Tensor) -> torch.Tensor:
    """Sigmoid (``_sigmoid``) iff any value lies outside [0, 1]: chosen on the device,
    never read back."""
    is_probs = ((preds >= 0) & (preds <= 1)).all()
    return torch.where(is_probs, preds, _sigmoid(preds))


def _zero_rows_neutral(threshold: Optional[float], inputs) -> bool:
    """Whether a zero row counts the same inside a batch of ``inputs`` as alone (the
    engine's bucketing check). A float batch of logits is sigmoided as a whole, which
    turns the row into 0.5, a positive iff ``threshold < 0.5``; alone, 0.0 is never one.
    ``threshold=None``: no sigmoid (multiclass labels come from a per-row argmax)."""
    return threshold is None or threshold >= 0.5 or not any(a.is_floating_point() for a in inputs)


def _count_stats(preds: torch.Tensor, target: torch.Tensor, sum_dims) -> Counts4:
    """tp/fp/tn/fn int32 counters; targets masked to -1 count in none of them."""
    tp = ((target == preds) & (target == 1)).sum(dim=sum_dims, dtype=torch.int32).squeeze()
    fn = ((target != preds) & (target == 1)).sum(dim=sum_dims, dtype=torch.int32).squeeze()
    fp = ((target != preds) & (target == 0)).sum(dim=sum_dims, dtype=torch.int32).squeeze()
    tn = ((target == preds) & (target == 0)).sum(dim=sum_dims, dtype=torch.int32).squeeze()
    return tp, fp, tn, fn


def _label_values_check(values: torch.Tensor, allowed: set, what: str, hint: str) -> None:
    """Raise unless every value of ``values`` is in ``allowed`` (``torch.unique``: a host sync)."""
    unique_values = torch.unique(values).tolist()
    if not set(unique_values).issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `{what}`: {unique_values} but expected only the following values {hint}."
        )


# ------------------------------------------------------------------------------ binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Shape and value checks; the unique-value checks are device -> host syncs."""
    _check_same_shape(preds, target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    _label_values_check(target, allowed, "target", str(sorted(allowed)))
    if not _is_floating(preds):
        _label_values_check(preds, {0, 1}, "preds", "[0,1] since `preds` is a label tensor")
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be atleast 2D when multidim_average is set to `samplewise`")


def _binary_stat_scores_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """To ``(N, -1)`` labels: auto-sigmoid, threshold, flatten, ignored targets -> -1."""
    if _is_floating(preds):
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    preds = preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_stat_scores_update(preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global") -> Counts4:
    return _count_stats(preds, target, (0, 1) if multidim_average == "global" else 1)


def _binary_stat_scores_compute(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor, multidim_average: str = "global"
) -> torch.Tensor:
    """Stack [tp, fp, tn, fn, support]."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else 1).squeeze()


def _binary_stat_scores_pipeline(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Counts4:
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    return _binary_stat_scores_update(preds, target, multidim_average)


def binary_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_stat_scores
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> binary_stat_scores(preds, torch.tensor([1, 0, 1, 1, 0, 0])).tolist()
        [2, 1, 2, 1, 3]
    """
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# --------------------------------------------------------------------------- multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Shape and value checks; counting unique values is a device -> host sync."""
    if preds.ndim == target.ndim + 1:
        if not _is_floating(preds):
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should "
                " atleast 3D when multidim_average is set to `samplewise`"
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={preds.shape} and `target` with shape={target.shape}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError(
                "When `preds` and `target` have the same shape, the shape of `preds` should "
                " atleast 2D when multidim_average is set to `samplewise`"
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    num_unique_values = torch.unique(target).numel()
    check = num_unique_values > num_classes if ignore_index is None else num_unique_values > num_classes + 1
    if check:
        raise RuntimeError(
            "Detected more unique values in `target` than `num_classes`. Expected only"
            f" {num_classes if ignore_index is None else num_classes + 1} but found"
            f" {num_unique_values} in `target`."
        )
    if not _is_floating(preds):
        num_unique_preds = torch.unique(preds).numel()
        if num_unique_preds > num_classes:
            raise RuntimeError(
                "Detected more unique values in `preds` than `num_classes`. Expected only"
                f" {num_classes} but found {num_unique_preds} in `preds`."
            )


def _multiclass_stat_scores_format(
    preds: torch.Tensor, target: torch.Tensor, top_k: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax logits (when top_k == 1, with K1's tie and NaN rule) and flatten extra dims."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = _argmax_nan_first(preds)
    preds = preds.reshape(*preds.shape[:2], -1) if top_k != 1 else preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Counts4:
    """tp/fp/tn/fn from formatted labels: samplewise or top-k one-hot, micro, or per class."""
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index

    if multidim_average == "samplewise" or top_k != 1:
        if top_k > 1:
            preds_oh = torch.movedim(select_topk(preds, topk=top_k, dim=1), 1, -1)
        else:
            preds_oh = _one_hot(preds.clamp(0, num_classes - 1), num_classes)
            # out-of-range predictions one-hot to nothing
            pred_valid = (preds >= 0) & (preds < num_classes)
            preds_oh = preds_oh * pred_valid[..., None].to(torch.int32)
        target_oh = _one_hot(target.clamp(0, num_classes - 1), num_classes)
        # ignored rows -> -1: matches neither ==1 nor ==0 in any counter
        target_oh = torch.where(valid[..., None], target_oh, -1)
        sum_dims = (0, 1) if multidim_average == "global" else (1,)
        tp = ((target_oh == preds_oh) & (target_oh == 1)).sum(dim=sum_dims, dtype=torch.int32)
        fn = ((target_oh != preds_oh) & (target_oh == 1)).sum(dim=sum_dims, dtype=torch.int32)
        fp = ((target_oh != preds_oh) & (target_oh == 0)).sum(dim=sum_dims, dtype=torch.int32)
        tn = ((target_oh == preds_oh) & (target_oh == 0)).sum(dim=sum_dims, dtype=torch.int32)
        return tp, fp, tn, fn

    preds = preds.flatten()
    target = target.flatten()
    valid = valid.flatten()
    if average == "micro":
        n_valid = valid.sum(dtype=torch.int32)
        tp = ((preds == target) & valid).sum(dtype=torch.int32)
        fp = n_valid - tp
        fn = n_valid - tp
        tn = num_classes * n_valid - (fp + fn + tp)
        return tp, fp, tn, fn

    # per class from the confusion matrix; rows with an invalid target or prediction go
    # to _bincount's dropped bin (a boolean index would be a nonzero: a host sync)
    keep = valid & (target >= 0) & (target < num_classes) & (preds >= 0) & (preds < num_classes)
    mapping = torch.where(keep, target.long() * num_classes + preds.long(), -1)
    confmat = _bincount(mapping, minlength=num_classes * num_classes).reshape(num_classes, num_classes)
    tp = confmat.diagonal()
    fp = confmat.sum(dim=0, dtype=torch.int32) - tp
    fn = confmat.sum(dim=1, dtype=torch.int32) - tp
    tn = confmat.sum(dtype=torch.int32) - (fp + fn + tp)
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Optional[torch.Tensor]:
    """Stack [tp, fp, tn, fn, support] and apply the average."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(dim=sum_dim) if res.ndim > 1 else res
    if average == "macro":
        return res.to(torch.float32).mean(dim=sum_dim)
    if average == "weighted":
        weight = (tp + fn).to(torch.float32)
        if multidim_average == "global":
            return (res * _safe_divide(weight, weight.sum()).reshape(*weight.shape, 1)).sum(dim=sum_dim)
        return (res * _safe_divide(weight, weight.sum(-1, keepdim=True)).reshape(*weight.shape, 1)).sum(dim=sum_dim)
    if average is None or average == "none":
        return res
    return None


def _fused_supported(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, top_k: int, multidim_average: str
) -> bool:
    """K1's gate: 2-D float logits of width ``num_classes``, top-1, global accumulation."""
    return (
        top_k == 1
        and multidim_average == "global"
        and preds.ndim == 2
        and target.ndim == 1
        and preds.is_floating_point()
        and preds.shape[1] == num_classes
    )


def fused_multiclass_stat_scores(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Counts4:
    """Single-pass (tp, fp, tn, fn), each ``(C,)`` int32, from raw logits (kernel K1)."""
    if target.dtype not in (torch.int32, torch.int64):
        target = target.long()
    tp, pred_count, tgt_count = stat_counts(preds.contiguous(), target.contiguous(), num_classes, ignore_index)
    fp = pred_count - tp
    fn = tgt_count - tp
    tn = tgt_count.sum(dtype=torch.int32) - (tp + fp + fn)
    return tp, fp, tn, fn


def _multiclass_stat_scores_format_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    top_k: int,
    average: Optional[str],
    multidim_average: str,
    ignore_index: Optional[int],
) -> Counts4:
    """Fused format + update: K1 where its gate admits the inputs, else the staged stages.

    Micro averaging sums the per-class counts, which equals the direct micro counters.
    """
    if _fused_supported(preds, target, num_classes, top_k, multidim_average):
        tp, fp, tn, fn = fused_multiclass_stat_scores(preds, target, num_classes, ignore_index)
        if average == "micro":
            return tuple(x.sum(dtype=torch.int32) for x in (tp, fp, tn, fn))  # type: ignore[return-value]
        return tp, fp, tn, fn
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    return _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)


def _multiclass_stat_scores_pipeline(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str],
    top_k: int,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Counts4:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    return _multiclass_stat_scores_format_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )


def multiclass_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for multiclass tasks."""
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# --------------------------------------------------------------------------- multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    """Shape and value checks; the unique-value checks are device -> host syncs."""
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    _label_values_check(target, allowed, "target", str(sorted(allowed)))
    if not _is_floating(preds):
        _label_values_check(preds, {0, 1}, "preds", "[0,1] since preds is a label tensor")
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be atleast 3D when multidim_average is set to `samplewise`")


def _multilabel_stat_scores_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """To ``(N, L, -1)`` labels: auto-sigmoid, threshold, ignored targets -> -1."""
    if _is_floating(preds):
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    preds = preds.reshape(*preds.shape[:2], -1)
    target = target.reshape(*target.shape[:2], -1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multilabel_stat_scores_update(
    preds: torch.Tensor, target: torch.Tensor, multidim_average: str = "global"
) -> Counts4:
    return _count_stats(preds, target, (0, -1) if multidim_average == "global" else (-1,))


def _multilabel_stat_scores_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Optional[torch.Tensor]:
    """Stack [tp, fp, tn, fn, support] per label and apply the average (weighted
    divides by the total support as it is, as the JAX package does)."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(dim=sum_dim)
    if average == "macro":
        return res.to(torch.float32).mean(dim=sum_dim)
    if average == "weighted":
        w = (tp + fn).to(torch.float32)
        return (res * (w / w.sum()).reshape(*w.shape, 1)).sum(dim=sum_dim)
    if average is None or average == "none":
        return res
    return None


def _multilabel_stat_scores_pipeline(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float,
    average: Optional[str],
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Counts4:
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_stat_scores_update(preds, target, multidim_average)


def multilabel_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """tp/fp/tn/fn/support for multilabel tasks."""
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router: ``binary_stat_scores``, ``multiclass_stat_scores`` or ``multilabel_stat_scores``."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args),
        lambda c: multiclass_stat_scores(
            preds, target, c, average, top_k, multidim_average, ignore_index, validate_args
        ),
        lambda n: multilabel_stat_scores(
            preds, target, n, threshold, average, multidim_average, ignore_index, validate_args
        ),
    )
