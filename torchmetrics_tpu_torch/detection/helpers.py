"""Input validation of the detection metrics (counterpart of ``torchmetrics_tpu/detection/helpers.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

_ARRAY_TYPES = (torch.Tensor, np.ndarray)


def _input_validator(
    preds: Sequence[Dict[str, Any]], targets: Sequence[Dict[str, Any]], iou_type: str = "bbox"
) -> None:
    """Ensure the input format of ``preds`` and ``targets``: sequences of per-image dicts
    whose arrays are ``torch.Tensor`` or numpy (``segm`` also takes uncompressed RLE dicts)."""
    if iou_type == "bbox":
        item_val_name = "boxes"
    elif iou_type == "segm":
        item_val_name = "masks"
    else:
        raise Exception(f"IOU type {iou_type} is not supported")

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    for k in [item_val_name, "scores", "labels"]:
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")

    for k in [item_val_name, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    def _mask_ok(value: Any) -> bool:
        if isinstance(value, _ARRAY_TYPES):
            return True
        # segm also takes COCO-style uncompressed RLE dict sequences (the native route):
        # counts must be an integer run-length sequence, not pycocotools' compressed
        # bytes / str form
        return item_val_name == "masks" and isinstance(value, (list, tuple)) and all(
            isinstance(v, dict) and "size" in v and isinstance(v.get("counts"), (list, tuple, np.ndarray))
            for v in value
        )

    def _n(value: Any) -> int:
        return len(value) if isinstance(value, (list, tuple)) else value.shape[0]

    if any(not _mask_ok(pred[item_val_name]) for pred in preds):
        raise ValueError(f"Expected all {item_val_name} in `preds` to be of type Array")
    if any(not isinstance(pred["scores"], _ARRAY_TYPES) for pred in preds):
        raise ValueError("Expected all scores in `preds` to be of type Array")
    if any(not isinstance(pred["labels"], _ARRAY_TYPES) for pred in preds):
        raise ValueError("Expected all labels in `preds` to be of type Array")
    if any(not _mask_ok(target[item_val_name]) for target in targets):
        raise ValueError(f"Expected all {item_val_name} in `target` to be of type Array")
    if any(not isinstance(target["labels"], _ARRAY_TYPES) for target in targets):
        raise ValueError("Expected all labels in `target` to be of type Array")

    for i, item in enumerate(targets):
        if _n(item[item_val_name]) != item["labels"].shape[0]:
            raise ValueError(
                f"Input {item_val_name} and labels of sample {i} in targets have a"
                f" different length (expected {_n(item[item_val_name])} labels, got {item['labels'].shape[0]})"
            )
    for i, item in enumerate(preds):
        if not (_n(item[item_val_name]) == item["labels"].shape[0] == item["scores"].shape[0]):
            raise ValueError(
                f"Input {item_val_name}, labels and scores of sample {i} in predictions have a"
                f" different length (expected {_n(item[item_val_name])} labels and scores,"
                f" got {item['labels'].shape[0]} labels and {item['scores'].shape[0]})"
            )


def _fix_empty_tensors(boxes: torch.Tensor) -> torch.Tensor:
    """Give a degenerate empty box tensor the ``(0, 4)`` shape."""
    if boxes.numel() == 0 and boxes.ndim == 1:
        return boxes.reshape(0, 4)
    return boxes


def _bulk_to_host(items: List[Any]) -> List[Any]:
    """A list state on the host, with one device read for all its tensors.

    The tensors are flattened and concatenated on their device, copied once, and split by
    the shapes the host already knows; an element-wise ``.cpu()`` would read the device
    once per image. Tensors are grouped by dtype and device first, so each entry keeps its
    own dtype (``torch.cat`` would promote, say, int64 labels beside one float tensor to
    float32, rounding ids at or above 2**24): a state of one dtype is one read. Host
    entries (numpy arrays, RLE dict lists) pass through.
    """
    out = [x if isinstance(x, (list, tuple, torch.Tensor)) else np.asarray(x) for x in items]
    groups: Dict[Any, List[int]] = {}
    for i, x in enumerate(items):
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        tensors = [items[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
        offset = 0
        for i, t in zip(idx, tensors):
            n = t.numel()
            out[i] = flat[offset : offset + n].reshape(tuple(t.shape))
            offset += n
    return out
