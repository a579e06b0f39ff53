"""Host C++ kernels of the port, bound with ctypes (counterpart of ``torchmetrics_tpu/native``).

The port's own copies of the JAX package's ``rle.cpp`` and ``match.cpp`` build at first
use with ``g++``; a failed build raises (no quiet numpy fallback). These are host code
(RLE masks, COCO matching and evaluation, the LCS of ROUGE-L), not card kernels.
"""

from torchmetrics_tpu_torch.native.rle_mask import (
    coco_eval_bbox,
    coco_eval_bbox_available,
    coco_match,
    lcs_len,
    native_available,
    rle_area,
    rle_decode,
    rle_encode,
    rle_iou,
)

__all__ = [
    "coco_eval_bbox",
    "coco_eval_bbox_available",
    "coco_match",
    "lcs_len",
    "native_available",
    "rle_area",
    "rle_decode",
    "rle_encode",
    "rle_iou",
]
