"""Root aliases of the panoptic qualities, which warn at construction (counterpart of
``torchmetrics_tpu/detection/_deprecated.py``)."""

from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality
from torchmetrics_tpu_torch.utilities.deprecation import root_alias

_ModifiedPanopticQuality = root_alias(ModifiedPanopticQuality, "detection")
_PanopticQuality = root_alias(PanopticQuality, "detection")
