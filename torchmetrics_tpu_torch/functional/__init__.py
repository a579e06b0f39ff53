"""Functional metrics of the port: a flat re-export of each domain's functionals, as
``torchmetrics_tpu.functional`` re-exports them."""

from torchmetrics_tpu_torch.functional.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.detection import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.detection import __all__ as _detection_all
from torchmetrics_tpu_torch.functional.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.image import __all__ as _image_all
from torchmetrics_tpu_torch.functional.multimodal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.multimodal import __all__ as _multimodal_all
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.pairwise import __all__ as _pairwise_all
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.functional.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.text import __all__ as _text_all

__all__ = (
    list(_audio_all)
    + list(_classification_all)
    + list(_detection_all)
    + list(_image_all)
    + list(_multimodal_all)
    + list(_nominal_all)
    + list(_pairwise_all)
    + list(_regression_all)
    + list(_retrieval_all)
    + list(_text_all)
)
