"""Frozen feature trunks behind the model-based image metrics (counterpart of
``torchmetrics_tpu/models/__init__.py``).

``torch.nn`` modules under torchvision's module and parameter names: InceptionV3 (and
torch-fidelity's FID variant) for FID / KID / IS, AlexNet / VGG16 / SqueezeNet-1.1
feature slices for LPIPS. No weights are bundled or downloaded: a torchvision or
torch-fidelity state dict loads with ``load_state_dict``, the JAX package's flax
variables through each module's ``state_dict_from_flax``, and without either a trunk
takes the port's own seeded random init.
"""

from torchmetrics_tpu_torch.models.alexnet import AlexNetFeatures, alexnet_lpips_extractor
from torchmetrics_tpu_torch.models.inception import InceptionV3, inception_v3_extractor
from torchmetrics_tpu_torch.models.squeezenet import SqueezeNetFeatures, squeezenet_lpips_extractor
from torchmetrics_tpu_torch.models.vgg import VGG16Features, vgg16_lpips_extractor

__all__ = [
    "AlexNetFeatures",
    "InceptionV3",
    "SqueezeNetFeatures",
    "VGG16Features",
    "alexnet_lpips_extractor",
    "inception_v3_extractor",
    "squeezenet_lpips_extractor",
    "vgg16_lpips_extractor",
]
