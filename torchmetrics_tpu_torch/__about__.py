"""Package metadata (counterpart of ``torchmetrics_tpu/__about__.py``): the version is the
JAX package's, since the port keeps its surface and its values."""

__version__ = "1.0.0rc0"
__author__ = "torchmetrics-tpu contributors"
__license__ = "Apache-2.0"
__docs__ = "PyTorch/CUDA port of torchmetrics_tpu, with hand-written Hopper kernels"

__all__ = ["__author__", "__docs__", "__license__", "__version__"]
