"""Optional-dependency availability flags (counterpart of ``torchmetrics_tpu/utilities/imports.py``).

Each flag asks ``importlib.util.find_spec``, which locates a package without importing
it, so importing this module imports none of them. The JAX package's XLA flag has no
counterpart: the port runs on CUDA.
"""

from __future__ import annotations

import importlib.util
import sys


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


_PYTHON_GREATER_EQUAL_3_8 = sys.version_info >= (3, 8)

_TORCH_AVAILABLE = _package_available("torch")
_NUMPY_AVAILABLE = _package_available("numpy")
_SCIPY_AVAILABLE = _package_available("scipy")
_SKLEARN_AVAILABLE = _package_available("sklearn")
_MATPLOTLIB_AVAILABLE = _package_available("matplotlib")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
_NLTK_AVAILABLE = _package_available("nltk")
_REGEX_AVAILABLE = _package_available("regex")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
_PYCOCOTOOLS_AVAILABLE = _package_available("pycocotools")
_TORCHVISION_AVAILABLE = _package_available("torchvision")
_TORCH_FIDELITY_AVAILABLE = _package_available("torch_fidelity")
_LPIPS_AVAILABLE = _package_available("lpips")
_FAST_BSS_EVAL_AVAILABLE = _package_available("fast_bss_eval")
_MECAB_AVAILABLE = _package_available("MeCab")
_IPADIC_AVAILABLE = _package_available("ipadic")
_SENTENCEPIECE_AVAILABLE = _package_available("sentencepiece")
_PANDAS_AVAILABLE = _package_available("pandas")
_MULTIPROCESSING_AVAILABLE = True
