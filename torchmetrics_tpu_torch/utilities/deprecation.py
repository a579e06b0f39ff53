"""Root-alias deprecation shims (counterpart of ``torchmetrics_tpu/utilities/deprecation.py``).

Domain metrics stay importable from the package root but deprecated: each domain's
``_deprecated.py`` defines ``_X(X)`` subclasses that warn on construction, and the root
``__init__`` exports them under the plain names. Importing from
``torchmetrics_tpu_torch.<domain>`` stays warning-free.
"""

from __future__ import annotations

from typing import Any, Type

from torchmetrics_tpu_torch.utilities.prints import _deprecated_root_import_class


def root_alias(cls: Type, domain: str) -> Type:
    """Subclass ``cls`` so that construction warns about the deprecated root import."""

    class _RootAlias(cls):  # type: ignore[misc,valid-type]
        def __init__(self, *args: Any, **kwargs: Any) -> None:
            _deprecated_root_import_class(cls.__name__, domain)
            super().__init__(*args, **kwargs)

    _RootAlias.__name__ = f"_{cls.__name__}"
    _RootAlias.__qualname__ = f"_{cls.__name__}"
    _RootAlias.__doc__ = f"Deprecated-root-import wrapper for :class:`torchmetrics_tpu_torch.{domain}.{cls.__name__}`."
    return _RootAlias
