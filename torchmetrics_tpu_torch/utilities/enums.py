"""String enums (counterpart of ``torchmetrics_tpu/utilities/enums.py``).

Values compare case-insensitively against strings and ``from_str`` resolves user input.
"""

from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Case-insensitive string enum base."""

    @classmethod
    def _name(cls) -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "key") -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            pass
        try:
            return cls(value.lower())
        except ValueError:
            raise ValueError(
                f"Invalid {cls._name()}: expected one of {[e.value for e in cls]}, but got {value}."
            ) from None

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Enum):
            other = other.value
        return self.value.lower() == str(other).lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class AverageMethod(EnumStr):
    """Reduction over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"

    @classmethod
    def _name(cls) -> str:
        return "Average method"


class ClassificationTask(EnumStr):
    """Task router values."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"
