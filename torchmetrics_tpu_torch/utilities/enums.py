"""String enums (counterpart of ``torchmetrics_tpu/utilities/enums.py``).

Values compare case-insensitively against strings and ``from_str`` resolves user input.
``_route_task`` is the body of every task router (``Accuracy(task=...)``, ``auroc(...,
task=...)``).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Optional


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


class ClassificationTaskNoBinary(EnumStr):
    """Task router values of the metrics without a binary variant (exact match)."""

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """Task router values of the metrics without a multilabel variant (Cohen's kappa)."""

    BINARY = "binary"
    MULTICLASS = "multiclass"


def _check_task_size(name: str, value: Any) -> int:
    """The task routers' check that ``num_classes`` / ``num_labels`` / ``top_k`` is an int."""
    if not isinstance(value, int):
        raise ValueError(f"`{name}` is expected to be `int` but `{type(value)} was passed.`")
    return value


def _route_task(
    task: str,
    num_classes: Optional[int],
    num_labels: Optional[int],
    binary: Optional[Callable[[], Any]],
    multiclass: Callable[[int], Any],
    multilabel: Optional[Callable[[int], Any]],
    tasks: type = ClassificationTask,
) -> Any:
    """The body of every task router: ``binary()``, ``multiclass(num_classes)`` or
    ``multilabel(num_labels)``, the width checked to be an int. ``tasks`` is the enum
    the task must belong to; a router without a binary or multilabel variant passes
    ``None`` for it and the enum that leaves it out, whose ``from_str`` raises."""
    task = tasks.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary()
    if task == ClassificationTask.MULTICLASS:
        return multiclass(_check_task_size("num_classes", num_classes))
    if task == ClassificationTask.MULTILABEL:
        return multilabel(_check_task_size("num_labels", num_labels))
    raise ValueError(f"Not handled value: {task}")
