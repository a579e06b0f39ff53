"""Plots of metric values (counterpart of ``torchmetrics_tpu/utilities/plot.py``).

matplotlib is imported when a plot is drawn, never when the module is imported, and
is optional: without it every plot raises the JAX package's ``ModuleNotFoundError``.
Tensors are copied to the host (``.detach().cpu().numpy()``) before plotting.
"""

from __future__ import annotations

import importlib.util
from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _error_on_missing_matplotlib() -> None:
    if importlib.util.find_spec("matplotlib") is None:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Install with `pip install matplotlib`"
        )


def _plt() -> Any:
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    return plt


def _to_np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_to_np(v) for v in x])
    return np.asarray(x)


def plot_single_or_multi_val(
    val: Union[Any, Sequence[Any], Dict[str, Any], Sequence[Dict[str, Any]]],
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> Tuple[Any, Any]:
    """Plot one metric value, a dict of them, or a sequence of either over steps."""
    plt = _plt()
    fig, ax = plt.subplots() if ax is None else (ax.get_figure(), ax)
    ax.get_xaxis().set_visible(True)
    ax.get_yaxis().set_visible(True)

    if isinstance(val, dict):
        for i, (key, item) in enumerate(val.items()):
            item = _to_np(item)
            if item.ndim == 0:
                ax.plot(i, item, marker="o", markersize=10, linestyle="None", label=key)
            else:
                ax.plot(item.flatten(), marker="o", markersize=10, linestyle="-", label=key)
    elif isinstance(val, (list, tuple)) and all(isinstance(v, dict) for v in val):
        for key in list(val[0].keys()):
            series = np.stack([_to_np(v[key]).reshape(-1) for v in val])
            if series.shape[1] == 1:
                ax.plot(series[:, 0], marker="o", markersize=10, linestyle="-", label=key)
            else:
                for c in range(series.shape[1]):
                    ax.plot(series[:, c], marker="o", markersize=10, linestyle="-", label=f"{key}_{c}")
    elif isinstance(val, (list, tuple)):
        series = np.stack([_to_np(v).reshape(-1) for v in val])
        n_steps, n_vals = series.shape
        if n_vals == 1:
            ax.plot(np.arange(n_steps), series[:, 0], marker="o", markersize=10, linestyle="-")
        else:
            for c in range(n_vals):
                label = f"{legend_name}_{c}" if legend_name else str(c)
                ax.plot(np.arange(n_steps), series[:, c], marker="o", markersize=10, linestyle="-", label=label)
    else:
        arr = _to_np(val)
        if arr.ndim == 0:
            ax.plot([0], [arr], marker="o", markersize=10, linestyle="None")
        else:
            for i, v in enumerate(arr.flatten()):
                label = f"{legend_name}_{i}" if legend_name else str(i)
                ax.plot(i, v, marker="o", markersize=10, linestyle="None", label=label)

    _, labels = ax.get_legend_handles_labels()
    if labels:
        ax.legend(loc="best")
    if lower_bound is not None or upper_bound is not None:
        ylim = ax.get_ylim()
        ax.set_ylim(
            bottom=lower_bound if lower_bound is not None else ylim[0],
            top=upper_bound if upper_bound is not None else ylim[1],
        )
    if name is not None:
        ax.set_title(name)
    ax.set_xlabel("Step")
    ax.set_ylabel("Value")
    return fig, ax


def trim_axs(axs: Any, nb: int) -> Any:
    """The first ``nb`` axes of a grid; the rest are removed from the figure."""
    if isinstance(axs, np.ndarray):
        axs = axs.flat
        for ax in axs[nb:]:
            ax.remove()
        return axs[:nb]
    return axs


def plot_confusion_matrix(
    confmat: Any,
    ax: Optional[Any] = None,
    add_text: bool = True,
    labels: Optional[List[Union[str, int]]] = None,
    cmap: Optional[str] = None,
) -> Tuple[Any, Any]:
    """Heatmap of a ``(C, C)`` confusion matrix, or one per label of an ``(N, 2, 2)`` one."""
    plt = _plt()
    confmat = _to_np(confmat)
    multilabel = confmat.ndim == 3
    if multilabel:
        nb, n_classes = confmat.shape[0], 2
        rows, cols = int(np.ceil(np.sqrt(nb))), int(np.round(np.sqrt(nb)))
    else:
        nb, n_classes = 1, confmat.shape[0]
        rows, cols = 1, 1
        confmat = confmat[None]
    # per-class tick labels only make sense for the single (C, C) case
    if labels is not None and not multilabel and len(labels) != n_classes:
        raise ValueError("Expected number of elements in arg `labels` to match number of labels in confmat")
    labels = labels if labels is not None else np.arange(n_classes).tolist()

    if ax is None:
        fig, axs = plt.subplots(nrows=rows, ncols=cols)
    else:
        fig, axs = ax.get_figure(), ax
    axs = trim_axs(axs, nb) if isinstance(axs, np.ndarray) else [axs]

    for i in range(nb):
        ax_i = axs[i] if nb > 1 else axs[0]
        if nb > 1:
            ax_i.set_title(f"Label {i}", fontsize=15)
        ax_i.imshow(confmat[i], cmap=cmap)
        ax_i.set_xlabel("Predicted class", fontsize=15)
        ax_i.set_ylabel("True class", fontsize=15)
        ax_i.set_xticks(list(range(n_classes)))
        ax_i.set_yticks(list(range(n_classes)))
        ax_i.set_xticklabels(labels, rotation=45, fontsize=10)
        ax_i.set_yticklabels(labels, rotation=25, fontsize=10)
        if add_text:
            for ii, jj in product(range(n_classes), range(n_classes)):
                val = confmat[i, ii, jj]
                txt = f"{val.item():.2f}" if np.issubdtype(confmat.dtype, np.floating) else str(int(val))
                ax_i.text(jj, ii, txt, ha="center", va="center", fontsize=15)
    return fig, axs if nb > 1 else axs[0]


def plot_curve(
    curve: Tuple[Any, ...],
    score: Optional[Any] = None,
    ax: Optional[Any] = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> Tuple[Any, Any]:
    """Plot an ``(x, y, thresholds)`` curve (ROC, PR), or one per class."""
    plt = _plt()
    if len(curve) < 2:
        raise ValueError("Expected 2 or more elements in curve object")
    x, y = _to_np(curve[0]), _to_np(curve[1])
    fig, ax = plt.subplots() if ax is None else (ax.get_figure(), ax)

    if x.ndim == 1 and y.ndim == 1:
        label = f"AUC={score.item():0.3f}" if score is not None else None
        ax.plot(x, y, linestyle="-", linewidth=2, label=label)
        if label is not None:
            ax.legend()
    elif (isinstance(curve[0], (list, tuple)) and isinstance(curve[1], (list, tuple))) or (x.ndim == 2 and y.ndim == 2):
        for i in range(len(curve[0])):
            xi, yi = _to_np(curve[0][i]), _to_np(curve[1][i])
            label = f"{legend_name}_{i}" if legend_name else str(i)
            label += f" AUC={score[i].item():0.3f}" if score is not None else ""
            ax.plot(xi, yi, label=label)
        ax.legend()
    else:
        raise ValueError(
            f"Unknown format for argument `curve`. Expected 2 lists of 1D arrays or 2D arrays, got {x.ndim}D/{y.ndim}D"
        )
    ax.grid(True)
    if label_names is not None:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name is not None:
        ax.set_title(name)
    return fig, ax
