"""Hugging Face model loading for the model-backed text metrics (counterpart of
``torchmetrics_tpu/utilities/hf.py``), on the torch route only.

``transformers`` is imported inside the functions: a module of the port never imports
it when the port is imported. A checkpoint loads through ``transformers.AutoModel`` /
``AutoModelForMaskedLM`` and ``AutoTokenizer`` from a hub id that is already cached or
from a local ``save_pretrained`` directory; a load that fails (offline, an uncached id)
raises one ``ModuleNotFoundError`` that says what to do instead. The JAX package's
Flax-first load and its ``from_pt`` conversion retry have no counterpart: the torch
model is the model here. The forwards run the model on the device of their inputs and
return tensors there. The cache holds each model on the CPU, where metrics on any device
share it; a forward on another device runs that device's copy (``model_on``), so no
metric moves the model another metric uses.
"""

from __future__ import annotations

import weakref
from functools import lru_cache
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.models._common import device_key, moved


@lru_cache(maxsize=8)
def load_hf_model_and_tokenizer(model_name_or_path: str, auto_cls_name: str = "AutoModel") -> Tuple[Any, Any]:
    """Cached ``(model, tokenizer)`` per checkpoint id or path: a metric's every step
    calls into the functional API, which would otherwise read the checkpoint again."""
    return load_hf_model(model_name_or_path, auto_cls_name), load_hf_tokenizer(model_name_or_path)


def _load_error(model_name_or_path: str, exc: Exception) -> ModuleNotFoundError:
    return ModuleNotFoundError(
        f"Could not load pretrained weights for `{model_name_or_path!r}`: {exc.__class__.__name__}. In an"
        " offline environment the weights must already be cached (HF_HOME) or `model_name_or_path` must be a"
        " local directory created with `save_pretrained`. Alternatively inject the network directly (pass a"
        " callable model + tokenizer), as in the reference's own-model example."
    )


def load_hf_tokenizer(model_name_or_path: str) -> Any:
    """``AutoTokenizer`` with the offline error."""
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(model_name_or_path)
    except Exception as exc:  # noqa: BLE001 -- the hub raises OSError / HTTPError / ValueError variants
        raise _load_error(model_name_or_path, exc) from exc


def load_hf_model(model_name_or_path: str, auto_cls_name: str = "AutoModel") -> Any:
    """A torch transformer from ``transformers.<auto_cls_name>``, in ``eval`` mode on the
    CPU (the forwards run its copy on their inputs' device), with the offline error."""
    import transformers

    auto_cls = getattr(transformers, auto_cls_name, None)
    if auto_cls is None:
        raise _load_error(model_name_or_path, AttributeError(f"transformers has no auto class {auto_cls_name!r}"))
    try:
        model = auto_cls.from_pretrained(model_name_or_path)
    except Exception as exc:  # noqa: BLE001
        raise _load_error(model_name_or_path, exc) from exc
    model.eval()
    return model


# each shared model's copies on the devices it is not on, kept while the model lives
_COPIES: "weakref.WeakKeyDictionary[Any, Dict[str, Any]]" = weakref.WeakKeyDictionary()


def model_on(model: Any, device: Union[str, torch.device]) -> Any:
    """``model`` on ``device``, never moved in place: a model elsewhere gives one moved
    copy per device (``models/_common.moved``), which every later call reuses."""
    first = next(model.parameters(), None)
    if first is None or device_key(first.device) == device_key(device):
        return model
    copies = _COPIES.setdefault(model, {})
    key = device_key(device)
    if key not in copies:
        copies[key] = moved(model, device)
    return copies[key]


def hf_embedding_forward(model: Any, num_layers: Optional[int] = None) -> Callable:
    """``(input_ids, attention_mask) -> (N, L, D)`` hidden states on the inputs' device.

    ``num_layers`` picks ``hidden_states[num_layers]``; ``None`` the last hidden state.
    """

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = model_on(model, input_ids.device)(
                input_ids=input_ids,
                attention_mask=attention_mask,
                output_hidden_states=num_layers is not None,
            )
        return out.hidden_states[num_layers] if num_layers is not None else out.last_hidden_state

    return forward


def hf_logits_forward(model: Any) -> Callable:
    """``(input_ids, attention_mask) -> (N, L, V)`` masked-LM logits on the inputs' device."""

    def forward(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model_on(model, input_ids.device)(input_ids=input_ids, attention_mask=attention_mask).logits

    return forward


def model_max_length(model: Any, max_length: int) -> int:
    """A requested sequence length capped by the model's position embeddings: padding
    past ``max_position_embeddings`` would index out of the position table."""
    cap = getattr(getattr(model, "config", None), "max_position_embeddings", None)
    return min(max_length, cap) if isinstance(cap, int) and cap > 0 else max_length


def hf_tokenize(
    tokenizer: Any,
    sentences,
    max_length: int = 512,
    padding: str = "max_length",
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded ``(input_ids, attention_mask)`` of a list of sentences, on ``device``
    (``None``: the CPU, where the tokenizer made them)."""
    enc = tokenizer(list(sentences), padding=padding, truncation=True, max_length=max_length, return_tensors="pt")
    return enc["input_ids"].to(device or "cpu"), enc["attention_mask"].to(device or "cpu")
