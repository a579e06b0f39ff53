"""CLIPScore (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``).

The embedding backend is an injection point: ``embed_fn(images, text)`` returns
``(image features, text features)`` and the metric core (L2-normalise, cosine, x100)
runs on the device. The default backend is ``transformers``' torch ``CLIPModel`` and
``CLIPProcessor``, loaded once per checkpoint and kept on the CPU (the loader's cache,
shared by every metric); the towers run a copy of it on the metric's device
(``utilities/hf.model_on``) at full float32 (``models/_common.full_float32``: no TF32).
The processor (resize, crop, normalise, tokenise) runs on the host, as in the JAX
package: the images come to the host in one read, and ``pixel_values``,
``input_ids`` and ``attention_mask`` go to the device in one copy each. The JAX
package runs its towers on the host instead.

The towers are called as ``visual_projection(vision_model(...).pooler_output)`` and
``text_projection(text_model(...).pooler_output)``: what ``get_image_features`` and
``get_text_features`` return in ``transformers`` 4, where version 5 returns a model
output instead.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utilities.imports import _TRANSFORMERS_AVAILABLE

_DEFAULT_MODEL = "openai/clip-vit-large-patch14"

Images = Union[torch.Tensor, np.ndarray, List[Union[torch.Tensor, np.ndarray]]]
EmbedFn = Callable[[List[Any], List[str]], Tuple[torch.Tensor, torch.Tensor]]


@lru_cache(maxsize=4)
def _get_model_and_processor(model_name_or_path: str = _DEFAULT_MODEL) -> Tuple[Any, Any]:
    """The HF CLIP towers (in ``eval`` mode, on the CPU) and processor of a checkpoint id
    or a local ``save_pretrained`` directory, cached: every update would otherwise read
    the checkpoint again."""
    if _TRANSFORMERS_AVAILABLE:
        from transformers import CLIPModel, CLIPProcessor

        try:
            return CLIPModel.from_pretrained(model_name_or_path).eval(), CLIPProcessor.from_pretrained(model_name_or_path)
        except Exception as exc:  # noqa: BLE001 -- an offline-clean error instead of the hub's traceback
            from torchmetrics_tpu_torch.utilities.hf import _load_error

            raise _load_error(model_name_or_path, exc) from exc
    raise ModuleNotFoundError(
        "`clip_score` metric requires `transformers` package be installed."
        " Either install with `pip install transformers>=4.0` or `pip install torchmetrics[multimodal]`."
    )


def _host_images(images: List[Any]) -> List[np.ndarray]:
    """The images as host arrays; the tensors among them come over in one read."""
    tensors = [i for i in images if isinstance(i, torch.Tensor)]
    if not tensors:
        return [np.asarray(i) for i in images]
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu().numpy()
    pieces = iter(np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1]))
    return [next(pieces).reshape(tuple(i.shape)) if isinstance(i, torch.Tensor) else np.asarray(i) for i in images]


def _hf_embed(
    images: List[Any], text: List[str], model: Any, processor: Any, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The processor on the host, the towers on ``device``: ``(image features, text
    features)`` there."""
    from torchmetrics_tpu_torch.models._common import full_float32
    from torchmetrics_tpu_torch.utilities.hf import model_on

    processed = processor(text=text, images=_host_images(images), return_tensors="pt", padding=True)
    pixel_values = processed["pixel_values"].to(device)
    input_ids = processed["input_ids"].to(device)
    attention_mask = processed["attention_mask"].to(device)
    towers = model_on(model, device)
    with torch.no_grad(), full_float32():
        img_features = towers.visual_projection(towers.vision_model(pixel_values=pixel_values).pooler_output)
        txt_features = towers.text_projection(
            towers.text_model(input_ids=input_ids, attention_mask=attention_mask).pooler_output
        )
    return img_features, txt_features


def _clip_score_update(
    images: Images,
    text: Union[str, List[str]],
    model: Any,
    processor: Any,
    embed_fn: Optional[EmbedFn] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, int]:
    """Per-pair 100 x cosine similarity on ``device``, and the number of pairs."""
    if not isinstance(images, list):
        images = [images] if images.ndim == 3 else list(images)
    else:
        images = list(images)
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )

    device = torch.device(device)
    if embed_fn is not None:
        img_features, txt_features = embed_fn(images, text)
        img_features = torch.as_tensor(img_features, device=device)
        txt_features = torch.as_tensor(txt_features, device=device)
    else:
        img_features, txt_features = _hf_embed(images, text, model, processor, device)

    img_features = img_features / torch.linalg.vector_norm(img_features, dim=-1, keepdim=True)
    txt_features = txt_features / torch.linalg.vector_norm(txt_features, dim=-1, keepdim=True)
    score = 100 * (img_features * txt_features).sum(dim=-1)
    return score, len(text)


def clip_score(
    images: Images,
    text: Union[str, List[str]],
    model_name_or_path: str = _DEFAULT_MODEL,
    embed_fn: Optional[EmbedFn] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    r"""CLIPScore(I, C) = max(100 * cos(E_I, E_C), 0), averaged over the pairs.

    ``device``: where the towers and the score run (``None``: the card).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.multimodal import clip_score
        >>> embed = lambda images, text: (torch.ones(len(images), 4), torch.tensor([[1.0, 1.0, 1.0, -1.0]] * len(text)))
        >>> float(clip_score(torch.zeros(2, 3, 8, 8), ["a", "b"], embed_fn=embed, device="cpu"))
        50.0
    """
    device = resolve_device(device)
    if embed_fn is None:
        model, processor = _get_model_and_processor(model_name_or_path)
    else:
        model = processor = None
    score, _ = _clip_score_update(images, text, model, processor, embed_fn, device)
    score = score.mean(0)
    return torch.maximum(score, torch.zeros_like(score))
