"""Modular text metrics (counterpart of ``torchmetrics_tpu/text/__init__.py``)."""

from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.bleu import BLEUScore
from torchmetrics_tpu_torch.text.chrf import CHRFScore
from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
from torchmetrics_tpu_torch.text.infolm import InfoLM
from torchmetrics_tpu_torch.text.perplexity import Perplexity
from torchmetrics_tpu_torch.text.rouge import ROUGEScore
from torchmetrics_tpu_torch.text.sacre_bleu import SacreBLEUScore
from torchmetrics_tpu_torch.text.squad import SQuAD
from torchmetrics_tpu_torch.text.ter import TranslationEditRate
from torchmetrics_tpu_torch.text.wer import (
    CharErrorRate,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
