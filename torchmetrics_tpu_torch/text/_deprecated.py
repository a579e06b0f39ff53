"""Root aliases of the text metrics, which warn at construction (counterpart of
``torchmetrics_tpu/text/_deprecated.py``)."""

from torchmetrics_tpu_torch.text import (
    BLEUScore,
    CHRFScore,
    CharErrorRate,
    ExtendedEditDistance,
    MatchErrorRate,
    Perplexity,
    SQuAD,
    SacreBLEUScore,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from torchmetrics_tpu_torch.utilities.deprecation import root_alias

_BLEUScore = root_alias(BLEUScore, "text")
_CHRFScore = root_alias(CHRFScore, "text")
_CharErrorRate = root_alias(CharErrorRate, "text")
_ExtendedEditDistance = root_alias(ExtendedEditDistance, "text")
_MatchErrorRate = root_alias(MatchErrorRate, "text")
_Perplexity = root_alias(Perplexity, "text")
_SQuAD = root_alias(SQuAD, "text")
_SacreBLEUScore = root_alias(SacreBLEUScore, "text")
_TranslationEditRate = root_alias(TranslationEditRate, "text")
_WordErrorRate = root_alias(WordErrorRate, "text")
_WordInfoLost = root_alias(WordInfoLost, "text")
_WordInfoPreserved = root_alias(WordInfoPreserved, "text")
