"""SacreBLEU (counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``).

BLEU's four states with sacrebleu's tokenizers ``none``, ``13a``, ``zh``, ``intl`` and
``char``. ``intl`` splits on ``unicodedata`` categories, as the JAX package does, so it
needs no third-party ``regex`` module.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _bleu_states

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

# the main CJK code point ranges
_UCODE_RANGES = (
    ("\u3400", "\u4db5"),  # CJK Unified Ideographs Extension A
    ("\u4e00", "\u9fa5"),  # CJK Unified Ideographs
    ("\u9fa6", "\u9fbb"),  # CJK Unified Ideographs, release 4.1
    ("\uf900", "\ufa2d"),  # CJK Compatibility Ideographs
    ("\ufa30", "\ufa6a"),  # CJK Compatibility Ideographs, release 3.2
    ("\ufa70", "\ufad9"),  # CJK Compatibility Ideographs, release 4.1
    ("\U00020000", "\U0002a6d6"),  # CJK Unified Ideographs Extension B
    ("\U0002f800", "\U0002fa1d"),  # CJK Compatibility Supplement
    ("\uff00", "\uffef"),  # Full-width ASCII + half-width forms
    ("\u2e80", "\u2eff"),  # CJK Radicals Supplement
    ("\u3000", "\u303f"),  # CJK punctuation marks
    ("\u31c0", "\u31ef"),  # CJK strokes
    ("\u2f00", "\u2fdf"),  # Kangxi Radicals
    ("\u2ff0", "\u2fff"),  # Ideographic Description Characters
    ("\u3100", "\u312f"),  # Bopomofo
    ("\u31a0", "\u31bf"),  # Bopomofo Extended
    ("\ufe10", "\ufe1f"),  # Vertical forms
    ("\ufe30", "\ufe4f"),  # CJK Compatibility Forms
    ("\u2600", "\u26ff"),  # Miscellaneous symbols
    ("\u2700", "\u27bf"),  # Dingbats
    ("\u3200", "\u32ff"),  # Enclosed CJK letters and months
    ("\u3300", "\u33ff"),  # CJK compatibility
)


class _SacreBLEUTokenizer:
    """The sacrebleu tokenizer family."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    _TOKENIZE_FN = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        tokenize_fn = getattr(cls, cls._TOKENIZE_FN[tokenize])
        return cls._lower(tokenize_fn(line), lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += f" {char} "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        """mteval-v14's international tokenization over ``unicodedata`` categories:
        punctuation (P*) splits off unless it stands between digits, symbols (S*) always."""
        out = []
        n = len(line)
        for i, ch in enumerate(line):
            cat = unicodedata.category(ch)
            if cat.startswith("P"):
                # each rule needs a real neighbouring non-digit: at the string's ends
                # neither matches, so punctuation next to a digit stays attached
                prev_is_nondigit = i > 0 and not unicodedata.category(line[i - 1]).startswith("N")
                next_is_nondigit = i + 1 < n and not unicodedata.category(line[i + 1]).startswith("N")
                if prev_is_nondigit or next_is_nondigit:
                    out.append(f" {ch} ")
                else:
                    out.append(ch)
            elif cat.startswith("S"):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return " ".join("".join(out).split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """SacreBLEU; ``device`` holds the states and the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
        >>> print(round(float(sacre_bleu_score(preds, target, device="cpu")), 4))
        0.0
    """
    if tokenize not in AVAILABLE_TOKENIZERS:
        raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    tokenize_fn = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target, *_bleu_states(n_gram, device), n_gram, tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
