"""The port's host text metrics against the JAX package on the CPU.

BLEU, SacreBLEU, chrF, TER, EED, the WER family, ROUGE, SQuAD and perplexity: the same
seeded sentence pairs (numpy draws from a small vocabulary; each target an edit of its
prediction) go through both packages at the three protocol levels of
``tests/differential/harness.py`` (the per-batch ``forward`` value, the fold of two
replicas, the epoch ``compute``) for one or two option sets per class, and every other
option through the functionals.

Tolerances: integer counts exact; the float32 states that hold integer counts (edits,
n-grams, lengths) exact against the JAX package's float64 ones; values relative
``VALUE_RTOL`` (the port keeps float32 where the JAX package runs in 64-bit mode here);
perplexity relative ``PPL_RTOL`` (float32 sums over the tokens in another order) and its
gradient ``GRAD_RTOL`` / ``GRAD_ATOL``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as jF
import torchmetrics_tpu.text as jt
import torchmetrics_tpu_torch.functional.text as tF
import torchmetrics_tpu_torch.text as tt
from tests.torch_parity import assert_close, np_

VALUE_RTOL = 1e-6
PPL_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-8

_WORDS = [
    "the", "a", "cat", "dog", "sat", "ran", "on", "in", "mat", "park", "house", "green", "quickly", "over",
    "under", "bridge", "river", "city", "old", "new", "man", "woman", "saw", "took", "train", "to", "berlin",
    "1976", "3.5", "it's", "don't", "e.g.", "U.S.", "(big)", "well-known", "&", "$20", "%", "naïve", "Straße",
    "猫", "東京", "日本語",
]


def corpus(n: int, seed: int, refs: int = 1, sentences: bool = False):
    """``n`` seeded ``(pred, [ref, ...])`` pairs: each reference an edit of the prediction
    (~30 % of words substituted, some inserted or dropped, a clause moved)."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for _ in range(n):
        words = list(rng.choice(_WORDS, size=rng.integers(1, 12)))
        pred = " ".join(words)
        if sentences and rng.random() < 0.5:
            pred = pred + ". " + " ".join(rng.choice(_WORDS, size=rng.integers(2, 6))) + "."
        row = []
        for _ in range(refs):
            ref = [w if rng.random() > 0.3 else str(rng.choice(_WORDS)) for w in words]
            if rng.random() < 0.3 and len(ref) > 1:
                del ref[rng.integers(len(ref))]
            if rng.random() < 0.3:
                ref.insert(rng.integers(len(ref) + 1), str(rng.choice(_WORDS)))
            if len(ref) > 3 and rng.random() < 0.5:
                cut = rng.integers(1, len(ref))
                ref = ref[cut:] + ref[:cut]
            text = " ".join(ref)
            if sentences and rng.random() < 0.5:
                text = text + ". " + " ".join(rng.choice(_WORDS, size=rng.integers(2, 6))) + "."
            row.append(text)
        preds.append(pred)
        targets.append(row)
    return preds, targets


def batches(n_batches: int = 4, size: int = 5, seed: int = 0, refs: int = 1, flat: bool = False, sentences=False):
    out = []
    for b in range(n_batches):
        p, t = corpus(size, seed * 100 + b, refs, sentences)
        out.append((p, [r[0] for r in t] if flat else t))
    return out


def assert_text_states(port, ref, rtol: float = VALUE_RTOL) -> None:
    """Every state: raw string lists equal; tensors (list states concatenated) exact where
    the reference holds whole numbers (counts, lengths), else within ``rtol``."""
    for attr in ref._defaults:
        p, r = getattr(port, attr), getattr(ref, attr)
        if isinstance(r, list):
            assert isinstance(p, list) and len(p) == len(r), attr
            if not r:
                continue
            if isinstance(r[0], str) or getattr(r[0], "dtype", None) is not None and np.asarray(r[0]).dtype.kind == "U":
                assert p == [str(x) for x in r], attr
                continue
            assert [tuple(x.shape) for x in p] == [tuple(np.shape(x)) for x in r], attr
            p, r = torch.cat([x.reshape(-1) for x in p]), np.concatenate([np.asarray(x).reshape(-1) for x in r])
        p, r = np_(p), np.asarray(r)
        assert p.shape == r.shape, attr
        if p.dtype.kind in "iu" or np.array_equal(r, np.round(r)):
            np.testing.assert_array_equal(p, r, err_msg=attr)
        else:
            np.testing.assert_allclose(p, r, rtol=rtol, atol=0, err_msg=attr)


def text_three_levels(make_port, make_ref, data, rtol: float = VALUE_RTOL, state_rtol: float = VALUE_RTOL) -> None:
    """``data``: update argument tuples, the same for both packages."""
    port, ref = make_port(), make_ref()
    for i, args in enumerate(data):
        assert_close(port(*args), ref(*args), 0.0, rtol, f"forward {i}")
    assert_text_states(port, ref, state_rtol)
    epoch = ref.compute()
    assert_close(port.compute(), epoch, 0.0, rtol, "compute")

    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, args in enumerate(data):
        first = i < len(data) // 2
        (pa if first else pb).update(*args)
        (ra if first else rb).update(*args)
    pa.merge_state(pb)
    ra.merge_state(rb)
    assert_text_states(pa, ra, state_rtol)
    assert pa.update_count == ra.update_count == len(data)
    assert_close(pa.compute(), ra.compute(), 0.0, rtol, "merged compute")
    assert_close(pa.compute(), epoch, 0.0, rtol, "merged against one instance")


# ---------------------------------------------------------------- the three levels

_CLASSES = [
    ("WordErrorRate", {}, "flat"),
    ("CharErrorRate", {}, "flat"),
    ("MatchErrorRate", {}, "flat"),
    ("WordInfoLost", {}, "flat"),
    ("WordInfoPreserved", {}, "flat"),
    ("BLEUScore", {}, "refs"),
    ("BLEUScore", {"n_gram": 2, "smooth": True, "weights": [0.3, 0.7]}, "refs"),
    ("SacreBLEUScore", {"tokenize": "intl", "lowercase": True}, "refs"),
    ("CHRFScore", {}, "refs"),
    ("CHRFScore", {"n_word_order": 0, "return_sentence_level_score": True}, "refs"),
    ("TranslationEditRate", {}, "refs"),
    ("TranslationEditRate", {"normalize": True, "return_sentence_level_score": True}, "refs"),
    ("ExtendedEditDistance", {}, "refs"),
    ("ExtendedEditDistance", {"return_sentence_level_score": True, "alpha": 1.5}, "refs"),
    ("ROUGEScore", {}, "sentences"),
    ("ROUGEScore", {"accumulate": "avg", "rouge_keys": ("rouge1", "rougeLsum")}, "sentences"),
]


@pytest.mark.parametrize(("name", "kwargs", "kind"), _CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(_CLASSES)])
def test_three_levels(name, kwargs, kind):
    data = {
        "flat": batches(flat=True),
        "refs": batches(seed=1, refs=2),
        "sentences": batches(seed=2, refs=2, sentences=True),
    }[kind]
    text_three_levels(lambda: getattr(tt, name)(**kwargs, device="cpu"), lambda: getattr(jt, name)(**kwargs), data)


def _squad_batches(n_batches: int = 4, size: int = 6, seed: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        preds, target = [], []
        for i in range(size):
            qid = f"q{b}-{i}"
            answers = [" ".join(rng.choice(_WORDS, size=rng.integers(1, 4))) for _ in range(rng.integers(1, 3))]
            pick = rng.random()
            pred = answers[0] if pick < 0.3 else "" if pick < 0.4 else " ".join(rng.choice(_WORDS, size=rng.integers(1, 4)))
            if rng.random() > 0.1:  # some questions go unanswered
                preds.append({"prediction_text": pred, "id": qid})
            target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": qid})
        out.append((preds, target))
    return out


def test_squad_three_levels():
    text_three_levels(lambda: tt.SQuAD(device="cpu"), jt.SQuAD, _squad_batches())
    for preds, target in _squad_batches(2, seed=4):
        assert_close(tF.squad(preds, target, device="cpu"), jF.squad(preds, target), 0.0, VALUE_RTOL, "squad")


# ---------------------------------------------------------------- the functionals over their options


def _same(port_fn, jax_fn, *args, rtol: float = VALUE_RTOL, **kwargs) -> None:
    assert_close(port_fn(*args, **kwargs, device="cpu"), jax_fn(*args, **kwargs), 0.0, rtol, port_fn.__name__)


@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
def test_sacre_bleu_tokenizers(tokenize):
    preds, target = corpus(12, 5, refs=2)
    for lowercase in (False, True):
        _same(tF.sacre_bleu_score, jF.sacre_bleu_score, preds, target, tokenize=tokenize, lowercase=lowercase)
        _same(tF.sacre_bleu_score, jF.sacre_bleu_score, preds, target, tokenize=tokenize, smooth=True, n_gram=3)


def test_bleu_options():
    preds, target = corpus(12, 6, refs=3)
    for kwargs in ({}, {"n_gram": 1}, {"n_gram": 3, "smooth": True}, {"n_gram": 2, "weights": [0.9, 0.1]}):
        _same(tF.bleu_score, jF.bleu_score, preds, target, **kwargs)
    _same(tF.bleu_score, jF.bleu_score, "the cat sat", ["a cat sat on it"])
    _same(tF.bleu_score, jF.bleu_score, ["zz yy"], [["aa bb"]])  # no match: 0 on the device
    with pytest.raises(ValueError, match="weights"):
        tF.bleu_score(preds, target, weights=[1.0], device="cpu")


def test_word_error_family():
    preds, target = corpus(10, 7)
    target = [t[0] for t in target]
    for name in ("word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
                 "word_information_preserved"):
        _same(getattr(tF, name), getattr(jF, name), preds, target)
        _same(getattr(tF, name), getattr(jF, name), preds[0], target[0])


def test_chrf_options():
    preds, target = corpus(10, 8, refs=2)
    for kwargs in (
        {},
        {"n_char_order": 3, "n_word_order": 0},
        {"beta": 1.0, "lowercase": True},
        {"whitespace": True, "n_word_order": 1},
        {"return_sentence_level_score": True},
    ):
        _same(tF.chrf_score, jF.chrf_score, preds, target, **kwargs)


def test_ter_options():
    preds, target = corpus(8, 9, refs=2)
    preds[0] = "東京 は 日本の首都 です。 「テスト」"
    target[0] = ["東京は 日本 の 首都です 。", "テスト"]
    for kwargs in (
        {},
        {"normalize": True},
        {"no_punctuation": True},
        {"lowercase": False},
        {"normalize": True, "asian_support": True, "no_punctuation": True},
        {"return_sentence_level_score": True},
    ):
        _same(tF.translation_edit_rate, jF.translation_edit_rate, preds, target, **kwargs)


def test_eed_options():
    preds, target = corpus(8, 10, refs=2)
    for kwargs in ({}, {"language": "ja"}, {"rho": 0.5, "deletion": 0.4, "insertion": 2.0},
                   {"return_sentence_level_score": True}):
        _same(tF.extended_edit_distance, jF.extended_edit_distance, preds, target, **kwargs)
    _same(tF.extended_edit_distance, jF.extended_edit_distance, "Dr. Smith paid $3.50, e.g. today!", ["Dr Smith paid 3.50"])


@pytest.mark.parametrize("accumulate", ["best", "avg"])
def test_rouge_options(accumulate):
    preds, target = corpus(8, 11, refs=3, sentences=True)
    keys = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
    _same(tF.rouge_score, jF.rouge_score, preds, target, accumulate=accumulate, rouge_keys=keys)
    _same(tF.rouge_score, jF.rouge_score, preds, target, accumulate=accumulate, use_stemmer=True)
    _same(tF.rouge_score, jF.rouge_score, preds[0], target[0][0], accumulate=accumulate, rouge_keys="rougeL")
    flat = [t[0] for t in target]
    _same(tF.rouge_score, jF.rouge_score, preds, flat, accumulate=accumulate,
          normalizer=lambda s: s.upper(), tokenizer=lambda s: s.split())


def test_rouge_lcs_is_the_table_length():
    from torchmetrics_tpu.functional.text import rouge as jr
    from torchmetrics_tpu_torch.functional.text import rouge as tr

    rng = np.random.default_rng(12)
    for _ in range(30):
        a = list(rng.choice(_WORDS[:8], size=rng.integers(0, 15)))
        b = list(rng.choice(_WORDS[:8], size=rng.integers(0, 15)))
        assert tr._lcs(a, b) == jr._lcs(a, b) == int(jr._lcs_table(a, b)[-1, -1])


def test_rouge_compute_over_a_synced_state():
    got = tF.rouge._rouge_score_compute({"rouge1_fmeasure": torch.tensor([0.2, 0.4, 0.6])}, "cpu")
    assert got["rouge1_fmeasure"].shape == ()
    np.testing.assert_allclose(float(got["rouge1_fmeasure"]), 0.4, rtol=VALUE_RTOL)
    got = tF.rouge._rouge_score_compute({"rouge1_fmeasure": [0.25, torch.tensor([0.5, 0.75])], "x": []}, "cpu")
    assert float(got["rouge1_fmeasure"]) == 0.5 and float(got["x"]) == 0.0


def test_input_errors_match():
    cases = [
        (tF.bleu_score, jF.bleu_score, (["a"], [["a"], ["b"]]), {}),
        (tF.sacre_bleu_score, jF.sacre_bleu_score, (["a"], [["a"]]), {"tokenize": "ja-mecab"}),
        (tF.chrf_score, jF.chrf_score, (["a"], [["a"]]), {"n_char_order": 0}),
        (tF.chrf_score, jF.chrf_score, (["a"], [["a"]]), {"beta": -1.0}),
        (tF.translation_edit_rate, jF.translation_edit_rate, (["a"], [["a"]]), {"normalize": 1}),
        (tF.extended_edit_distance, jF.extended_edit_distance, (["a"], [["a"]]), {"alpha": 1}),
        (tF.extended_edit_distance, jF.extended_edit_distance, (["a"], [["a"]]), {"language": "de"}),
        (tF.rouge_score, jF.rouge_score, (["a"], ["a"]), {"rouge_keys": "rougeX"}),
        (tF.rouge_score, jF.rouge_score, (["a"], ["a"]), {"accumulate": "max"}),
        (tF.squad, jF.squad, ([{"prediction": "a", "id": 1}], [{"answers": {"text": ["a"]}, "id": 1}]), {}),
    ]
    for port_fn, jax_fn, args, kwargs in cases:
        with pytest.raises(Exception) as want:
            jax_fn(*args, **kwargs)
        with pytest.raises(type(want.value)) as got:
            port_fn(*args, **kwargs, device="cpu")
        assert str(got.value) == str(want.value)


def test_functionals_default_to_the_card():
    """Without ``device`` a text functional runs on the card, and refuses without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legal here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tF.word_error_rate(["a b"], ["a c"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tF.bleu_score(["a b"], [["a c"]])


# ---------------------------------------------------------------- perplexity


def _lm_batch(seed: int, dtype=np.float32, b: int = 3, t: int = 7, v: int = 50, ignore: float = 0.1):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, t, v)) * 3).astype(dtype)
    target = rng.integers(0, v, (b, t)).astype(np.int64)
    target[rng.random((b, t)) < ignore] = -100
    return logits, target


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_three_levels(dtype, ignore_index):
    data = [_lm_batch(s, ignore=0.1 if ignore_index is not None else 0.0) for s in range(4)]
    if dtype == "bfloat16":
        data = [(torch.from_numpy(l).to(torch.bfloat16), t) for l, t in data]
        pdata = [(l, torch.from_numpy(t)) for l, t in data]
        jdata = [(jnp.asarray(l.to(torch.float32).numpy()).astype(jnp.bfloat16), jnp.asarray(t)) for l, t in data]
    else:
        pdata = [(torch.from_numpy(l), torch.from_numpy(t)) for l, t in data]
        jdata = [(jnp.asarray(l), jnp.asarray(t)) for l, t in data]
    port, ref = tt.Perplexity(ignore_index=ignore_index, device="cpu"), jt.Perplexity(ignore_index=ignore_index)
    for (pa, pt), (ja, jtg) in zip(pdata, jdata):
        assert_close(port(pa, pt), ref(ja, jtg), 0.0, PPL_RTOL, "forward")
    assert port.count.dtype == torch.int32 and int(port.count) == int(ref.count)
    np.testing.assert_allclose(float(port.total_log_probs), float(ref.total_log_probs), rtol=PPL_RTOL)
    assert_close(port.compute(), ref.compute(), 0.0, PPL_RTOL, "compute")
    a, b = tt.Perplexity(ignore_index=ignore_index, device="cpu"), tt.Perplexity(ignore_index=ignore_index, device="cpu")
    for i, (pa, pt) in enumerate(pdata):
        (a if i < 2 else b).update(pa, pt)
    a.merge_state(b)
    assert int(a.count) == int(ref.count)
    assert_close(a.compute(), ref.compute(), 0.0, PPL_RTOL, "merged")
    assert_close(tF.perplexity(*pdata[0], ignore_index=ignore_index), jF.perplexity(*jdata[0], ignore_index=ignore_index),
                 0.0, PPL_RTOL, "functional")


def test_perplexity_gradient_matches_jax_grad():
    logits, target = _lm_batch(9)
    x = torch.from_numpy(logits).requires_grad_(True)
    tF.perplexity(x, torch.from_numpy(target), ignore_index=-100).backward()
    want = jax.grad(lambda z: jF.perplexity(z, jnp.asarray(target), ignore_index=-100))(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert tt.Perplexity.is_differentiable


def test_perplexity_input_errors_match():
    logits, target = _lm_batch(1)
    for args in ((logits[0], target), (logits, target[0]), (logits[:, :3], target), (logits, target.astype(np.float32)),
                 (logits.astype(np.int32), target)):
        with pytest.raises(Exception) as want:
            jF.perplexity(*map(jnp.asarray, args))
        with pytest.raises(type(want.value)):
            tF.perplexity(*map(torch.from_numpy, args))
    with pytest.raises(ValueError, match="ignore_index"):
        tt.Perplexity(ignore_index=0.5, device="cpu")


# ---------------------------------------------------------------- the engine and the collection


def _engine_stats(make, data, engine_ctx):
    with engine_ctx(True):
        m = make()
        for args in data:
            m.update(*args)
    return m, m._engine.stats


def test_engine_split():
    """String updates fall back (``non-tensor-input`` in the port, ``non-array-input`` in
    the JAX engine), list states fall back as ``list-state``; perplexity replays. The
    engine runs give the eager states."""
    from torchmetrics_tpu.engine import engine_context as jax_engine_context
    from torchmetrics_tpu_torch.engine import engine_context

    data = batches(3, seed=13, refs=1)
    for name, kwargs, reason in (
        ("BLEUScore", {}, "non-tensor-input"),
        ("TranslationEditRate", {}, "non-tensor-input"),
        ("CHRFScore", {"return_sentence_level_score": True}, "list-state"),
        ("ROUGEScore", {}, "list-state"),
        ("ExtendedEditDistance", {}, "list-state"),
    ):
        port, pst = _engine_stats(lambda: getattr(tt, name)(**kwargs, device="cpu"), data, engine_context)
        with jax.enable_x64(False):
            _, jst = _engine_stats(lambda: getattr(jt, name)(**kwargs), data, lambda on: jax_engine_context(on, donate=True))
        jax_reasons = {("non-tensor-input" if r == "non-array-input" else r): n for r, n in jst.fallback_reasons.items()}
        assert dict(pst.fallback_reasons) == jax_reasons == {reason: 3}, (name, dict(pst.fallback_reasons))
        assert pst.dispatches == jst.dispatches == 0
        eager = getattr(tt, name)(**kwargs, device="cpu", compiled_update=False)
        for args in data:
            eager.update(*args)
        assert_text_states(port, eager)
    lm = [_lm_batch(s) for s in range(4)]
    with engine_context(True):
        ppl = tt.Perplexity(ignore_index=-100, device="cpu")
        for logits, target in lm:
            ppl.update(torch.from_numpy(logits), torch.from_numpy(target))
    st = ppl._engine.stats
    assert st.dispatches == 4 and st.eager_fallbacks == 0, dict(st.fallback_reasons)
    eager = tt.Perplexity(ignore_index=-100, device="cpu", compiled_update=False)
    for logits, target in lm:
        eager.update(torch.from_numpy(logits), torch.from_numpy(target))
    assert int(ppl.count) == int(eager.count) and torch.equal(ppl.total_log_probs, eager.total_log_probs)


def test_host_collection_against_members():
    """The host metrics in one ``MetricCollection`` give each member's own values, in both
    packages."""
    from torchmetrics_tpu import MetricCollection as JC
    from torchmetrics_tpu_torch import MetricCollection as TC

    def members(pkg, **kw):
        return {
            "bleu": pkg.BLEUScore(**kw), "sacre": pkg.SacreBLEUScore(**kw), "chrf": pkg.CHRFScore(**kw),
            "ter": pkg.TranslationEditRate(**kw), "eed": pkg.ExtendedEditDistance(**kw), "wer": pkg.WordErrorRate(**kw),
            "cer": pkg.CharErrorRate(**kw), "mer": pkg.MatchErrorRate(**kw), "wil": pkg.WordInfoLost(**kw),
            "wip": pkg.WordInfoPreserved(**kw), "rouge": pkg.ROUGEScore(**kw),
        }

    data = batches(3, size=4, seed=14, refs=1, sentences=True)
    flat = [(p, [t[0] for t in ts]) for p, ts in data]
    port, ref = TC(members(tt, device="cpu")), JC(members(jt))
    for p, t in flat:
        port.update(p, t)
        ref.update(p, t)
    assert_close(port.compute(), ref.compute(), 0.0, VALUE_RTOL, "collection")
    alone = members(tt, device="cpu")
    for m in alone.values():
        for p, t in flat:
            m.update(p, t)
    got = port.compute()
    for key, m in alone.items():
        value = m.compute()
        for k, v in (value.items() if isinstance(value, dict) else [(key, value)]):
            assert float(got[k]) == float(v), k


def test_root_aliases_warn_and_export():
    import torchmetrics_tpu_torch as tm

    for name in ("BLEUScore", "WordErrorRate", "Perplexity", "SQuAD"):
        with pytest.warns(Warning):
            getattr(tm, name)(device="cpu")
        assert issubclass(getattr(tm, name), getattr(tt, name))
    assert tm.BERTScore is tt.BERTScore and tm.InfoLM is tt.InfoLM and tm.ROUGEScore is tt.ROUGEScore
    assert sorted(tt.__all__) == sorted(jt.__all__) and sorted(tF.__all__) == sorted(jF.__all__)
