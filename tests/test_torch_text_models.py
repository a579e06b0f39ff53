"""The port's model-backed text metrics (BERTScore, InfoLM) against the JAX package on
the CPU, the state carry of their string lists, and their sync.

Both packages get one numpy embedding table (BERTScore: a table-lookup "encoder") or
one numpy distribution function (InfoLM), the same numpy-returning tokenizers (fixed
width, ragged, dynamic width) and the same seeded sentences, at the three protocol
levels of ``tests/differential/harness.py``. The HF route runs on a tiny
``BertForMaskedLM`` saved with ``save_pretrained`` as torch weights: the port loads it
through ``transformers``' torch classes, the JAX package through its ``from_pt``
conversion, so both read one checkpoint.

Tolerances: the injected routes relative ``VALUE_RTOL`` with absolute ``VALUE_ATOL``
(float32 cosines and sums in another order); the HF route ``HF_ATOL`` (Flax against torch
forwards of the same weights, as ``tests/text/test_hf_backed.py`` holds them).
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as jF
import torchmetrics_tpu.text as jt
import torchmetrics_tpu_torch.functional.text as tF
import torchmetrics_tpu_torch.text as tt
from tests.test_torch_sync_guard import run_two_ranks
from tests.test_torch_text_host import assert_text_states, corpus
from tests.torch_parity import assert_close
from torchmetrics_tpu_torch.interop import state_from_jax

VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
HF_ATOL = 1e-4

VOCAB, DIM, WIDTH = 97, 16, 12
_TABLE = np.random.default_rng(0).standard_normal((VOCAB, DIM)).astype(np.float32)
_LOGITS = np.random.default_rng(1).standard_normal((VOCAB, 33)).astype(np.float32)


def _ids(sentence: str) -> list:
    return [1] + [sum(map(ord, w)) % (VOCAB - 3) + 3 for w in sentence.split()][: WIDTH - 2] + [2]


def tokenizer(sentences, width: int = WIDTH):
    """Fixed-width numpy tokens: [CLS]=1 ... [SEP]=2, zero padding."""
    ids = np.zeros((len(sentences), width), np.int64)
    mask = np.zeros((len(sentences), width), np.int64)
    for i, s in enumerate(sentences):
        t = _ids(s)
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def dynamic_tokenizer(sentences):
    """Pads each batch to its own longest sentence."""
    return tokenizer(sentences, width=max(len(_ids(s)) for s in sentences))


def jax_encoder(ids, mask):
    return jnp.asarray(_TABLE)[jnp.asarray(ids)] * jnp.asarray(mask)[..., None]


def torch_encoder(ids, mask):
    return torch.from_numpy(_TABLE).to(ids.device)[ids] * mask[..., None]


def _distribution(sentences) -> np.ndarray:
    """A sentence's distribution over 33 tokens: the softmax of its words' mean logits."""
    rows = np.stack([_LOGITS[_ids(s)[1:-1] or [0]].mean(0) for s in sentences]).astype(np.float64)
    e = np.exp(rows - rows.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def jax_lm(sentences):
    return jnp.asarray(_distribution(sentences))


def torch_lm(sentences):
    return torch.from_numpy(_distribution(sentences))


def sentence_batches(n_batches: int = 3, size: int = 4, seed: int = 20):
    """Ragged: batch ``b`` holds ``size - 1 + b % 3`` pairs."""
    out = []
    for b in range(n_batches):
        p, t = corpus(size - 1 + b % 3, seed + b)
        out.append((p, [r[0] for r in t]))
    return out


def _three_levels(make_port, make_ref, data, rtol=VALUE_RTOL, atol=VALUE_ATOL):
    port, ref = make_port(), make_ref()
    for i, args in enumerate(data):
        assert_close(port(*args), ref(*args), atol, rtol, f"forward {i}")
    assert_text_states(port, ref)
    epoch = ref.compute()
    assert_close(port.compute(), epoch, atol, rtol, "compute")
    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, args in enumerate(data):
        (pa if i < len(data) // 2 else pb).update(*args)
        (ra if i < len(data) // 2 else rb).update(*args)
    pa.merge_state(pb)
    ra.merge_state(rb)
    assert_text_states(pa, ra)
    assert_close(pa.compute(), ra.compute(), atol, rtol, "merged compute")
    assert_close(pa.compute(), epoch, atol, rtol, "merged against one instance")


# ---------------------------------------------------------------- BERTScore


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_three_levels(idf):
    kw = {"idf": idf, "max_length": WIDTH}
    _three_levels(
        lambda: tt.BERTScore(model=torch_encoder, user_tokenizer=dynamic_tokenizer, **kw, device="cpu"),
        lambda: jt.BERTScore(model=jax_encoder, user_tokenizer=dynamic_tokenizer, **kw),
        sentence_batches(),
    )


@pytest.mark.parametrize("buckets", ["1", "0"])
def test_bert_score_functional(monkeypatch, buckets):
    """The port runs the encoder on the rows and widths the tokenizer gave (11 rows, not
    a bucket of 16), against the JAX package with its power-of-two padding on and off."""
    monkeypatch.setenv("TORCHMETRICS_TPU_BERT_BUCKETS", buckets)  # read by the JAX package only
    preds, target = sentence_batches(1, size=11)[0]
    seen = []

    def recording_encoder(ids, mask):
        seen.append(tuple(ids.shape))
        return torch_encoder(ids, mask)

    for idf in (False, True):
        for tok in (tokenizer, dynamic_tokenizer):
            seen.clear()
            got = tF.bert_score(preds, target, model=recording_encoder, user_tokenizer=tok, idf=idf, device="cpu")
            want = jF.bert_score(preds, target, model=jax_encoder, user_tokenizer=tok, idf=idf)
            assert_close(got, want, VALUE_ATOL, VALUE_RTOL, f"idf={idf}")
            assert got["f1"].shape == (len(preds),)
            widths = [tok(preds)["input_ids"].shape[1], tok(target)["input_ids"].shape[1]]
            assert seen == [(len(preds), w) for w in widths]
    same = tF.bert_score(preds, preds, model=torch_encoder, user_tokenizer=tokenizer, device="cpu")
    np.testing.assert_allclose(same["f1"].numpy(), 1.0, atol=1e-6)


def test_bert_score_ragged_widths_and_errors():
    """A tokenizer that pads per batch gives one state width; a batch wider than
    ``max_length`` raises as in the JAX package; without a model the curated errors."""
    m = tt.BERTScore(model=torch_encoder, user_tokenizer=dynamic_tokenizer, max_length=WIDTH, device="cpu")
    m.update(["short one"], ["short one"])
    m.update(["a much longer sentence with many words"], ["a much longer sentence with many words"])
    assert {tuple(x.shape) for x in m.pred_input_ids} == {(1, WIDTH)}
    np.testing.assert_allclose(m.compute()["f1"].numpy(), 1.0, atol=1e-6)
    for pkg, enc in ((tt, torch_encoder), (jt, jax_encoder)):
        kw = {"device": "cpu"} if pkg is tt else {}
        with pytest.raises(ValueError, match="max_length=4"):
            pkg.BERTScore(model=enc, user_tokenizer=dynamic_tokenizer, max_length=4, **kw).update(["a b c d e"], ["x"])
    with pytest.raises(ModuleNotFoundError, match="Default transformer backbones"):
        tF.bert_score(["a"], ["a"], device="cpu")
    with pytest.raises(ValueError, match="same"):
        tF.bert_score(["a", "b"], ["a"], model=torch_encoder, user_tokenizer=tokenizer, device="cpu")
    raw = tt.BERTScore(device="cpu")  # no tokenizer: the sentences are kept as strings
    raw.update(["a b"], ["a c"])
    assert raw.preds == ["a b"] and raw.target == ["a c"] and raw.pred_input_ids == []


def test_greedy_cosine_matches_jax():
    from torchmetrics_tpu.functional.text.bert import _greedy_cosine_scores as jg
    from torchmetrics_tpu_torch.functional.text.bert import _greedy_cosine_scores as tg

    rng = np.random.default_rng(3)
    pe, te = rng.standard_normal((5, 7, 8)).astype(np.float32), rng.standard_normal((5, 9, 8)).astype(np.float32)
    pm, tm = (rng.random((5, 7)) < 0.8).astype(np.float32), (rng.random((5, 9)) < 0.8).astype(np.float32)
    pm[:, 0] = tm[:, 0] = 1
    pw, tw = pm * rng.random((5, 7)).astype(np.float32), tm * rng.random((5, 9)).astype(np.float32)
    got = tg(*map(torch.from_numpy, (pe, pm, te, tm, pw, tw)))
    want = jax.vmap(lambda *a: a)(*jg(*map(jnp.asarray, (pe, pm, te, tm, pw, tw))))
    assert_close(got, want, VALUE_ATOL, VALUE_RTOL, "greedy cosine")


# ---------------------------------------------------------------- InfoLM

_MEASURES = [
    ("kl_divergence", None, None),
    ("alpha_divergence", 0.5, None),
    ("beta_divergence", None, 0.5),
    ("ab_divergence", 0.5, 0.3),
    ("renyi_divergence", 0.5, None),
    ("l1_distance", None, None),
    ("l2_distance", None, None),
    ("l_infinity_distance", None, None),
    ("fisher_rao_distance", None, None),
]


def test_infolm_three_levels():
    kw = {"information_measure": "alpha_divergence", "alpha": 0.5}
    _three_levels(
        lambda: tt.InfoLM(model=torch_lm, **kw, device="cpu"), lambda: jt.InfoLM(model=jax_lm, **kw), sentence_batches()
    )


def test_infolm_measures():
    """The nine measures over float64 distributions: the alpha / beta divergences subtract
    terms of one size, which turns float32's one-ulp ``pow`` differences between XLA and
    torch into ~1e-4 relative ones, so they are held in float64."""
    preds, target = sentence_batches(1, size=9)[0]

    def lm64(sentences):
        return _distribution(sentences).astype(np.float64)

    for measure, alpha, beta in _MEASURES:
        kw = {"information_measure": measure, "alpha": alpha, "beta": beta, "return_sentence_level_score": True}
        got = tF.infolm(preds, target, model=lambda s: torch.from_numpy(lm64(s)), **kw, device="cpu")
        want = jF.infolm(preds, target, model=lambda s: jnp.asarray(lm64(s)), **kw)
        assert_close(got, want, VALUE_ATOL, VALUE_RTOL, measure)
    for bad in ({"information_measure": "cosine"}, {"information_measure": "alpha_divergence"},
                {"information_measure": "alpha_divergence", "alpha": 1.0},
                {"information_measure": "ab_divergence", "alpha": 0.5, "beta": -0.5}):
        with pytest.raises(ValueError) as want:
            jF.infolm(preds, target, model=jax_lm, **bad)
        with pytest.raises(ValueError) as got:
            tF.infolm(preds, target, model=torch_lm, **bad, device="cpu")
        assert str(got.value) == str(want.value)


def test_engine_split():
    """BERTScore and InfoLM keep list states: every update falls back in both engines."""
    from torchmetrics_tpu.engine import engine_context as jax_engine_context
    from torchmetrics_tpu_torch.engine import engine_context

    data = sentence_batches(2)
    for make_port, make_ref in (
        (lambda: tt.BERTScore(model=torch_encoder, user_tokenizer=tokenizer, device="cpu"),
         lambda: jt.BERTScore(model=jax_encoder, user_tokenizer=tokenizer)),
        (lambda: tt.InfoLM(model=torch_lm, device="cpu"), lambda: jt.InfoLM(model=jax_lm)),
    ):
        with engine_context(True):
            port = make_port()
            for args in data:
                port.update(*args)
        with jax.enable_x64(False), jax_engine_context(True, donate=True):
            ref = make_ref()
            for args in data:
                ref.update(*args)
        assert dict(port._engine.stats.fallback_reasons) == dict(ref._engine.stats.fallback_reasons) == {"list-state": 2}


# ---------------------------------------------------------------- the state carry (string lists)


def test_infolm_string_states_carry_from_jax():
    """A JAX ``InfoLM`` with an injected model keeps its sentences as ``<U`` arrays in its
    state dict; they carry into the port as ``str`` and the value is the JAX one. Before
    the repair, ``state_from_jax`` raised ``TypeError`` on them."""
    data = sentence_batches(2)
    ref = jt.InfoLM(model=jax_lm)
    ref.persistent(True)
    for args in data:
        ref.update(*args)
    sd = ref.state_dict()
    assert np.asarray(sd["preds"][0]).dtype.kind == "U"
    carried = state_from_jax(sd, "cpu")
    assert all(type(s) is str for s in carried["preds"] + carried["target"])
    port = tt.InfoLM(model=torch_lm, device="cpu")
    port.load_state_dict(carried)
    assert port.preds == [s for p, _ in data for s in p] and port.update_count == 2
    assert_close(port.compute(), ref.compute(), VALUE_ATOL, VALUE_RTOL, "carried InfoLM")
    # and the port's own state dict round-trips the strings
    port.persistent(True)
    again = tt.InfoLM(model=torch_lm, device="cpu")
    again.load_state_dict(port.state_dict())
    assert again.target == port.target


def test_bert_score_tokenized_states_carry_from_jax():
    data = sentence_batches(2)
    kw = {"idf": True, "max_length": WIDTH}
    ref = jt.BERTScore(model=jax_encoder, user_tokenizer=tokenizer, **kw)
    ref.persistent(True)
    for args in data:
        ref.update(*args)
    port = tt.BERTScore(model=torch_encoder, user_tokenizer=tokenizer, **kw, device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.pred_input_ids[0].dtype == torch.int32
    assert_text_states(port, ref)
    assert_close(port.compute(), ref.compute(), VALUE_ATOL, VALUE_RTOL, "carried BERTScore")


def test_pickle_drops_the_resolved_callables():
    m = tt.BERTScore(model=torch_encoder, user_tokenizer=tokenizer, device="cpu")
    m.update(*sentence_batches(1)[0])
    assert m._resolved
    clone = pickle.loads(pickle.dumps(m))
    assert clone._resolved is False and clone._forward_fn is None
    assert_close(clone.compute(), m.compute(), 0.0, 0.0, "clone")


# ---------------------------------------------------------------- sync over two ranks

_SYNC_BODY = """
import numpy as np, torch
from torchmetrics_tpu_torch.text import BERTScore, InfoLM
from torchmetrics_tpu_torch.parallel import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

TABLE = torch.from_numpy(np.random.default_rng(0).standard_normal((97, 16)).astype(np.float32))

def torch_encoder(ids, mask):
    return TABLE[ids] * mask[..., None]

def torch_lm(sentences):
    return torch.softmax(torch.tensor([[float(len(s)), 1.0, 0.5] for s in sentences]), dim=-1)

def tokenizer(sentences, width=12):
    ids = np.zeros((len(sentences), width), np.int64)
    for i, s in enumerate(sentences):
        t = [1] + [sum(map(ord, w)) % 94 + 3 for w in s.split()][: width - 2] + [2]
        ids[i, : len(t)] = t
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}

def sentence_batches(n, seed):
    rng = np.random.default_rng(seed)
    words = ["the", "a", "cat", "dog", "sat", "ran", "on", "mat", "park", "green"]
    return [([" ".join(rng.choice(words, 5)) for _ in range(4)], [" ".join(rng.choice(words, 4)) for _ in range(4)])
            for _ in range(n)]

def _raises(call):
    try:
        call()
    except TorchMetricsUserError as err:
        return str(err)
    return None

def run(rank):
    data = sentence_batches(2, 40 + rank)
    out = {}
    for route, sync_fn in (("packed", None), ("eager", gather_all_tensors)):
        m = BERTScore(model=torch_encoder, user_tokenizer=tokenizer, idf=True, device="cpu", dist_sync_fn=sync_fn)
        for p, t in data:
            m.update(p, t)
        out[route] = {k: v.tolist() for k, v in m.compute().items()}  # compute syncs
        out[route + "_rows"] = len(out[route]["f1"])
        out[route + "_local_rows"] = int(sum(x.shape[0] for x in m.pred_input_ids))  # unsynced after
    raw = InfoLM(model=torch_lm, device="cpu")  # raw sentences: a None-reduced string list
    raw.update(*data[0])
    local = list(raw.preds)
    raw.sync(dist_sync_fn=gather_all_tensors)
    out["strings_untouched"] = raw.preds == local
    raw.unsync()
    ragged = BERTScore(model=torch_encoder, user_tokenizer=tokenizer, device="cpu")
    if rank == 0:
        ragged.update(*data[0])
    out["ragged"] = _raises(lambda: ragged.sync(dist_sync_fn=gather_all_tensors))
    return out
"""


def test_tokenized_states_sync_over_two_ranks(tmp_path):
    """The token ``cat`` states ride the packed route and ``gather_all_tensors`` over gloo:
    both ranks score the whole corpus, as one metric over both ranks' updates does; raw
    string lists pass through untouched; a rank with token states and a rank without raise
    on both ranks (the port's own list-state guard; the JAX package's counterpart test is a
    reference caveat)."""
    results = run_two_ranks(tmp_path, _SYNC_BODY)
    scope: dict = {}
    exec(_SYNC_BODY, scope)  # the ranks' encoder, tokenizer and data, in this process
    whole = tt.BERTScore(model=scope["torch_encoder"], user_tokenizer=scope["tokenizer"], idf=True, device="cpu")
    for rank in range(2):
        for p, t in scope["sentence_batches"](2, 40 + rank):
            whole.update(p, t)
    want = whole.compute()
    for res in results:
        assert res["ok"], res
        assert res["packed_rows"] == res["eager_rows"] == 16 and res["packed_local_rows"] == 8
        for route in ("packed", "eager"):
            for k in ("precision", "recall", "f1"):
                np.testing.assert_allclose(res[route][k], want[k].numpy(), rtol=VALUE_RTOL, atol=VALUE_ATOL)
        assert res["strings_untouched"] is True
        assert res["ragged"] is not None and "deadlock" in res["ragged"]


# ---------------------------------------------------------------- the HF route

_HF_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "the", "cat", "sat", "on", "mat", "a",
             "dog", "ran", "in", "park"]


@pytest.fixture(scope="module")
def tiny_bert_pt_dir(tmp_path_factory):
    """A tiny ``BertForMaskedLM`` saved as torch weights with its WordPiece tokenizer."""
    import transformers

    d = tmp_path_factory.mktemp("tiny_bert_pt_port")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(_HF_VOCAB))
    transformers.BertTokenizer(str(vocab)).save_pretrained(str(d))
    config = transformers.BertConfig(
        vocab_size=len(_HF_VOCAB), hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=64,
    )
    torch.manual_seed(0)
    transformers.BertForMaskedLM(config).save_pretrained(str(d), safe_serialization=False)
    return str(d)


_HF_PREDS = ["hello world", "the cat sat on the mat", "a dog ran in the park"]
_HF_TARGET = ["hello world", "the dog sat on a mat", "the cat ran"]


def test_hf_bert_score_against_jax(tiny_bert_pt_dir):
    for kw in ({"max_length": 16, "idf": True, "num_layers": 1},):
        got = tF.bert_score(_HF_PREDS, _HF_TARGET, model_name_or_path=tiny_bert_pt_dir, **kw, device="cpu")
        want = jF.bert_score(_HF_PREDS, _HF_TARGET, model_name_or_path=tiny_bert_pt_dir, **kw)
        assert_close(got, want, HF_ATOL, 0.0, f"bert_score {kw}")
    m = tt.BERTScore(model_name_or_path=tiny_bert_pt_dir, max_length=16, idf=True, device="cpu")
    r = jt.BERTScore(model_name_or_path=tiny_bert_pt_dir, max_length=16, idf=True)
    for i in range(2):
        m.update(_HF_PREDS[i : i + 2], _HF_TARGET[i : i + 2])
        r.update(_HF_PREDS[i : i + 2], _HF_TARGET[i : i + 2])
    assert_text_states(m, r)
    assert_close(m.compute(), r.compute(), HF_ATOL, 0.0, "BERTScore")
    clone = pickle.loads(pickle.dumps(m))
    assert clone._resolved is False
    assert_close(clone.compute(), m.compute(), 0.0, 0.0, "clone")


def test_hf_infolm_against_jax(tiny_bert_pt_dir):
    """InfoLM runs one forward per token position (eagerly in flax on the JAX side), so
    it takes two short pairs."""
    preds, target = ["hello world", "the cat sat"], ["hello world", "a dog sat"]
    got = tF.infolm(preds, target, model_name_or_path=tiny_bert_pt_dir, return_sentence_level_score=True, device="cpu")
    want = jF.infolm(preds, target, model_name_or_path=tiny_bert_pt_dir, return_sentence_level_score=True)
    assert_close(got, want, HF_ATOL, 0.0, "infolm idf=True")
    m = tt.InfoLM(model_name_or_path=tiny_bert_pt_dir, idf=False, device="cpu")
    r = jt.InfoLM(model_name_or_path=tiny_bert_pt_dir, idf=False)
    m.update(preds, target)
    r.update(preds, target)
    assert m.preds == [] and len(m.pred_input_ids) == 1
    assert_text_states(m, r)
    assert_close(m.compute(), r.compute(), HF_ATOL, 0.0, "InfoLM")


def test_hf_shared_model_is_never_moved(tiny_bert_pt_dir):
    """The loader's cache shares one model between metrics: a metric on another device
    runs that device's copy, so a metric on the card and one on the CPU never move the
    model the other runs (``meta`` stands in for the card, which this machine lacks)."""
    from torchmetrics_tpu_torch.utilities import hf

    preds, target = ["hello world", "the cat sat"], ["hello world", "a dog sat"]
    before = tF.infolm(preds, target, model_name_or_path=tiny_bert_pt_dir, idf=False, device="cpu")
    model, _ = hf.load_hf_model_and_tokenizer(tiny_bert_pt_dir, "AutoModelForMaskedLM")
    elsewhere = hf.model_on(model, "meta")
    assert next(elsewhere.parameters()).device.type == "meta" and hf.model_on(model, "meta") is elsewhere
    assert hf.model_on(model, "cpu") is model and next(model.parameters()).device.type == "cpu"
    after = tF.infolm(preds, target, model_name_or_path=tiny_bert_pt_dir, idf=False, device="cpu")
    assert_close(after, before, 0.0, 0.0, "the CPU model after a copy elsewhere")
    assert next(model.parameters()).device.type == "cpu" and next(elsewhere.parameters()).device.type == "meta"


def test_hf_uncached_id_fails_cleanly(monkeypatch):
    import transformers

    from torchmetrics_tpu_torch.utilities import hf

    def not_cached(*args, **kwargs):
        raise OSError("no cached snapshot found (simulated offline hub)")

    hf.load_hf_model_and_tokenizer.cache_clear()
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", not_cached)
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", not_cached)
    with pytest.raises(ModuleNotFoundError, match="cached") as got:
        tF.bert_score(["x"], ["x"], model_name_or_path="no-such-org/no-such-model", device="cpu")
    from torchmetrics_tpu.utilities.hf import _load_error

    assert str(got.value) == str(_load_error("no-such-org/no-such-model", OSError("x")))
    hf.load_hf_model_and_tokenizer.cache_clear()
