"""The port's tokenizer against the JAX package's pure-Python path: the
copied vocabulary files byte for byte, and tokens, ids and decode over a
corpus and under hypothesis fuzzing."""

from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mvlt_tpu.text import tokenizer as jtok
from mvlt_tpu_torch.text import tokenizer as ptok

REPO = Path(__file__).resolve().parents[1]

CORPUS = [
    "is there a nodule in the left lung ?",
    "What modality is used to take this image?",
    "Does the picture contain liver? [END]",
    "Café naïve résumé — Ångström façade",          # accents
    "肺部有没有结节？ 胸部X线",                       # CJK
    "x-ray: 3.5cm mass, (right) upper-lobe; no pneumothorax!!",
    "[CLS] which organ [MASK] abnormal [SEP] [END]",
    "abc[END]def [MASK]ghi[MASK] [PAD]",            # specials inside words
    "a" * 101 + " " + "b" * 100,                     # over-long word
    "\t tabs\nand\r\nnewlines  nbsp ​ zero-width",
    "emoji 🙂 and control \x00\x07 chars �",
    "",
    "UPPER Case MiXeD 12345 $^`~ punctuation",
]


@pytest.fixture(scope="module")
def toks():
    return jtok.WordPieceTokenizer(), ptok.WordPieceTokenizer()


def test_vocab_files_are_byte_copies():
    for name in ("vocab.txt", "special_tokens_map.json"):
        a = (REPO / "mvlt_tpu" / "text" / name).read_bytes()
        b = (REPO / "mvlt_tpu_torch" / "text" / name).read_bytes()
        assert a == b, name
    assert ptok.find_default_vocab() == str(
        REPO / "mvlt_tpu_torch" / "text" / "vocab.txt")
    assert len((REPO / "mvlt_tpu_torch" / "text" / "vocab.txt")
               .read_text(encoding="utf-8").splitlines()) == 30522


def test_special_ids_and_size(toks):
    j, p = toks
    assert len(p) == len(j) == 30522
    for name in ("eos", "pad", "cls", "sep", "mask"):
        assert getattr(p, f"{name}_token_id") == getattr(j, f"{name}_token_id")
    assert p.eos_token_id == 104


@pytest.mark.parametrize("text", CORPUS)
def test_tokens_ids_decode_match_jax(toks, text):
    j, p = toks
    assert p.tokenize(text) == j.tokenize(text)
    ids = p.encode(text)
    assert ids == j.convert_tokens_to_ids(j.tokenize(text))
    assert ids == j.encode(text)
    assert p.convert_ids_to_tokens(ids) == j.convert_ids_to_tokens(ids)
    assert p.decode(ids) == j.decode(ids)
    assert p.decode(ids, stop_tokens=()) == j.decode(ids, stop_tokens=())


def test_with_tokenizer_matches_jax(toks):
    from mvlt_tpu.config import MVLTConfig as JaxConfig
    from mvlt_tpu_torch.config import MVLTConfig
    j, p = toks
    a = JaxConfig.for_vqa().with_tokenizer(j)
    b = MVLTConfig.for_vqa().with_tokenizer(p)
    assert a.to_json() == b.to_json()
    assert MVLTConfig.from_json(a.to_json()) == b


_TEXT = st.lists(st.sampled_from(
    list("abcdefxyz ABC09.,?!-'[]#é中\t\n") +
    ["[END]", "[MASK]", "[SEP]", "##", " lung ", "nodule", " "]),
    max_size=40).map("".join)


@settings(max_examples=150, deadline=None)
@given(text=_TEXT)
def test_fuzzed_tokenization_matches_jax(text):
    j, p = _FUZZ
    assert p.tokenize(text) == j.tokenize(text)
    ids = p.encode(text)
    assert ids == j.encode(text)
    assert p.decode(ids) == j.decode(ids)


@settings(max_examples=100, deadline=None)
@given(text=st.text(max_size=40))
def test_fuzzed_unicode_matches_jax(text):
    j, p = _FUZZ
    assert p.tokenize(text) == j.tokenize(text)


_FUZZ = (jtok.WordPieceTokenizer(), ptok.WordPieceTokenizer())
