"""The port's native tokenizers (``mvlt_tpu_torch/text/native.py`` over
``mvlt_tpu_torch/csrc/host``) against the JAX package's: the WordPiece ids
equal JAX's native ids and the Python ids on the packaged vocabulary and on
hypothesis-fuzzed ASCII text; the PTB output byte-equal to JAX's native
tokenizer's and to the port's Python one; non-ASCII text and text past the
4,096-id buffer fall through to Python as JAX's do; the library builds
once, atomically, under concurrent first uses, and a failed build raises.
"""

import concurrent.futures
import os
import string
import subprocess

import pytest
from hypothesis import given, settings, strategies as st

from mvlt_tpu.metrics import ptb as jptb
from mvlt_tpu.text import native as jnative
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu_torch.metrics import ptb
from mvlt_tpu_torch.text import native
from mvlt_tpu_torch.text.tokenizer import (WordPieceTokenizer,
                                           find_default_vocab)

VOCAB = find_default_vocab()        # the port's packaged vocab.txt
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SENTENCES = [
    "the heart size is normal .",
    "is there a nodule in the right lung ? [END]",
    "No Acute Cardiopulmonary Disease!!",
    "there is a small left-sided pleural effusion, stable.",
    "findings: 1. unremarkable mediastinum; 2. clear lungs [SEP] done",
    "x-ray shows q.r.s. abnormality w/ 5% change (mild)",
    "supercalifragilisticexpialidocious "
    "pneumonoultramicroscopicsilicovolcanoconiosis",
    "[CLS] hello [MASK] world [END]",
    "a[SEP]b",
    "",
    "a",
]

CAPTIONS = [
    "The heart is normal in size. The mediastinum is unremarkable.",
    "No acute cardiopulmonary abnormality (stable).",
    "There's a 2.5 cm nodule... it isn't calcified; see e.g. prior.",
    "Dr. Smith's patients' films: \"clear\" -- no change [1].",
    "",
]


@pytest.fixture(scope="module")
def jax_native():
    """JAX's library (``tests/conftest.py`` builds it with ``make -C
    csrc``)."""
    if jnative.load_library() is None:
        subprocess.run(["make", "-C", os.path.join(REPO, "csrc")], check=True)
    lib = jnative.load_library()
    assert lib is not None
    return jnative.NativeWordPiece(VOCAB, lib=lib)


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(VOCAB)


@pytest.fixture(scope="module")
def jtok():
    return JaxTokenizer(VOCAB)


def test_native_ids_equal_jax_native_and_python(tok, jtok, jax_native):
    """On the packaged vocabulary: the port's C++ ids, its ``encode`` and
    its Python ids equal JAX's native ids and JAX's ``encode``."""
    port = native.NativeWordPiece(VOCAB)
    assert port.vocab_size() == jax_native.vocab_size() == len(tok.vocab)
    for s in SENTENCES:
        want = jax_native.encode(s) if jtok._native_safe(s) else \
            jtok.encode(s)
        python = tok.convert_tokens_to_ids(tok.tokenize(s))
        assert tok.encode(s) == jtok.encode(s) == python, s
        if tok._native_safe(s):
            assert port.encode(s) == want == python, s


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet=string.printable, max_size=80))
def test_fuzzed_ascii_ids_equal_jax(tok, jtok, text):
    """Fuzzed ASCII text: the port's ``encode`` (native where the guard
    admits the text) equals its Python path and JAX's ``encode``."""
    python = tok.convert_tokens_to_ids(tok.tokenize(text))
    assert tok.encode(text) == python == jtok.encode(text)


def test_non_ascii_and_long_text_fall_through(tok, jtok):
    """Non-ASCII text takes the Python path, and so does text past the
    4,096-id buffer (the native call raises, ``encode`` falls back), as in
    JAX; ``ptb_tokenize_native`` gives None for non-ASCII."""
    for s in ("café naïve résumé", "lung — clear", "肺 normal"):
        assert not tok._native_safe(s)
        assert tok.encode(s) == tok.convert_tokens_to_ids(tok.tokenize(s)) \
            == jtok.encode(s)
        assert native.ptb_tokenize_native(s) is None
        assert ptb.ptb_tokenize(s) == jptb.ptb_tokenize(s)
    long = " ".join(["pneumothorax"] * 2100)
    with pytest.raises(ValueError):
        tok._native.encode(long)
    assert tok.encode(long) == jtok.encode(long) == \
        tok.convert_tokens_to_ids(tok.tokenize(long))
    assert len(tok.encode(long)) > native.MAX_IDS


@pytest.mark.parametrize("caption", CAPTIONS)
def test_native_ptb_is_byte_equal_to_jax(caption, jax_native):
    """The port's native PTB output equals JAX's native output and the
    port's Python tokenizer, byte for byte; ``ptb_tokenize`` returns it."""
    got = native.ptb_tokenize_native(caption)
    assert got is not None
    assert got == jnative.ptb_tokenize_native(caption)
    assert got == ptb.ptb_tokenize_py(caption) == ptb.ptb_tokenize(caption)
    assert got == jptb.ptb_tokenize(caption)


def test_build_is_atomic_and_a_failed_build_raises(monkeypatch, tmp_path):
    """Four first uses at once build one library into a fresh build
    directory (no temporary file left); a compiler that fails raises with
    its command."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: native.build(), range(4)))
    assert len(set(paths)) == 1 and paths[0].exists()
    assert paths[0].parent == tmp_path / "host"
    assert [p.name for p in (tmp_path / "host").iterdir()
            if not p.name.startswith(".")] == [paths[0].name]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "broken")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        native.build()
    assert not any(p.suffix == ".tmp" for p in (tmp_path / "broken").iterdir())
