"""Pure-Python WordPiece tokenizer of the port: a copy of
``mvlt_tpu/text/tokenizer.py`` (its pure-Python path), with its own copy of
the vocabulary beside it (``vocab.txt``, 30,522 lines, and
``special_tokens_map.json``, byte for byte the JAX package's).

It replaces the reference's HF ``BertTokenizer`` over
``dataset/bert-base-uncased/vocab.txt`` with the added ``[END]`` eos token
(reference ``run_vqa.py:205-206``) and reproduces bert-base-uncased:
lowercasing, accent stripping, punctuation splitting, CJK isolation, greedy
longest-match WordPiece, and whole special tokens. ``encode`` takes the
C++ fast path (:mod:`mvlt_tpu_torch.text.native`, built at first use) where
JAX's does: ASCII text whose special tokens stand as whole words, up to
4,096 ids; elsewhere this pure-Python path, which gives the same ids.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[END]")


def load_vocab(vocab_path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_path, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            vocab[token] = idx
    return vocab


def find_default_vocab() -> Optional[str]:
    """Locate a bert-base-uncased vocab.txt without network access.

    The package VENDORS the standard 30,522-entry bert-base-uncased
    ``vocab.txt`` (+ ``special_tokens_map.json``) next to this module —
    the framework tokenizes out of the box, matching the reference's
    in-repo ``dataset/bert-base-uncased/`` layout.  Search order:
    ``MVLT_VOCAB`` env var override, the packaged ``vocab.txt``, the
    reference-layout ``./dataset`` path, then (dev environments only)
    ``MVLT_DEV_VOCAB_ROOT/dataset/bert-base-uncased/vocab.txt``.
    Callers get ``None`` (and should fail loudly) when no vocab is
    found — there is no baked absolute path."""
    candidates = [
        os.environ.get("MVLT_VOCAB", ""),
        os.path.join(os.path.dirname(__file__), "vocab.txt"),
        "./dataset/bert-base-uncased/vocab.txt",
    ]
    dev_root = os.environ.get("MVLT_DEV_VOCAB_ROOT", "")
    if dev_root:
        candidates.append(os.path.join(
            dev_root, "dataset", "bert-base-uncased", "vocab.txt"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def synthetic_vocab_file(path: Optional[str] = None) -> str:
    """Generate a bert-base-uncased-SHAPED vocab for synthetic smoke runs.

    Same 30522-entry size and special-token layout as the reference's
    shipped vocab ([PAD]=0, [unused0..98]=1..99, [UNK]=100, [CLS]=101,
    [SEP]=102, [MASK]=103, [END]=104), with ascii letters/digits,
    continuation pieces and a small english/clinical word list so the
    synthetic datasets tokenize into real word pieces.  Cached under the
    tmp dir; regenerate by deleting the file."""
    import tempfile

    if path is None:
        path = os.path.join(tempfile.gettempdir(),
                            "mvlt_synthetic_vocab.txt")
    if os.path.exists(path):
        return path
    words = ("the a an is are was it this there no yes not and or of in on "
             "at to with within without normal abnormal clear stable mild "
             "moderate severe acute chronic right left upper lower lobe "
             "lung lungs heart cardiac size silhouette chest pleural "
             "effusion pneumothorax consolidation opacity nodule mass "
             "fracture degenerative unremarkable impression findings "
             "comparison seen noted present absent what where which how "
             "many does do patient image scan xray ray organ modality "
             "plane brain liver kidney bone tissue large small").split()
    lines = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "[END]"])
    ascii_chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    lines += list(ascii_chars) + ["##" + c for c in ascii_chars]
    lines += list(".,;:?!()-/")
    lines += sorted(set(words) - set(lines))   # 'a' is already a letter
    while len(lines) < 30522:
        lines.append(f"[fill{len(lines)}]")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines[:30522]) + "\n")
    os.replace(tmp, path)
    return path


def default_tokenizer(synthetic_ok: bool = False) -> "WordPieceTokenizer":
    """The drivers' tokenizer entry point: discovered vocab, or (for
    ``--synthetic`` smoke runs only) a generated stand-in vocab with the
    reference's special-token layout."""
    path = find_default_vocab()
    if path is None and synthetic_ok:
        path = synthetic_vocab_file()
    return WordPieceTokenizer(path)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode disagrees ($, ^, `)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with lowercasing + accent strip."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = ()):  # special tokens
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        # NFC-normalize like HF (transformers BasicTokenizer does this)
        text = unicodedata.normalize("NFC", text)
        tokens = text.split()
        out: List[str] = []
        for token in tokens:
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            out.extend(self._split_on_punc(token))
        return out

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(token: str) -> List[str]:
        chars = list(token)
        out: List[List[str]] = []
        start_new = True
        for ch in chars:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer with an extra ``[END]`` token.

    API mirrors what the reference uses from HF BertTokenizer:
    ``tokenize``, ``convert_tokens_to_ids``, ``convert_ids_to_tokens``,
    ``vocab``, ``len()``, ``eos/cls/sep/mask/pad_token(_id)``.
    """

    def __init__(self, vocab_path: Optional[str] = None,
                 do_lower_case: bool = True,
                 eos_token: str = "[END]"):
        if vocab_path is None:
            vocab_path = find_default_vocab()
            if vocab_path is None:
                raise FileNotFoundError(
                    "No vocab.txt found; set MVLT_VOCAB or pass vocab_path")
        self.vocab = load_vocab(vocab_path)
        self.eos_token = eos_token
        if eos_token not in self.vocab:
            # mirror tokenizer.add_special_tokens({'eos_token': '[END]'})
            self.vocab[eos_token] = len(self.vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token = "[UNK]"
        self.pad_token, self.cls_token = "[PAD]", "[CLS]"
        self.sep_token, self.mask_token = "[SEP]", "[MASK]"
        self.all_special_tokens = [t for t in SPECIAL_TOKENS if t in self.vocab]
        self.basic = BasicTokenizer(do_lower_case, never_split=self.all_special_tokens)
        self.max_input_chars_per_word = 100
        # the native fast path (csrc/host/tokenizer.cc), ASCII only; a
        # failed build raises
        from mvlt_tpu_torch.text.native import NativeWordPiece
        self._native = NativeWordPiece(vocab_path, do_lower_case, eos_token)

    # -- special token ids ------------------------------------------------
    @property
    def eos_token_id(self) -> int:
        return self.vocab[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    def __len__(self) -> int:
        return len(self.vocab)

    # -- tokenization ------------------------------------------------------
    def _split_on_special_tokens(self, text: str) -> List[str]:
        """Split text so special tokens survive whole (HF `tokenize` on a
        tokenizer with added special tokens)."""
        pieces = [text]
        for tok in self.all_special_tokens:
            next_pieces: List[str] = []
            for piece in pieces:
                if piece in self.all_special_tokens:
                    next_pieces.append(piece)
                    continue
                split = piece.split(tok)
                for i, sub in enumerate(split):
                    if i > 0:
                        next_pieces.append(tok)
                    if sub:
                        next_pieces.append(sub)
            pieces = next_pieces
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece in self._split_on_special_tokens(text):
            if piece in self.all_special_tokens:
                out.append(piece)
                continue
            for token in self.basic.tokenize(piece):
                if token in self.all_special_tokens:
                    out.append(token)
                else:
                    out.extend(self._wordpiece(token))
        return out

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        chars = list(token)
        sub_tokens: List[str] = []
        start = 0
        while start < len(chars):
            end = len(chars)
            cur = None
            while start < end:
                substr = "".join(chars[start:end])
                if start > 0:
                    substr = "##" + substr
                if substr in self.vocab:
                    cur = substr
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            sub_tokens.append(cur)
            start = end
        return sub_tokens

    # -- id conversion -----------------------------------------------------
    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab[self.unk_token])
        return [self.vocab.get(t, self.vocab[self.unk_token]) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, self.unk_token)
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def _native_safe(self, text: str) -> bool:
        """The C++ fast path only matches special tokens as whole
        whitespace-delimited words (the Python path splits them
        anywhere); fall back when one is embedded without boundaries."""
        if not text.isascii():
            return False
        if "[" in text:
            for sp in self.all_special_tokens:
                start = text.find(sp)
                while start != -1:
                    end = start + len(sp)
                    left_ok = start == 0 or text[start - 1].isspace()
                    right_ok = end == len(text) or text[end].isspace()
                    if not (left_ok and right_ok):
                        return False
                    start = text.find(sp, end)
        return True

    def encode(self, text: str) -> List[int]:
        if self._native_safe(text):
            try:
                return self._native.encode(text)
            except ValueError:
                # the native output buffer caps at 4,096 ids: the Python
                # path takes longer text
                pass
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode_tokens(self, tokens: Iterable[str]) -> str:
        """Join WordPiece tokens back into a string (## merge)."""
        out = " ".join(tokens).replace(" ##", "").strip()
        return out

    def decode(self, ids: Iterable[int],
               stop_tokens: Sequence[str] = ("[SEP]", "[PAD]", "[END]")) -> str:
        """Detokenize ids, truncating at the first stop token (parity with
        reference ``run_report_generation_cxr.py:335-346``)."""
        tokens: List[str] = []
        for tok in self.convert_ids_to_tokens(list(ids)):
            if tok in stop_tokens:
                break
            tokens.append(tok)
        return self.decode_tokens(tokens)
