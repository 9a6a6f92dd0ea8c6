"""PTB tokenization for the metric path of the port (a copy of
``mvlt_tpu/metrics/ptb.py``): a reimplementation of the
reference's Java pipeline (``pycocoevalcap/tokenizer/ptbtokenizer.py``:
Stanford ``PTBTokenizer -preserveLines -lowerCase`` via subprocess, then a
punctuation-strip list).  No Java in this framework.

Covers the PTB rules that can occur in this project's caption streams
(cleaned, lowercased medical reports — see ``transforms.clean_report_*``):
punctuation splitting, contractions, bracket normalization, quote
normalization, ellipses.  The post-tokenization punctuation removal list is
verbatim from the reference (ptbtokenizer.py:21-22).

:func:`ptb_tokenize` runs the C++ tokenizer (``csrc/host/ptb.cc``, through
:mod:`mvlt_tpu_torch.text.native`) where JAX's does, on ASCII captions; the
Python tokenizer (:func:`ptb_tokenize_py`) takes the rest and gives the same
tokens.
"""

from __future__ import annotations

import re
from typing import Dict, List

PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNC_SET = set(PUNCTUATIONS)

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "[": "-LSB-", "]": "-RSB-",
             "{": "-LCB-", "}": "-RCB-"}

_CONTRACTIONS = re.compile(
    r"(?i)(n't|'ll|'re|'ve|'s|'m|'d)\b")

# Stanford PTBLexer keeps the trailing period attached to known
# abbreviations ("st.", "dr.", "etc.") and to acronyms with internal
# periods ("u.s.", "a.m."); at sentence end it ALSO emits a duplicated
# bare "." token (default, non-strictTreebank3 behavior).  The metric
# path strips bare "." afterwards (PUNCTUATIONS), so the duplication is
# invisible there and this port keeps only the attached period.  The set
# below is the unambiguous subset of the PTBLexer gazette (context-
# dependent entries like "no."/"in." are deliberately excluded: treating
# them as abbreviations would be wrong more often than right in caption
# and report text).  The same set as JAX's (and its C++ tokenizer's
# kAbbrev).
ABBREVIATIONS = frozenset({
    # titles
    "mr.", "mrs.", "ms.", "dr.", "prof.", "rev.", "gen.", "gov.", "sen.",
    "rep.", "col.", "maj.", "sgt.", "capt.", "lt.", "cmdr.", "adm.",
    "hon.", "jr.", "sr.",
    # organizations
    "inc.", "corp.", "co.", "ltd.", "bros.", "dept.", "univ.",
    # places
    "st.", "ave.", "blvd.", "rd.", "mt.", "hwy.",
    # months
    "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sep.",
    "sept.", "oct.", "nov.", "dec.",
    # latin / scholarly
    "etc.", "vs.", "cf.", "al.", "viz.", "e.g.", "i.e.", "fig.", "figs.",
    "vol.", "vols.", "approx.",
    # units common in medical reports
    "cm.", "mm.", "ml.", "mg.", "kg.",
})

_ACRONYM = re.compile(r"^([A-Za-z]\.)+[A-Za-z]?\.?$")


def _split_periods(t: str) -> str:
    """Token-wise sentence-period splitting: a trailing period detaches
    unless the token is a known abbreviation or an internal-period
    acronym (mirrors Stanford PTBLexer; see ABBREVIATIONS note)."""
    toks = []
    for w in t.split():
        if w.endswith(".") and not w.endswith("..."):
            if w.lower() in ABBREVIATIONS or _ACRONYM.match(w):
                toks.append(w)
                continue
            if len(w) > 1:
                toks.append(w[:-1])
            toks.append(".")
        else:
            toks.append(w)
    return " ".join(toks)


def _ptb_tokenize_line(text: str) -> List[str]:
    t = text
    # normalize quotes: opening " after space/start -> ``, closing -> ''
    t = re.sub(r'(^|[ \(\[{<])"', r"\1 `` ", t)
    t = t.replace('"', " '' ")
    # ellipsis
    t = t.replace("...", " ... ")
    # brackets
    for k, v in _BRACKETS.items():
        t = t.replace(k, f" {v} ")
    # separate standard punctuation
    t = re.sub(r"([;@#$%&?!])", r" \1 ", t)
    t = re.sub(r"([^\d]),", r"\1 , ", t)       # commas not inside numbers
    t = re.sub(r",([^\d])", r" , \1", t)
    t = re.sub(r"([^:\d]):", r"\1 : ", t)      # colons not inside times
    t = t.replace(" - ", " -- ").replace("--", " -- ")
    # periods: token-wise, abbreviation/acronym-aware
    t = _split_periods(t)
    # contractions
    t = _CONTRACTIONS.sub(r" \1", t)
    # possessive plural: dogs' -> dogs '
    t = re.sub(r"(\w)' ", r"\1 ' ", t)
    return t.lower().split()


def ptb_tokenize(text: str) -> str:
    """Tokenize one caption and drop the reference's punctuation list: the
    native tokenizer where it takes the text, else :func:`ptb_tokenize_py`
    (byte-equal)."""
    from mvlt_tpu_torch.text.native import ptb_tokenize_native
    native = ptb_tokenize_native(text)
    return ptb_tokenize_py(text) if native is None else native


def ptb_tokenize_py(text: str) -> str:
    """The pure-Python tokenizer of :func:`ptb_tokenize`."""
    # NOTE the filter is case-sensitive, exactly like the reference
    # (ptbtokenizer.py:21-22 lists "-LRB-" etc. UPPERCASE but filters the
    # -lowerCase Java output): bracket tokens arrive lowercased and are
    # therefore KEPT in the metric token stream.
    return " ".join(w for w in _ptb_tokenize_line(text)
                    if w not in _PUNC_SET)


def ptb_tokenize_corpus(captions_for_image: Dict) -> Dict[object, List[str]]:
    """Reference-shaped API: {id: [{'caption': str}, ...]} ->
    {id: [tokenized_str, ...]} (ptbtokenizer.py:28-74)."""
    out: Dict[object, List[str]] = {}
    for k, v in captions_for_image.items():
        caps = [d["caption"] if isinstance(d, dict) else d for d in v]
        out[k] = [ptb_tokenize(c) for c in caps]
    return out
