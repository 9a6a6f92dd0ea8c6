"""Corpus BLEU-1..4, numerically identical to pycocoevalcap's BleuScorer
(reference ``pycocoevalcap/bleu/bleu_scorer.py``; validated against it in
``tests/test_metrics.py``). A copy of ``mvlt_tpu/metrics/bleu.py``, held
to it by ``tests/test_torch_caption_metrics.py``.

Semantics preserved exactly:
- clipped n-gram counts against per-ngram max over references,
- effective reference length: 'average' for a single scored pair,
  'closest' (ties -> shorter) otherwise — the pycocoevalcap default,
- smoothing constants tiny=1e-15 / small=1e-9,
- brevity penalty exp(1 - 1/ratio) applied only when ratio < 1,
- per-sentence scores use sentence-local stats with the same formula.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

_SMALL = 1e-9
_TINY = 1e-15


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def _closest_reflen(reflens: Sequence[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


def corpus_bleu(gts: Dict, res: Dict, n: int = 4,
                option: str = None) -> Tuple[List[float], List[List[float]]]:
    """gts/res: {id: [sentence, ...]} with exactly one candidate in res.
    Returns (corpus bleu[1..n], per-sentence bleu lists [n][num_sent])."""
    assert gts.keys() == res.keys()
    ids = list(gts.keys())
    if option is None:
        option = "average" if len(ids) == 1 else "closest"

    total_guess = [0] * n
    total_correct = [0] * n
    total_testlen = 0
    total_reflen = 0.0
    sent_scores: List[List[float]] = [[] for _ in range(n)]

    for i in ids:
        hyp = res[i][0].split()
        refs = [r.split() for r in gts[i]]
        testlen = len(hyp)
        reflens = [len(r) for r in refs]
        if option == "average":
            reflen = sum(reflens) / len(reflens)
        elif option == "shortest":
            reflen = min(reflens)
        else:
            reflen = _closest_reflen(reflens, testlen)

        maxcounts: Dict[tuple, int] = {}
        for r in refs:
            for ngram, c in _ngram_counts(r, n).items():
                maxcounts[ngram] = max(maxcounts.get(ngram, 0), c)
        counts = _ngram_counts(hyp, n)
        guess = [max(0, testlen - k) for k in range(n)]
        correct = [0] * n
        for ngram, c in counts.items():
            correct[len(ngram) - 1] += min(maxcounts.get(ngram, 0), c)

        total_testlen += testlen
        total_reflen += reflen
        for k in range(n):
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]

        # per-sentence score
        bleu = 1.0
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        for k in range(n):
            bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
            s = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            sent_scores[k].append(s)

    bleus = []
    bleu = 1.0
    ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
    for k in range(n):
        bleu *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
        s = bleu ** (1.0 / (k + 1))
        if ratio < 1:
            s *= math.exp(1 - 1 / ratio)
        bleus.append(s)
    return bleus, sent_scores
