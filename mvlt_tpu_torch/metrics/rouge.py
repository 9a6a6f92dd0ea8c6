"""ROUGE-L (LCS F-beta, beta=1.2), numerically identical to
pycocoevalcap's Rouge (reference ``pycocoevalcap/rouge/rouge.py:13-105``):
per-sample max precision / max recall over references, corpus = mean.
A copy of ``mvlt_tpu/metrics/rouge.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BETA = 1.2


def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) LCS with a rolling row (sequences here are
    reports of <=150 tokens)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for tok in a:
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if b[j - 1] == tok:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = cur[j - 1] if cur[j - 1] > prev[j] else prev[j]
        prev = cur
    return prev[-1]


def sentence_rouge_l(candidate: str, refs: Sequence[str]) -> float:
    token_c = candidate.split(" ")
    prec, rec = [], []
    for reference in refs:
        token_r = reference.split(" ")
        lcs = lcs_length(token_r, token_c)
        prec.append(lcs / float(len(token_c)))
        rec.append(lcs / float(len(token_r)))
    pm, rm = max(prec), max(rec)
    if pm != 0 and rm != 0:
        return ((1 + BETA ** 2) * pm * rm) / float(rm + BETA ** 2 * pm)
    return 0.0


def corpus_rouge_l(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    assert gts.keys() == res.keys()
    scores = [sentence_rouge_l(res[i][0], gts[i]) for i in gts.keys()]
    return float(np.mean(scores)), scores
