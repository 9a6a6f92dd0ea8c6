"""CIDEr (corpus TF-IDF n-gram cosine with gaussian length penalty),
numerically identical to pycocoevalcap's CiderScorer (reference
``pycocoevalcap/cider/cider_scorer.py:114-200``). A copy of
``mvlt_tpu/metrics/cider.py``.

Quirks preserved deliberately (they are part of the published metric's
de-facto definition):
- document frequency counts an n-gram once per *image* whose references
  contain it; idf = log(N_images) - log(max(1, df));
- the "length" used by the gaussian penalty accumulates the term
  frequencies of **2-grams** (the reference's ``if n == 1`` is an index
  into 0-based n-gram sizes — bigrams);
- clipped similarity: sum(min(hyp, ref) * ref) / (|hyp| * |ref|);
- sigma = 6.0, mean over n, /len(refs), *10.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

N = 4
SIGMA = 6.0


def _counts(words, n=N):
    out = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            out[tuple(words[i:i + k])] += 1
    return out


def corpus_cider(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    assert gts.keys() == res.keys()
    ids = list(gts.keys())

    ref_counts = {i: [_counts(r.split()) for r in gts[i]] for i in ids}
    test_counts = {i: _counts(res[i][0].split()) for i in ids}

    doc_freq: Dict[tuple, float] = defaultdict(float)
    for i in ids:
        for ngram in set(ng for cnts in ref_counts[i] for ng in cnts):
            doc_freq[ngram] += 1
    log_ref_len = np.log(float(len(ids)))

    def to_vec(cnts):
        vec = [defaultdict(float) for _ in range(N)]
        norm = [0.0] * N
        length = 0
        for ngram, tf in cnts.items():
            df = np.log(max(1.0, doc_freq[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(tf) * (log_ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:     # reference quirk: bigram count drives the penalty
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores = []
    for i in ids:
        vec_h, norm_h, len_h = to_vec(test_counts[i])
        score = np.zeros(N)
        for ref in ref_counts[i]:
            vec_r, norm_r, len_r = to_vec(ref)
            delta = float(len_h - len_r)
            penalty = math.e ** (-(delta ** 2) / (2 * SIGMA ** 2))
            for k in range(N):
                val = sum(min(c, vec_r[k][ng]) * vec_r[k][ng]
                          for ng, c in vec_h[k].items())
                if norm_h[k] != 0 and norm_r[k] != 0:
                    val /= norm_h[k] * norm_r[k]
                score[k] += val * penalty
        scores.append(float(np.mean(score) / len(ref_counts[i]) * 10.0))
    return float(np.mean(scores)), scores
