"""Retrieval ranking metrics (counterpart of
``mvlt_tpu/metrics/retrieval.py``; reference ``run_retrieval.py:220-295``),
numpy only.

The N x N score grid comes from
:func:`mvlt_tpu_torch.tasks.retrieval.score_grid`: rows are images,
columns captions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_ranks(similarities: np.ndarray, labels: np.ndarray
                  ) -> Tuple[List[int], List[int]]:
    """similarities / labels: (N, N) with rows = images, cols = captions.
    Rank = position of the first correct item in the score-descending
    order (a stable sort: ties keep the lower index first); N if none
    (run_retrieval.py:220-249)."""
    n = similarities.shape[1]

    def ranks(sim, lab):
        out = []
        order = np.argsort(-sim, axis=1, kind="stable")
        for row_lab, row_ord in zip(lab, order):
            hit = np.nonzero(row_lab[row_ord] == 1)[0]
            out.append(int(hit[0]) if hit.size else n)
        return out

    i2t = ranks(similarities, labels)
    t2i = ranks(similarities.T, labels.T)
    return i2t, t2i


def recall_at_k(ranks: Sequence[int], ks: Sequence[int] = (1, 5, 10)
                ) -> Dict[str, float]:
    return {f"R@{k}": sum(r < k for r in ranks) / len(ranks) for k in ks}


def evaluate_retrieval(similarities: np.ndarray, labels: np.ndarray) -> Dict:
    """``{"i2t_retrieval": {"R@1", "R@5", "R@10"}, "t2i_retrieval": ...}``
    (run_retrieval.py:286-295)."""
    i2t, t2i = compute_ranks(np.asarray(similarities), np.asarray(labels))
    return {"i2t_retrieval": recall_at_k(i2t),
            "t2i_retrieval": recall_at_k(t2i)}
