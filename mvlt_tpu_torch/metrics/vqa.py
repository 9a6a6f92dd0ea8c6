"""VQA accuracy with the OPEN / CLOSED split: a copy of
``mvlt_tpu/metrics/vqa.py:14-32`` (reference ``run_vqa.py:137-190``).

Unanswerable questions (label -100) count toward no denominator: the
reference tallies only answerable rows (run_vqa.py:150-168)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def vqa_accuracy(predictions: Sequence[int], labels: Sequence[int],
                 answer_types: Sequence[str] = None) -> Dict[str, float]:
    preds = np.asarray(predictions)
    labs = np.asarray(labels)
    valid = labs != -100
    out = {}
    total = int(valid.sum())
    correct = int(((preds == labs) & valid).sum())
    out["overall"] = correct / total if total else 0.0
    out["total"] = total
    out["correct"] = correct
    if answer_types is not None:
        types = np.asarray([str(t).upper() for t in answer_types])
        for name in ("OPEN", "CLOSED"):
            m = valid & (types == name)
            n = int(m.sum())
            out[name.lower()] = (int(((preds == labs) & m).sum()) / n
                                 if n else 0.0)
    return out
