"""Caption evaluation drivers (a copy of ``mvlt_tpu/metrics/eval_cap.py``).

- :class:`CaptionEvaluator` mirrors ``MVLBertEvalCap``
  (``pycocoevalcap/eval.py:10-82``): PTB-tokenize gt/pred lists, run
  BLEU(4) / METEOR / ROUGE_L / CIDEr (SPICE stays disabled, parity with
  eval.py:7,51).
- :func:`compute_scores` mirrors the R2Gen-style duplicate
  (``run_report_generation_cxr.py:274-312``) including its ``'.' -> ' .'``
  re-spacing and metric-key casing (BLEU_n vs Bleu_n).
"""

from __future__ import annotations

from typing import Dict, Sequence

from mvlt_tpu_torch.metrics.bleu import corpus_bleu
from mvlt_tpu_torch.metrics.cider import corpus_cider
from mvlt_tpu_torch.metrics.meteor import corpus_meteor
from mvlt_tpu_torch.metrics.ptb import ptb_tokenize_corpus
from mvlt_tpu_torch.metrics.rouge import corpus_rouge_l


class CaptionEvaluator:
    """Single-reference: gt is a list of strings (eval.py).  Multi-reference
    (the ``eval_coco.py`` variant, keyed dicts with several gold captions
    per image): pass each gt element as a list of strings."""

    def __init__(self, gt: Sequence, pred: Sequence[str],
                 include_meteor: bool = True):
        self.gt = [[g] if isinstance(g, str) else list(g) for g in gt]
        self.pred = list(pred)
        self.include_meteor = include_meteor
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[int, Dict[str, float]] = {}

    def evaluate(self) -> Dict[str, float]:
        gts = {i: [{"caption": g} for g in gs]
               for i, gs in enumerate(self.gt)}
        res = {i: [{"caption": p}] for i, p in enumerate(self.pred)}
        gts = ptb_tokenize_corpus(gts)
        res = ptb_tokenize_corpus(res)

        bleu, bleu_sents = corpus_bleu(gts, res)
        for k, name in enumerate(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]):
            self._set(name, bleu[k], bleu_sents[k], gts.keys())
        if self.include_meteor:
            m, m_sents = corpus_meteor(gts, res)
            self._set("METEOR", m, m_sents, gts.keys())
        r, r_sents = corpus_rouge_l(gts, res)
        self._set("ROUGE_L", r, r_sents, gts.keys())
        c, c_sents = corpus_cider(gts, res)
        self._set("CIDEr", c, c_sents, gts.keys())
        return dict(self.eval)

    def _set(self, method: str, score: float, scores, ids) -> None:
        self.eval[method] = float(score)
        for i, s in zip(ids, scores):
            self.img_to_eval.setdefault(i, {"image_id": i})[method] = float(s)


def compute_scores(gts: Dict, res: Dict,
                   include_meteor: bool = True) -> Dict[str, float]:
    """R2Gen-style: gts/res {id: [sentence]}, '.' re-spaced, no PTB pass
    (run_report_generation_cxr.py:274-312).

    NOTE the reference re-spaces ONLY the FIRST reference
    (``gts[key][0] = gts[key][0].replace(...)``, :289-290) — extra
    references keep their raw spacing.  Quirk preserved verbatim."""
    gts = {k: [v[0].replace(".", " .")] + list(v[1:]) for k, v in gts.items()}
    res = {k: [v[0].replace(".", " .")] for k, v in res.items()}
    out: Dict[str, float] = {}
    bleu, _ = corpus_bleu(gts, res)
    for k, name in enumerate(["BLEU_1", "BLEU_2", "BLEU_3", "BLEU_4"]):
        out[name] = float(bleu[k])
    if include_meteor:
        out["METEOR"] = float(corpus_meteor(gts, res)[0])
    out["ROUGE_L"] = float(corpus_rouge_l(gts, res)[0])
    out["CIDEr"] = float(corpus_cider(gts, res)[0])
    return out
