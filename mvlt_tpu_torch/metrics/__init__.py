"""Evaluation metrics of the port: copies of :mod:`mvlt_tpu.metrics`
modules (Python and numpy only), held against them by the tests."""

from mvlt_tpu_torch.metrics.bleu import corpus_bleu
from mvlt_tpu_torch.metrics.cider import corpus_cider
from mvlt_tpu_torch.metrics.eval_cap import CaptionEvaluator, compute_scores
from mvlt_tpu_torch.metrics.meteor import corpus_meteor
from mvlt_tpu_torch.metrics.ptb import ptb_tokenize, ptb_tokenize_corpus
from mvlt_tpu_torch.metrics.retrieval import compute_ranks, recall_at_k
from mvlt_tpu_torch.metrics.rouge import corpus_rouge_l
from mvlt_tpu_torch.metrics.vqa import vqa_accuracy

__all__ = ["corpus_bleu", "corpus_cider", "corpus_rouge_l", "corpus_meteor",
           "ptb_tokenize", "ptb_tokenize_corpus", "CaptionEvaluator",
           "compute_scores", "compute_ranks", "recall_at_k", "vqa_accuracy"]
