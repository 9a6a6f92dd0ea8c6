"""Report generation of the port (counterpart of
``mvlt_tpu/tasks/caption.py:20-109``; reference
``run_report_generation_cxr.py:315-379, 458-493``): the train loop in
either learning strategy with a test every ``test_freq`` epochs, and the
beam / greedy test scored by the caption metrics.

:func:`train_caption` is JAX's loop: per epoch, the shuffled train split
(``drop_last``) through the loader and the device prefetch, one caption
step a batch with the masks of that step (``TaskRunner.masks_for_step``);
a checkpoint every ``checkpoint_every_epochs``; :func:`eval_caption` every
``test_freq`` epochs when a test split and a tokenizer are given.

:func:`eval_caption` decodes the test split (``GenerationSpec.from_config``:
beam search for ``num_beams`` > 1, greedy otherwise, the deterministic
Swin forward and the KV-cached decode), detokenizes each sequence up to
[SEP], [PAD] or [END] (reference :335-346), and scores the reports with
:class:`CaptionEvaluator`, then with :func:`compute_scores` under the
``r2gen_`` keys (:370-376). JAX pads a short last batch with zero images;
here it runs short, since the rows of a decode are independent (the tests
hold the kept rows to JAX's ids). Batches keep their report strings on the
host: only the images cross to the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mvlt_tpu_torch.data.loader import DataLoader, device_prefetch
from mvlt_tpu_torch.metrics.eval_cap import CaptionEvaluator, compute_scores
from mvlt_tpu_torch.models.generation import GenerationSpec, generate
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.train.steps import make_caption_step


def check_quant(quant: str) -> None:
    """JAX's ``quant`` modes: '' serves the weights as they are; 'int8w'
    (weight-only int8, ``mvlt_tpu/ops/quant.py``) is not ported."""
    if quant == "int8w":
        raise NotImplementedError(
            "quant='int8w' (weight-only int8 serving) is not ported yet: "
            "ROADMAP.md queue A, 'ops/quant.py'")
    if quant:
        raise ValueError(f"unknown quant mode {quant!r}")


def train_caption(runner: TaskRunner, train_ds, test_ds=None,
                  epochs: Optional[int] = None, test_freq: int = 5,
                  learning_strategy: str = "unilm",
                  num_beams: int = 5, tokenizer=None) -> List[Dict]:
    """Returns the score dicts of the periodic tests, in order."""
    tc = runner.train_config
    epochs = epochs if epochs is not None else tc.epochs
    step = make_caption_step(runner.model, runner.optimizer,
                             learning_strategy=learning_strategy,
                             plain=runner.plain)
    loader = DataLoader(train_ds, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers)
    evals = []
    for epoch in range(epochs):
        for b in step.prefetch(loader.epoch(epoch)):
            step.masks = runner.masks_for_step()
            metrics = step(b)
            runner.state.step += 1
            runner.log_step(metrics, samples=tc.batch_size)
        if (epoch + 1) % tc.checkpoint_every_epochs == 0:
            runner.save()
        if test_ds is not None and tokenizer is not None \
                and (epoch + 1) % test_freq == 0:
            scores = eval_caption(runner, test_ds, tokenizer,
                                  num_beams=num_beams,
                                  strategy=learning_strategy)
            runner.logger.info("epoch %d eval: %s", epoch, scores)
            evals.append(scores)
    runner.finish()
    return evals


def decode_reports(runner: TaskRunner, test_ds, tokenizer,
                   batch_size: int = 16, num_beams: int = 5,
                   strategy: str = "unilm", max_samples: int = 0):
    """(ground truths, predictions, decoded ids): the test split's reports
    and the decoded ones, and each batch's sequences (B, max_length) as
    host lists."""
    spec = GenerationSpec.from_config(runner.config, num_beams=num_beams,
                                      strategy=strategy)
    loader = DataLoader(test_ds, batch_size, shuffle=False,
                        num_workers=runner.train_config.num_workers)
    keep = lambda b: {"image": b["image"], "raw_caption": b["raw_caption"]}
    gts, preds, ids = [], [], []
    for batch in device_prefetch(loader.epoch(0), device=runner.device,
                                 transform=keep):
        seqs = generate(runner.model, batch["image"], spec,
                        plain=runner.plain)[0].tolist()
        ids.append(seqs)
        for row, raw in zip(seqs, batch["raw_caption"]):
            preds.append(tokenizer.decode(row))
            gts.append(raw)
        if max_samples and len(gts) >= max_samples:
            break
    return gts, preds, ids


def eval_caption(runner: TaskRunner, test_ds, tokenizer,
                 batch_size: int = 16, num_beams: int = 5,
                 strategy: str = "unilm", max_samples: int = 0,
                 include_meteor: bool = True,
                 quant: str = "") -> Dict[str, float]:
    """The caption metrics of the decoded test split (BLEU 1-4, METEOR,
    ROUGE_L, CIDEr), and R2Gen's under ``r2gen_`` keys."""
    check_quant(quant)
    gts, preds, _ = decode_reports(runner, test_ds, tokenizer, batch_size,
                                   num_beams, strategy, max_samples)
    scores = CaptionEvaluator(gts, preds,
                              include_meteor=include_meteor).evaluate()
    r2gen = compute_scores({i: [g] for i, g in enumerate(gts)},
                           {i: [p] for i, p in enumerate(preds)},
                           include_meteor=include_meteor)
    scores.update({f"r2gen_{k}": v for k, v in r2gen.items()})
    return scores
