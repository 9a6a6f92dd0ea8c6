"""VQA finetune and eval of the port (counterpart of
``mvlt_tpu/tasks/vqa.py:21-94``; reference ``run_vqa.py:77-190``): the
AdamW train loop with per-epoch validation, the best-valid checkpoint, and
open / closed accuracy.

The loop is JAX's: per epoch, the shuffled train split (``drop_last``)
through the loader and the device prefetch, one step a batch with the masks
of that step (``TaskRunner.masks_for_step``); then the valid split, and a
save when its accuracy is the best so far (without a valid split, a save
every ``checkpoint_every_epochs``). After the last epoch, ``test_final``
on the last-epoch weights, then the best-valid checkpoint restored and
``test``. Eval runs the deterministic forward (the serving kernels) and
keeps the predictions on the device until the split ends.

Over a mesh the loaders yield each data rank its rows of every global batch
(``batch_size`` stays the global batch) and decode only those; eval
gathers the ranks' predictions in order, so every rank returns what one
device returns.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


from mvlt_tpu_torch.data.loader import DataLoader, device_prefetch
from mvlt_tpu_torch.metrics.vqa import vqa_accuracy
from mvlt_tpu_torch.parallel import comm
from mvlt_tpu_torch.tasks.common import TaskRunner, gather_batches
from mvlt_tpu_torch.train.steps import make_vqa_step


def eval_vqa(runner: TaskRunner, dataset, batch_size: int = 64,
             predictions_path: Optional[str] = None) -> Dict[str, float]:
    """testVQA equivalent (run_vqa.py:137-190): accuracy over ``dataset``
    (``overall``, ``total``, ``correct``, ``open``, ``closed``), and the
    predictions as JSON at ``predictions_path``."""
    model = runner.model
    loader = DataLoader(dataset, batch_size, shuffle=False,
                        num_workers=runner.train_config.num_workers,
                        rows=runner.rows)
    preds, labels, types = [], [], []
    for batch in device_prefetch(loader.epoch(0), device=runner.device):
        if len(batch["label"]):
            _, logits = model(batch["image"], batch["question"],
                              plain=runner.plain)
            preds.append(logits.argmax(-1))
        else:                        # this data rank's block of a short tail
            preds.append(batch["label"])
        labels.append(batch["label"])
        types.append(list(batch["answer_type"]))
    preds = [p.tolist() for p in preds]
    labels = [x.tolist() for x in labels]
    preds, labels, types = (sum(gather_batches(runner, x), [])
                            for x in (preds, labels, types))
    acc = vqa_accuracy(preds, labels, types)
    if predictions_path and comm.global_rank() == 0:
        os.makedirs(os.path.dirname(predictions_path) or ".", exist_ok=True)
        with open(predictions_path, "w") as f:
            json.dump([{"pred": int(p), "label": int(l), "answer_type": t}
                       for p, l, t in zip(preds, labels, types)], f)
    return acc


def train_vqa(runner: TaskRunner, train_ds, valid_ds=None, test_ds=None,
              epochs: Optional[int] = None) -> Dict[str, float]:
    """trainVQA equivalent (run_vqa.py:77-118): per-epoch valid; track the
    best. Returns ``{"valid_acc", "epoch"}`` of the best epoch, with
    ``test_final`` and ``test`` when there is a test split."""
    tc = runner.train_config
    epochs = epochs if epochs is not None else tc.epochs
    step = make_vqa_step(runner.model, runner.optimizer, plain=runner.plain,
                         mesh=runner.mesh)
    loader = DataLoader(train_ds, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers,
                        rows=runner.rows)
    best = {"valid_acc": -1.0, "epoch": -1}
    for epoch in range(epochs):
        for b in step.prefetch(loader.epoch(epoch), sliced=True):
            step.masks = runner.masks_for_step()
            metrics = step(b)
            runner.state.step += 1
            runner.log_step(metrics, samples=tc.batch_size)
        if valid_ds is not None:
            acc = eval_vqa(runner, valid_ds, tc.batch_size)
            runner.logger.info("epoch %d valid acc %.4f", epoch,
                               acc["overall"])
            if acc["overall"] > best["valid_acc"]:
                best = {"valid_acc": acc["overall"], "epoch": epoch}
                runner.save()
        elif (epoch + 1) % tc.checkpoint_every_epochs == 0:
            runner.save()
    runner.finish()
    if test_ds is not None:
        # the last-epoch weights ("vqa final results", run_vqa.py:294-297)
        best["test_final"] = eval_vqa(runner, test_ds, tc.batch_size)
        # the headline: the best-valid checkpoint ("pick the best in valid
        # set", run_vqa.py:300-307)
        if valid_ds is not None and runner.workdir and best["epoch"] >= 0:
            runner.maybe_restore()
        best["test"] = eval_vqa(runner, test_ds, tc.batch_size)
    return best
