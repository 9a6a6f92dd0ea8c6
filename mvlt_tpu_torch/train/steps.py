"""Train steps of the port (counterpart of ``mvlt_tpu/train/steps.py``),
single device. A step is forward + backward + optimizer update, eager."""

from __future__ import annotations

from typing import Callable, Dict

import torch

Batch = Dict[str, torch.Tensor]


def make_vqa_step(model, optimizer: torch.optim.Optimizer, *,
                  plain: bool = False) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "accuracy"}`` for a :class:`VQAModel`
    (``steps.py:236-248``): CE over the answer logits, then one optimizer
    update; the BatchNorm running statistics move in the forward. ``batch``
    holds ``image`` (B, 3, H, W), ``question`` (B, L) and ``label`` (B,);
    it is moved to the model's device. After a step the parameters' ``.grad``
    hold that step's gradients. ``plain=True`` runs the kernels' plain
    versions."""
    device = next(model.parameters()).device

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, question, label = (batch[k].to(device)
                                  for k in ("image", "question", "label"))
        optimizer.zero_grad(set_to_none=True)
        loss, logits = model.loss(image, question, label, plain=plain)
        loss.backward()
        optimizer.step()
        acc = (logits.argmax(-1) == label).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    step.model, step.optimizer = model, optimizer
    return step
