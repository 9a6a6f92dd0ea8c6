"""Train steps of the port (counterpart of ``mvlt_tpu/train/steps.py``),
single device. A step is forward + backward + optimizer update, eager.

Each step draws its dropout masks from ``step.masks``, a
:class:`~mvlt_tpu_torch.ops.layers.DropoutMasks` (by default one on the
model's device, seeded with 0); replace it to record or replay masks."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from mvlt_tpu_torch.ops.layers import DropoutMasks

Batch = Dict[str, torch.Tensor]


def seq2seq_coin_flip(generator: torch.Generator) -> bool:
    """The reference's per-batch ``random.random() < 0.5`` between the
    seq2seq and bidirectional masks (model.py:390-394, ``steps.py:31-34``),
    from an explicit generator: reproducible and loggable."""
    return bool(torch.rand((), generator=generator) < 0.5)


def drop_strings(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A host batch without its non-array fields (ids, raw strings), as
    JAX's ``_validate`` drops them (``train/steps.py:91-103``)."""
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray)
            or (np.isscalar(v) and not isinstance(v, str))}


def _masks(model) -> DropoutMasks:
    device = next(model.parameters()).device
    return DropoutMasks(torch.Generator(device=device).manual_seed(0))


def make_vqa_step(model, optimizer: torch.optim.Optimizer, *,
                  plain: bool = False) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "accuracy"}`` for a :class:`VQAModel`
    (``steps.py:236-248``): CE over the answer logits, then one optimizer
    update; the BatchNorm running statistics move in the forward. ``batch``
    holds ``image`` (B, 3, H, W), ``question`` (B, L) and ``label`` (B,);
    it is moved to the model's device. After a step the parameters' ``.grad``
    hold that step's gradients. ``plain=True`` runs the kernels' plain
    versions.

    ``step.prefetch(iterator, size=2, threads=1)`` wraps a host batch
    iterator (a ``DataLoader`` epoch) with
    :func:`~mvlt_tpu_torch.data.loader.device_prefetch` to the model's
    device, string fields dropped (``steps.py:105-111``)."""
    device = next(model.parameters()).device

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, question, label = (batch[k].to(device)
                                  for k in ("image", "question", "label"))
        optimizer.zero_grad(set_to_none=True)
        loss, logits = model.loss(image, question, label, plain=plain,
                                  masks=step.masks)
        loss.backward()
        optimizer.step()
        acc = (logits.argmax(-1) == label).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    def prefetch(iterator, size: int = 2, threads: int = 1):
        from mvlt_tpu_torch.data.loader import device_prefetch
        return device_prefetch(iterator, size=size, device=device,
                               transform=drop_strings, threads=threads)

    step.model, step.optimizer = model, optimizer
    step.masks = _masks(model)
    step.prefetch = prefetch
    return step


def make_pretrain_step(model, optimizer: torch.optim.Optimizer, *,
                       plain: bool = False):
    """``step(batch, seq2seq) -> {"mlm_loss", "itm_loss", "loss"}`` for a
    :class:`PretrainModel` (``steps.py:251-263``): MLM (+ ITM) CE in the
    mask mode ``seq2seq`` (a plain bool per call, as JAX compiles one
    program per mode), then one optimizer update. ``batch`` holds ``image``
    (B, 3, H, W), ``caption_masked`` (B, L), ``caption_label`` (B, L) and
    ``itm_label`` (B,); it is moved to the model's device. After a step the
    parameters' ``.grad`` hold that step's gradients: zeros for the MLM
    head of the other mode, which the loss does not reach, so that AdamW
    moves its moments and decays its weights as optax does for every
    parameter. ``plain=True`` runs the kernels' plain versions."""
    device = next(model.parameters()).device

    def step(batch: Batch, seq2seq: bool) -> Dict[str, torch.Tensor]:
        args = [batch[k].to(device) for k in ("image", "caption_masked",
                                               "caption_label")]
        itm = batch.get("itm_label")
        optimizer.zero_grad(set_to_none=False)
        loss, metrics = model.loss(*args, None if itm is None else
                                   itm.to(device), seq2seq=bool(seq2seq),
                                   plain=plain, masks=step.masks)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    step.model, step.optimizer = model, optimizer
    step.masks = _masks(model)
    return step


def make_caption_step(model, optimizer: torch.optim.Optimizer, *,
                      learning_strategy: str = "unilm", plain: bool = False):
    """``step(batch) -> {"loss"}`` for a :class:`CaptionModel`
    (``steps.py:282-294``): CE over the MLM logits with ignore index -100
    in ``learning_strategy``, then one optimizer update. ``batch`` holds
    ``image`` (B, 3, H, W), ``caption`` (B, L) and ``mlm_labels`` (B, L);
    it is moved to the model's device. The masks are drawn in JAX's order:
    the Swin DropPath first, then each fusion layer's. Parameters the loss
    does not reach (the fusion pooler) get zero gradients, so that AdamW
    decays them as optax does. ``plain=True`` runs the kernels' plain
    versions."""
    device = next(model.parameters()).device

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, caption, labels = (batch[k].to(device)
                                  for k in ("image", "caption", "mlm_labels"))
        optimizer.zero_grad(set_to_none=False)
        loss, _ = model.loss(image, caption, labels, learning_strategy,
                             plain=plain, masks=step.masks)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {"loss": loss.detach()}

    step.model, step.optimizer = model, optimizer
    step.masks = _masks(model)
    return step


def make_retrieval_step(model, optimizer: torch.optim.Optimizer, *,
                        plain: bool = False):
    """``step(batch) -> {"loss", "accuracy"}`` for a :class:`RetrievalModel`
    (``steps.py:266-279``): CE over the 2-way match logits, accuracy the
    mean of ``argmax(logits) == label``, then one optimizer update.
    ``batch`` holds ``image`` (B, 3, H, W), ``caption`` (B, L) and
    ``label`` (B,), already ``cat(pos, neg)`` (run_retrieval.py:162-177);
    it is moved to the model's device. The masks are drawn in JAX's order:
    the Swin DropPath first, then each fusion layer's attention dropout.
    After a step the parameters' ``.grad`` hold that step's gradients (zeros
    for any the loss does not reach, so that AdamW decays them as optax
    does). ``plain=True`` runs the kernels' plain versions."""
    device = next(model.parameters()).device

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, caption, label = (batch[k].to(device)
                                 for k in ("image", "caption", "label"))
        optimizer.zero_grad(set_to_none=False)
        loss, logits = model.loss(image, caption, label, plain=plain,
                                  masks=step.masks)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        acc = (logits.argmax(-1) == label).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    step.model, step.optimizer = model, optimizer
    step.masks = _masks(model)
    return step
