"""The port's flagship entry points.

- The VQA forward (serving): Swin-S @224 + BERT-base fusion, VQA head with
  224 answers, bf16, deterministic (counterpart of
  ``mvlt_tpu/flagship.py:23-54``).
- The VQA finetune train step: ResNet-101 @224 + ``resnet_fc`` + BERT-base
  fusion (S = 1 + 49 + 1 + 23 = 74) + pooler + 224 answers, forward +
  backward + AdamW, bf16 compute with f32 master weights, fusion dropouts
  0.0 (the JAX ``make_vqa_step`` path, ``train/steps.py:236``).

Weights are random, drawn from a numpy seed: normal(0, 0.02) for every dense
and conv weight, bias, embedding and relative-position table, and LayerNorm
and BatchNorm gamma 1, beta 0. (The JAX package's ``build_vqa_forward``
zero-initialises, which would make every kernel's output trivial.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from mvlt_tpu_torch.config import MVLTConfig, resnet101, swin_small
from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.ops.layers import LayerNorm
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_vqa_step


def flagship_vqa_config() -> MVLTConfig:
    cfg = MVLTConfig.for_vqa(result_num=224)
    return dataclasses.replace(cfg, conv="swin", swin=swin_small())


def flagship_vqa_train_config() -> MVLTConfig:
    """VQA finetune: ResNet-101 backbone, 224 answers, fusion dropouts 0.0."""
    cfg = MVLTConfig.for_vqa(result_num=224)
    return dataclasses.replace(
        cfg, conv="resnet101", resnet=resnet101(),
        fusion=dataclasses.replace(cfg.fusion, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0))


@torch.no_grad()
def init_seeded_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` in
    ``named_parameters`` order: LayerNorms and BatchNorms gamma 1 / beta 0,
    everything else normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    ln_params = {id(p) for m in model.modules()
                 if isinstance(m, (LayerNorm, BatchNorm))
                 for p in m.parameters()}
    for name, p in model.named_parameters():
        if id(p) in ln_params:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            p.copy_(torch.from_numpy(
                rng.normal(0.0, 0.02, size=tuple(p.shape)).astype(np.float32)))
    return model


def example_inputs(batch: int, seq_len: int, seed: int = 0,
                   image_size: int = 224, vocab: int = 30000):
    """(image (B, 3, H, W) f32, question (B, L) int64) from a numpy seed.
    Questions have 5..L real tokens and zero padding after them, so the
    fusion encoder's key-padding bias is live."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, 3, image_size, image_size))
    question = rng.integers(1, vocab, size=(batch, seq_len))
    lengths = rng.integers(min(5, seq_len), seq_len + 1, size=batch)
    question[np.arange(seq_len)[None, :] >= lengths[:, None]] = 0
    return (torch.from_numpy(image.astype(np.float32)),
            torch.from_numpy(question.astype(np.int64)))


def build_vqa_forward(batch: int = 8, seq_len: int = 23,
                      dtype: torch.dtype = torch.bfloat16, device="cuda",
                      seed: int = 0) -> Tuple[Callable, Tuple]:
    """(forward, (image, question)) for the flagship VQA forward.
    ``forward(image, question, plain=False)`` returns the (B, 224) logits;
    ``forward.model`` is the seeded :class:`VQAModel`. ``device='cuda'``
    without a CUDA device raises: the flagship never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_vqa_forward(device='cuda') needs a CUDA "
                           "device and torch.cuda.is_available() is False")
    model = VQAModel(flagship_vqa_config(), dtype=dtype, device=device)
    init_seeded_(model, seed)
    image, question = example_inputs(batch, seq_len, seed)

    def forward(image, question, plain: bool = False):
        return model(image, question, plain=plain)[1]

    forward.model = model
    return forward, (image.to(device), question.to(device))


def example_labels(batch: int, num_answers: int = 224, seed: int = 0):
    """(B,) int64 answer ids in [0, num_answers) from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, num_answers, size=batch)
                            .astype(np.int64))


def build_vqa_train_step(batch: int = 32, seq_len: int = 23, device="cuda",
                         seed: int = 0, plain: bool = False,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         config: MVLTConfig = None,
                         image_size: int = 224) -> Tuple[Callable, dict]:
    """(step, batch) for the VQA finetune train step. ``step(batch)`` runs
    forward + backward + AdamW and returns ``{"loss", "accuracy"}``;
    ``step.model`` / ``step.optimizer`` are the seeded :class:`VQAModel`
    (f32 masters, ``compute_dtype`` math) and its AdamW. ``plain=True``
    runs the kernels' plain versions. ``config`` (default
    :func:`flagship_vqa_train_config`) and ``image_size`` shrink it for
    tests. ``device='cuda'`` without a CUDA
    device raises: the train step never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_vqa_train_step(device='cuda') needs a CUDA "
                           "device and torch.cuda.is_available() is False")
    cfg = config or flagship_vqa_train_config()
    model = VQAModel(cfg, dtype=torch.float32, device=device,
                     compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    image, question = example_inputs(batch, seq_len, seed, image_size,
                                     vocab=min(30000, cfg.fusion.vocab_size))
    label = example_labels(batch, cfg.result_num, seed)
    step = make_vqa_step(model, make_optimizer(model, cfg), plain=plain)
    data = {"image": image.to(device), "question": question.to(device),
            "label": label.to(device)}
    return step, data


def entry():
    """Flagship forward at batch 8 on the card (counterpart of
    ``__graft_entry__.entry``)."""
    return build_vqa_forward(batch=8)
