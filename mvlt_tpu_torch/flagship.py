"""The flagship VQA forward of the port: Swin-S @224 + BERT-base fusion, VQA
head with 224 answers, bf16, deterministic (counterpart of
``mvlt_tpu/flagship.py:23-54``).

Weights are random, drawn from a numpy seed: normal(0, 0.02) for every dense
weight, bias, embedding and relative-position table, and LayerNorm gamma 1,
beta 0. (The JAX builder zero-initialises, which would make every kernel's
output trivial.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from mvlt_tpu.config import MVLTConfig, swin_small
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.ops.layers import LayerNorm


def flagship_vqa_config() -> MVLTConfig:
    cfg = MVLTConfig.for_vqa(result_num=224)
    return dataclasses.replace(cfg, conv="swin", swin=swin_small())


@torch.no_grad()
def init_seeded_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` in
    ``named_parameters`` order: LayerNorms gamma 1 / beta 0, everything else
    normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    ln_params = {id(p) for m in model.modules() if isinstance(m, LayerNorm)
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


def entry():
    """Flagship forward at batch 8 on the card (counterpart of
    ``__graft_entry__.entry``)."""
    return build_vqa_forward(batch=8)
