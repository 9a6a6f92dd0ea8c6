"""Optimizer of the port (counterpart of ``mvlt_tpu/train/state.py:40-52``).

AdamW as the reference loops build it (``run_vqa.py:85``): lr, betas
(0.9, 0.999), eps 1e-6 and decoupled weight decay 1e-4 on every parameter,
from the config; moments in f32 beside the f32 master weights. No schedule,
no grad clip and no accumulation in this slice. ``torch.optim.AdamW`` computes
the update of optax's ``adamw``: ``p -= lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p)`` with bias-corrected moments.
"""

from __future__ import annotations

import torch

from mvlt_tpu_torch.config import MVLTConfig


def make_optimizer(model: torch.nn.Module,
                   config: MVLTConfig) -> torch.optim.AdamW:
    if config.adam_mu_dtype != "float32":
        raise NotImplementedError(
            f"adam_mu_dtype={config.adam_mu_dtype!r}: the port keeps f32 moments")
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"parameter {name} is {p.dtype}; training needs "
                             "f32 master weights (compute_dtype sets bf16 math)")
    return torch.optim.AdamW(model.parameters(), lr=config.lr,
                             betas=(config.adam_b1, config.adam_b2),
                             eps=config.adam_eps,
                             weight_decay=config.weight_decay)
