"""Train state and optimizer of the port (counterpart of
``mvlt_tpu/train/state.py``).

AdamW as the reference loops build it (``run_vqa.py:85``): lr, betas
(0.9, 0.999), eps 1e-6 and decoupled weight decay 1e-4 on every parameter,
from the config; moments in f32 beside the f32 master weights.
``torch.optim.AdamW`` computes the update of optax's ``adamw``: ``p -= lr *
(m_hat / (sqrt(v_hat) + eps) + wd * p)`` with bias-corrected moments.

The two options of ``make_optimizer`` (``state.py:40-52``) keep optax's
semantics, in :class:`ClipAccumAdamW`:

- ``grad_clip_norm``: ``optax.clip_by_global_norm`` before AdamW, every
  tensor scaled by ``max_norm / norm`` where the global norm is not below
  ``max_norm`` (``t / norm * max_norm``, as optax computes it), on the
  device, with no read on the host;
- ``grad_accum_steps`` k > 1: ``optax.MultiSteps`` around that chain. Each
  call of ``step()`` is one mini-step: the gradients go into a running mean
  (``acc + (g - acc) / (n + 1)``); on the k-th the mean goes through the
  clip and AdamW, and the buffers start again. So the clip sees the averaged
  gradient, and AdamW's count and its weight decay move once in k calls.

A schedule and moments in another dtype than f32 are not ported
(ROADMAP.md queue A, "AdamW options"); ``adam_mu_dtype`` other than
``float32`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mvlt_tpu_torch.config import MVLTConfig


@dataclasses.dataclass
class TrainState:
    """What a runner trains and checkpoints: the model (parameters and
    BatchNorm buffers), its optimizer (AdamW moments and count, accumulation
    buffers) and ``step``, the host's count of mini-steps (JAX's
    ``state.step``: every call of the step, accumulation or not)."""

    model: torch.nn.Module
    optimizer: Any
    step: int = 0


class ClipAccumAdamW:
    """``optax.MultiSteps(chain(clip_by_global_norm(c), adamw(...)), k)``
    over ``torch.optim.AdamW`` (module docstring). It takes the calls of
    an optimizer: ``zero_grad``, ``step``, ``state_dict`` and
    ``load_state_dict``; ``param_groups`` are AdamW's."""

    def __init__(self, params, *, grad_clip_norm: Optional[float] = None,
                 grad_accum_steps: int = 1, **adamw):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, **adamw)
        self.param_groups = self.adamw.param_groups
        self.max_norm = grad_clip_norm
        self.k = int(grad_accum_steps)
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k > 1 else None)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.adamw.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.k - 1:
                self.mini_step = n + 1
                return
            grads = self.acc
        if self.max_norm is not None:
            norm = torch.stack([g.float().square().sum()
                                for g in grads]).sum().sqrt()
            under = norm < self.max_norm
            grads = [torch.where(under, g, g / norm.to(g.dtype) * self.max_norm)
                     for g in grads]
        for p, g in zip(self.params, grads):
            # the buffers are cleared below: AdamW reads copies
            p.grad = g.clone() if self.acc is not None else g
        self.adamw.step()
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
            self.mini_step = 0

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)


def make_optimizer(model: torch.nn.Module, config: MVLTConfig,
                   grad_clip_norm: Optional[float] = None,
                   grad_accum_steps: int = 1):
    """AdamW over ``model``'s parameters from ``config``; with a clip or
    accumulation, :class:`ClipAccumAdamW` (optax's chain and MultiSteps)."""
    if config.adam_mu_dtype != "float32":
        raise NotImplementedError(
            f"adam_mu_dtype={config.adam_mu_dtype!r}: the port keeps f32 "
            "moments (ROADMAP.md queue A, 'AdamW options')")
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"parameter {name} is {p.dtype}; training needs "
                             "f32 master weights (compute_dtype sets bf16 math)")
    adamw = dict(lr=config.lr, betas=(config.adam_b1, config.adam_b2),
                 eps=config.adam_eps, weight_decay=config.weight_decay)
    if grad_clip_norm is None and grad_accum_steps <= 1:
        return torch.optim.AdamW(model.parameters(), **adamw)
    return ClipAccumAdamW(model.parameters(), grad_clip_norm=grad_clip_norm,
                          grad_accum_steps=grad_accum_steps, **adamw)
