"""Train state and optimizer of the port (counterpart of
``mvlt_tpu/train/state.py``).

AdamW as the reference loops build it (``run_vqa.py:85``): lr, betas
(0.9, 0.999), eps 1e-6 and decoupled weight decay 1e-4 on every parameter,
from the config; moments in f32 beside the f32 master weights.
``torch.optim.AdamW`` computes the update of optax's ``adamw``: ``p -= lr *
(m_hat / (sqrt(v_hat) + eps) + wd * p)`` with bias-corrected moments.

The options of ``make_optimizer`` (``state.py:40-52``) keep optax's
semantics:

- ``adam_mu_dtype`` (a config field; JAX's ``mu_dtype``) other than
  ``float32`` and a ``schedule`` run :class:`AdamW`, optax's
  ``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale_by_learning_rate``
  written out in plain torch, as optax runs it in XLA (``torch.optim.AdamW``
  keeps its moments in the parameters' dtype and reads one lr): the first
  moment is stored in ``adam_mu_dtype``, and each update computes
  ``(1 - b1) g + b1 mu`` in f32 from the stored mu (b1 rounded to mu's
  dtype, as a Python float meets a bf16 array in JAX; the product in f32,
  as XLA fuses it into the sum), corrects and applies it in f32, and only
  then rounds mu for storage (``optax.tree.cast`` comes last).
  ``schedule`` maps optax's count (0 on the first update) to the lr;
- ``grad_clip_norm``: ``optax.clip_by_global_norm`` before AdamW, every
  tensor scaled by ``max_norm / norm`` where the global norm is not below
  ``max_norm`` (``t / norm * max_norm``, as optax computes it), on the
  device, with no read on the host;
- ``grad_accum_steps`` k > 1: ``optax.MultiSteps`` around that chain. Each
  call of ``step()`` is one mini-step: the gradients go into a running mean
  (``acc + (g - acc) / (n + 1)``); on the k-th the mean goes through the
  clip and AdamW, and the buffers start again. So the clip sees the averaged
  gradient, and AdamW's count, its weight decay and the schedule move once
  in k calls.

The last two are :class:`ClipAccumAdamW` around either AdamW.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

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


class AdamW(torch.optim.Optimizer):
    """``optax.adamw(lr or schedule, b1, b2, eps, weight_decay=wd,
    mu_dtype=mu_dtype)`` in optax's order (module docstring): per tensor
    ``mu`` in ``mu_dtype`` and ``nu`` in f32; ``count`` (optax's, the
    updates so far) in each param group, so that a checkpoint carries it.
    ``schedule(count)`` gives the lr of an update when set; the group's
    ``lr`` otherwise."""

    # elements a run of ``torch._foreach_*`` ops updates at once
    CHUNK = 1 << 24

    def __init__(self, params, *, lr: float, betas, eps: float,
                 weight_decay: float, mu_dtype: torch.dtype = torch.float32,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, count=0))
        self.mu_dtype, self.schedule = mu_dtype, schedule

    @torch.no_grad()
    def step(self) -> None:
        """One update of every group in optax's order, over runs of a
        group's tensors of up to ``CHUNK`` elements at once
        (``torch._foreach_*``: a few launches a run, not a few a tensor;
        the f32 temporaries of a run bound the memory the update adds)."""
        for group in self.param_groups:
            ps = list(group["params"])
            count = group["count"] + 1
            b1, b2 = group["betas"]
            lr = (group["lr"] if self.schedule is None
                  else float(self.schedule(group["count"])))
            # the bias corrections in f32, as optax computes them
            f32 = torch.float32
            bc1 = float(1 - torch.tensor(b1, dtype=f32) ** count)
            bc2 = float(1 - torch.tensor(b2, dtype=f32) ** count)
            # b1 rounded to mu's dtype: a Python float meets a bf16 array
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            hp = (b1, b2, b1_mu, bc1, bc2, group["eps"],
                  group["weight_decay"], lr)
            run, size = [], 0
            for p in ps:
                run.append(p)
                size += p.numel()
                if size >= self.CHUNK:
                    self._update(run, *hp)
                    run, size = [], 0
            if run:
                self._update(run, *hp)
            group["count"] = count

    def _update(self, ps, b1, b2, b1_mu, bc1, bc2, eps, wd, lr) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in ps]
        states = [self.state[p] for p in ps]
        for p, st in zip(ps, states):
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["nu"] = torch.zeros_like(p)
        # mu = (1 - b1) g + b1 mu in f32 from the stored mu (the product
        # not rounded to mu's dtype: XLA fuses it into the f32 sum)
        stored = [st["mu"] for st in states]
        mu = [torch.empty_like(m, dtype=torch.float32) for m in stored]
        torch._foreach_copy_(mu, stored)
        torch._foreach_mul_(mu, b1_mu)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        # nu = (1 - b2) g^2 + b2 nu, in place
        nu = [st["nu"] for st in states]
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        del g2
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd p; p += -lr u
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, torch._foreach_mul(ps, wd))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)
        torch._foreach_copy_(stored, mu)            # mu rounded last

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load casts the moments to the parameters' dtype; mu goes
        back to ``mu_dtype`` (exact: bf16 -> f32 -> bf16)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "mu" in st:
                st["mu"] = st["mu"].to(self.mu_dtype)


class ClipAccumAdamW:
    """``optax.MultiSteps(chain(clip_by_global_norm(c), adamw(...)), k)``
    around ``adamw``, a ``torch.optim.AdamW`` or an :class:`AdamW` (module
    docstring). It takes the calls of an optimizer: ``zero_grad``,
    ``step``, ``state_dict`` and ``load_state_dict``; ``param_groups`` are
    the AdamW's."""

    def __init__(self, adamw, *, grad_clip_norm: Optional[float] = None,
                 grad_accum_steps: int = 1):
        self.adamw = adamw
        self.param_groups = adamw.param_groups
        self.params = [p for g in adamw.param_groups for p in g["params"]]
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
                   grad_accum_steps: int = 1,
                   schedule: Optional[Callable[[int], float]] = None):
    """AdamW over ``model``'s parameters from ``config``:
    ``torch.optim.AdamW`` with f32 moments and a constant lr, else
    :class:`AdamW` (``config.adam_mu_dtype``; ``schedule``, a callable from
    optax's count to the lr, replaces ``config.lr``); with a clip or
    accumulation, :class:`ClipAccumAdamW` around it (optax's chain and
    MultiSteps)."""
    mu_dtype = getattr(torch, config.adam_mu_dtype, None)
    if not (isinstance(mu_dtype, torch.dtype) and mu_dtype.is_floating_point):
        raise ValueError(f"adam_mu_dtype={config.adam_mu_dtype!r} is not a "
                         "floating-point dtype")
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"parameter {name} is {p.dtype}; training needs "
                             "f32 master weights (compute_dtype sets bf16 math)")
    adamw = dict(lr=config.lr, betas=(config.adam_b1, config.adam_b2),
                 eps=config.adam_eps, weight_decay=config.weight_decay)
    if mu_dtype == torch.float32 and schedule is None:
        opt = torch.optim.AdamW(model.parameters(), **adamw)
    else:
        opt = AdamW(model.parameters(), mu_dtype=mu_dtype, schedule=schedule,
                    **adamw)
    if grad_clip_norm is None and grad_accum_steps <= 1:
        return opt
    return ClipAccumAdamW(opt, grad_clip_norm=grad_clip_norm,
                          grad_accum_steps=grad_accum_steps)
