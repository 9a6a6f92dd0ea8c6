"""Layer primitives of the port (counterpart of ``mvlt_tpu/ops/layers.py``).

Numerics follow the JAX package: exact (erf) GELU, LayerNorm eps 1e-5 in
Swin and 1e-12 in the BERT fusion stack. Parameters live in the PyTorch
layout: a dense weight is ``(out, in)`` where flax keeps ``(in, out)``.
Dense weights and embeddings are stored in the parameter dtype: the compute
dtype for serving (cast once at load time), float32 masters for training
(cast to the compute dtype at every use, so the cast's backward returns f32
grads); LayerNorm parameters and the relative-position tables stay in
float32, as the JAX kernels take them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SWIN_LN_EPS = 1e-5
BERT_LN_EPS = 1e-12


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU, computed in float32 and rounded back to ``x.dtype``."""
    return F.gelu(x.float()).to(x.dtype)


def gather_label_positions(hidden: torch.Tensor, labels: torch.Tensor,
                           k: int, ignore_index: int = -100):
    """Up to ``k`` positions per sample whose label is not ``ignore_index``,
    in their original order (``mvlt_tpu/ops/layers.py:119-147``): a stable
    argsort of ``labels == ignore_index`` puts the valid positions first,
    then the first ``min(k, L)`` are taken; valid positions beyond ``k`` are
    dropped. hidden: (B, L, H); labels: (B, L). Returns ``(hidden_g (B, k,
    H), labels_g (B, k))``."""
    k = min(k, labels.shape[1])
    order = torch.argsort((labels == ignore_index).to(torch.int32), dim=-1,
                          stable=True)
    idx = order[:, :k]
    hidden_g = hidden.gather(1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
    return hidden_g, labels.gather(1, idx)


class DropoutMasks:
    """Where the train steps' dropout masks come from: ``draw(keep, shape,
    device)`` returns a bool keep-mask, ``bernoulli(keep)`` per element.

    ``DropoutMasks(generator)`` draws on the generator's device from that
    explicit ``torch.Generator`` (the JAX package draws with
    ``jax.random.bernoulli`` from its dropout key; the two streams differ).
    With ``record=True`` each draw is also kept, in order, in ``recorded``.
    ``DropoutMasks.replay(masks)`` hands out the given masks in order
    instead, checking each shape: two runs that replay one list see the same
    masks, and a test can replay the masks JAX drew. ``seed(device)`` draws
    the (2,) seed of in-kernel attention dropout in the same order, and is
    recorded and replayed as the masks are."""

    def __init__(self, generator: torch.Generator = None, *,
                 record: bool = False):
        self.generator = generator
        self.recorded = [] if record else None
        self._replay = None

    @classmethod
    def replay(cls, masks) -> "DropoutMasks":
        src = cls()
        src._replay = iter(list(masks))
        return src

    def _take(self, what: str, shape, dtype: torch.dtype, device,
              fresh) -> torch.Tensor:
        """The next replayed draw, checked against ``shape``, or ``fresh()``
        drawn on the generator's device; moved to ``device`` and
        recorded."""
        if self._replay is not None:
            t = next(self._replay, None)
            if t is None:
                raise RuntimeError(f"no recorded dropout {what} left to "
                                   "replay")
            t = torch.as_tensor(t).to(device=device, dtype=dtype)
            if tuple(t.shape) != shape:
                raise ValueError(f"replayed {what} {tuple(t.shape)} where "
                                 f"{shape} was drawn")
        else:
            t = fresh().to(device)
        if self.recorded is not None:
            self.recorded.append(t)
        return t

    def draw(self, keep: float, shape, device) -> torch.Tensor:
        shape = tuple(shape)
        return self._take("mask", shape, torch.bool, device, lambda: torch.rand(
            shape, generator=self.generator,
            device=self.generator.device) < keep)

    def seed(self, device) -> torch.Tensor:
        """A (2,) int32 seed of two 16-bit halves on ``device``, for the
        kernels' in-kernel attention dropout (JAX's ``jax.random.randint(key,
        (2,), 0, 2 ** 16)``, fusion.py:148-150). It is drawn on the
        generator's device and never read on the host: no synchronisation."""
        return self._take("seed", (2,), torch.int32, device,
                          lambda: torch.randint(
                              0, 2 ** 16, (2,), generator=self.generator,
                              device=self.generator.device,
                              dtype=torch.int32))

    def scaled(self, keep: float, shape, dtype: torch.dtype,
               device) -> torch.Tensor:
        """The multiplicative mask the fused kernels take: 0 or 1/keep in
        ``dtype`` (JAX's ``.astype(cdt) / keep``: 1.109375 in bf16 at keep
        0.9)."""
        return self.draw(keep, shape, device).to(dtype) / keep


def drop_path_multipliers(masks, rate: float, batch: int, device):
    """The DropPath multipliers of one Swin block in training: ``(dp1,
    dp2)`` for its attention and MLP branches, each (B,) float32, 0 or
    ``1 / keep`` per image (the value that JAX's ``m.astype(f32) / keep``
    gives: 1.4285714 at rate 0.3, not a bf16 value), or None when ``masks``
    is None or the rate is 0 (no draw, as ``swin.py:291-300,324-333``).
    Two (B,) ``bernoulli(keep)`` draws from ``masks``, attention branch
    first."""
    if masks is None or rate <= 0.0:
        return None
    keep = 1.0 - rate
    scale = float(np.float32(1.0) / np.float32(keep))
    return tuple(masks.draw(keep, (batch,), device).float() * scale
                 for _ in range(2))


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = -100) -> torch.Tensor:
    """Mean cross entropy over labels != ignore_index, in f32 (0 if none is
    valid); ``mvlt_tpu/ops/layers.py:92``, torch ``F.cross_entropy``
    parity. logits: (..., classes); labels: (...) int."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


class Dense(nn.Module):
    """A dense layer's parameters: ``weight`` (out, in), optional ``bias``,
    cast to the input's dtype at use. Serving runs the product through
    ``ops.gemm`` (K1 or its plain version); where a gradient is needed it is
    a plain ``F.linear`` (the JAX package leaves these layers to XLA)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(d_out, dtype=dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return F.linear(x, w, b)
        shape = x.shape
        y = ops.gemm(x.reshape(-1, shape[-1]).contiguous(), w, b)
        return y.view(*shape[:-1], y.shape[-1])


class LayerNorm(nn.Module):
    """LayerNorm parameters (float32 ``weight`` / ``bias``) and its eps.
    Serving runs the normalisation through ``ops.layernorm`` (K3 or its
    plain version); where a gradient is needed it is ``F.layer_norm`` in
    float32, rounded to the input's dtype (the JAX package leaves these
    norms, outside its kernels, to XLA)."""

    def __init__(self, dim: int, eps: float, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        shape = x.shape
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.weight.requires_grad):
            return F.layer_norm(x.float(), (shape[-1],), self.weight,
                                self.bias, self.eps).to(x.dtype)
        y = ops.layernorm(x.reshape(-1, shape[-1]).contiguous(), self.weight,
                          self.bias, self.eps)
        return y.view(shape)


class Mlp(nn.Module):
    """The two dense layers of the Swin / BERT MLP (``fc1`` -> GELU -> ``fc2``);
    the blocks in :mod:`mvlt_tpu_torch.ops.blocks` run them."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)
