"""Layer primitives of the port (counterpart of ``mvlt_tpu/ops/layers.py``).

Numerics follow the JAX package: exact (erf) GELU, LayerNorm eps 1e-5 in
Swin and 1e-12 in the BERT fusion stack. Parameters live in the PyTorch
layout: a dense weight is ``(out, in)`` where flax keeps ``(in, out)``.
Dense weights and embeddings are stored in the compute dtype, cast once at
load time; LayerNorm parameters and the relative-position tables stay in
float32, as the JAX kernels take them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SWIN_LN_EPS = 1e-5
BERT_LN_EPS = 1e-12


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU, computed in float32 and rounded back to ``x.dtype``."""
    return F.gelu(x.float()).to(x.dtype)


class Dense(nn.Module):
    """A dense layer's parameters: ``weight`` (out, in), optional ``bias``.
    The product itself runs through ``ops.gemm`` (K1 or its plain version)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(d_out, dtype=dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        shape = x.shape
        y = ops.gemm(x.reshape(-1, shape[-1]).contiguous(), self.weight,
                     self.bias)
        return y.view(*shape[:-1], y.shape[-1])


class LayerNorm(nn.Module):
    """LayerNorm parameters (float32 ``weight`` / ``bias``) and its eps; the
    normalisation runs through ``ops.layernorm`` (K3 or its plain version)."""

    def __init__(self, dim: int, eps: float, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        shape = x.shape
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
