"""Linear-patch backbone of the port (counterpart of
``mvlt_tpu/models/backbones/linear_patch.py:17-29``; the reference's
``modules/visual_feature_extractor.py:47-59``): a 16 x 16 stride-16 conv
3 -> ``features`` with bias, BatchNorm, ReLU, and the (B, features, 14, 14)
map at 224 returned as (B, 196, features) tokens in row-major (h, w) order.

JAX runs ``nn.Conv`` and ``nn.BatchNorm`` in XLA, outside any Pallas kernel,
so the port runs them as plain PyTorch in NCHW (cuDNN on the card), as its
ResNet does; the BatchNorm is the ResNet's flax-semantics one
(:class:`~mvlt_tpu_torch.models.backbones.resnet.BatchNorm`: momentum 0.9,
eps 1e-5, biased variance, f32 statistics, batch statistics in training).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.models.backbones.resnet import BatchNorm


class LinearPatch(nn.Module):
    """Conv (k = s = ``patch``) + BN + ReLU on (B, 3, H, W) in the compute
    dtype -> (B, H/p * W/p, features)."""

    def __init__(self, features: int = 768, patch: int = 16, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.proj = nn.Conv2d(3, features, patch, patch, bias=True,
                              dtype=dtype, device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.proj
        y = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride)
        return F.relu(self.bn(y, train)).flatten(2).transpose(1, 2)
