"""Bottleneck ResNet backbone of the port (counterpart of
``mvlt_tpu/models/backbones/resnet.py:24-88``): ResNet-50/101 without
avgpool / fc, torchvision "v1.5" (the stride sits on the 3x3 conv), in NCHW.

The JAX package computes these convolutions and BatchNorms in XLA, outside
any Pallas kernel, so the port runs them as plain PyTorch (cuDNN on the
card). Padding is torch-style symmetric ``k // 2``, as the JAX module makes
it explicit.

BatchNorm holds flax's semantics (``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)``), not ``torch.nn.BatchNorm2d``'s: in training it normalises
with the batch's biased variance and updates ``running = 0.9 * running +
0.1 * batch`` with that same biased variance (torch updates with the
unbiased one); the statistics are f32 whatever the compute dtype, and the
output is in the compute dtype.

Over a data group (``BatchNorm.group``, set by the mesh: JAX trains these
backbones under GSPMD, ``steps.py:212-219``) the training moments are the
global batch's: (sum x, sum x^2) in f32 are summed over the group with a
gradient through the sum, the variance is JAX's fast E[x^2] - E[x]^2, and
the running buffers move by the same global moments on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.config import ResNetConfig


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over (B, C, H, W), flax semantics (see the
    module docstring). ``weight`` / ``bias`` and the running buffers are
    f32. The normalisation is ``F.batch_norm`` (cuDNN on the card: f32
    statistics, biased variance); its running-variance update, which uses
    the unbiased variance, is restated with the biased one."""

    def __init__(self, channels: int, *, device, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.group = None

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        from mvlt_tpu_torch.parallel import comm
        xf = x.float()
        sums = torch.stack([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])
        sums = comm.sum_over_group(sums, self.group)
        n = x.numel() // x.shape[1] * comm.group_size(self.group)
        mean, ex2 = sums[0] / n, sums[1] / n
        var = (ex2 - mean.square()).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean.detach())
            self.running_var.mul_(m).add_((1 - m) * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        rm, rv = self.running_mean, self.running_var
        if train and self.group is not None:
            return self._global(x)
        if not train:
            return F.batch_norm(x, rm, rv, self.weight, self.bias, False, 0.0,
                                self.eps)
        m = self.momentum
        upd = rv.clone()   # the graph may keep the buffer it was given
        y = F.batch_norm(x, rm, upd, self.weight, self.bias, True, 1.0 - m,
                         self.eps)
        with torch.no_grad():
            # upd = m * rv + (1 - m) * var * n / (n - 1); flax uses var itself
            n = x.numel() // x.shape[1]
            rv.copy_(m * rv + (upd - m * rv) * ((n - 1) / n))
        return y


class ConvBN(nn.Module):
    """Bias-free conv (weights cast to the input's dtype at use) + BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, padding=kernel // 2,
                              bias=False, dtype=dtype, device=device)
        self.bn = BatchNorm(c_out, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding)
        return self.bn(y, train)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x), projection shortcut on a change of
    shape (torchvision Bottleneck, expansion 4)."""

    def __init__(self, c_in: int, features: int, stride: int, *,
                 dtype: torch.dtype, device):
        super().__init__()
        out = features * 4
        kw = dict(dtype=dtype, device=device)
        self.conv1 = ConvBN(c_in, features, 1, **kw)
        self.conv2 = ConvBN(features, features, 3, stride, **kw)
        self.conv3 = ConvBN(features, out, 1, **kw)
        self.downsample = (ConvBN(c_in, out, 1, stride, **kw)
                           if c_in != out or stride != 1 else None)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x, train)
        y = F.relu(self.conv1(x, train))
        y = F.relu(self.conv2(y, train))
        return F.relu(self.conv3(y, train) + shortcut)


class ResNet(nn.Module):
    """Stem (7x7/2 conv + BN + ReLU, 3x3/2 max-pool) and the bottleneck
    stages; returns the last map as (B, H * W, C) tokens. Blocks are named
    as in the flax tree (``layer{stage}_{block}``)."""

    def __init__(self, config: ResNetConfig, *, dtype: torch.dtype, device):
        super().__init__()
        cfg = config
        self.stem = ConvBN(3, cfg.width, 7, 2, dtype=dtype, device=device)
        self.blocks = nn.ModuleDict()
        c_in = cfg.width
        for stage, n in enumerate(cfg.layers):
            features = cfg.width * 2 ** stage
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.blocks[f"layer{stage + 1}_{b}"] = Bottleneck(
                    c_in, features, stride, dtype=dtype, device=device)
                c_in = features * 4

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (B, 3, H, W) in the compute dtype -> (B, H/32 * W/32, C)."""
        x = F.relu(self.stem(x, train))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks.values():
            x = block(x, train)
        return x.flatten(2).transpose(1, 2)
