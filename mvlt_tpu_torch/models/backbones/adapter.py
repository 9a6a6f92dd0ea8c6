"""Backbone adapter of the port (counterpart of
``mvlt_tpu/models/backbones/adapter.py:42-98``) for ``conv='swin'``:
NCHW -> NHWC, the Swin backbone, a trailing exact GELU, and ``resnet_fc``
only when the backbone width differs from the fusion width."""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.swin import SwinTransformer
from mvlt_tpu_torch.ops.layers import Dense, gelu_exact


class VisualAdapter(nn.Module):
    def __init__(self, cfg: MVLTConfig, *, dtype: torch.dtype, device):
        super().__init__()
        conv = cfg.conv.lower()
        if conv not in ("swin", "swintransformer"):
            raise NotImplementedError(
                f"config.conv={cfg.conv!r} is not ported yet: the ResNet, ViT "
                "and linear-patch backbones are ROADMAP.md queue A, item 13")
        self.dtype = dtype
        self.backbone = SwinTransformer(cfg.swin, dtype=dtype, device=device)
        self.resnet_fc = None
        if cfg.swin.num_features != cfg.fusion.hidden_size:
            self.resnet_fc = Dense(cfg.swin.num_features,
                                   cfg.fusion.hidden_size, dtype=dtype,
                                   device=device)

    def forward(self, image: torch.Tensor, ops) -> torch.Tensor:
        """image: float (B, C, H, W) -> (B, N, hidden)."""
        if image.dim() != 4 or image.dtype == torch.uint8:
            raise NotImplementedError(
                "two-view (B, 2, C, H, W) and uint8 inputs are not ported yet "
                "(ROADMAP.md queue A, item 4)")
        x = image.permute(0, 2, 3, 1).to(self.dtype)            # NHWC
        tokens = gelu_exact(self.backbone(x, ops))
        if self.resnet_fc is not None:
            tokens = self.resnet_fc(tokens, ops)
        return tokens
