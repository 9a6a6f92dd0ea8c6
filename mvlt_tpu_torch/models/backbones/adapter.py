"""Backbone adapter of the port (counterpart of
``mvlt_tpu/models/backbones/adapter.py:42-98``) for ``conv='swin'`` and
``conv in ('resnet101', 'resnet50')``: the backbone, a trailing exact GELU,
and ``resnet_fc`` to the fusion width (always for ResNet, only when the
width differs for Swin). Both backbones train with float32 master
parameters and bf16 compute: dense weights are cast at use, so their f32
grads come back through the cast; LayerNorm parameters and the Swin
relative-position tables stay float32."""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.resnet import ResNet
from mvlt_tpu_torch.models.backbones.swin import SwinTransformer
from mvlt_tpu_torch.ops.layers import Dense, gelu_exact


class VisualAdapter(nn.Module):
    def __init__(self, cfg: MVLTConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None):
        super().__init__()
        conv = cfg.conv.lower()
        self.dtype = compute_dtype or dtype
        hidden = cfg.fusion.hidden_size
        if conv in ("swin", "swintransformer"):
            self.nchw = False
            self.backbone = SwinTransformer(cfg.swin, dtype=dtype, device=device,
                                            compute_dtype=self.dtype)
            width = cfg.swin.num_features
        elif conv in ("resnet101", "resnet50"):
            self.nchw = True
            self.backbone = ResNet(cfg.resnet, dtype=dtype, device=device)
            width = cfg.resnet.feature_channels
        else:
            raise NotImplementedError(
                f"config.conv={cfg.conv!r} is not ported yet: the ViT and "
                "linear-patch backbones are ROADMAP.md queue A, 'Other "
                "backbones'")
        self.resnet_fc = None
        if self.nchw or width != hidden:
            self.resnet_fc = Dense(width, hidden, dtype=dtype, device=device)

    def forward(self, image: torch.Tensor, ops, train: bool = False,
                masks=None) -> torch.Tensor:
        """image: float (B, C, H, W) -> (B, N, hidden) in the compute dtype.
        ``train`` puts the ResNet's BatchNorms on batch statistics; ``masks``
        (a :class:`DropoutMasks`) turns the Swin backbone's DropPath on."""
        if image.dim() != 4 or image.dtype == torch.uint8:
            raise NotImplementedError(
                "two-view (B, 2, C, H, W) and uint8 inputs are not ported yet "
                "(ROADMAP.md queue A, 'Adapter inputs')")
        if self.nchw:
            tokens = self.backbone(image.to(self.dtype), train)
        else:
            x = image.permute(0, 2, 3, 1).to(self.dtype)            # NHWC
            tokens = self.backbone(x, ops, masks)
        tokens = gelu_exact(tokens)
        if self.resnet_fc is not None:
            tokens = self.resnet_fc(tokens, ops)
        return tokens
