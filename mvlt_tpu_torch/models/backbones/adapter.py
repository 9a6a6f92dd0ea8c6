"""Backbone adapter of the port (counterpart of
``mvlt_tpu/models/backbones/adapter.py:42-98``) for every ``config.conv``
of the JAX package: ``'swin'``, ``'resnet101'`` / ``'resnet50'``,
``'vit'`` (ViT-B/16) and ``'linear'`` (the linear patch). The backbone, a
trailing exact GELU, and ``resnet_fc`` to the fusion width where JAX
creates it (``adapter.py:53-75``): always for ResNet, for Swin and ViT only
when the width differs, never for the linear patch (its conv is already
``fusion.hidden_size`` wide). The two-view IU X-Ray input (B, 2, C, H, W)
encodes each view by its own backbone call, view 0 then view 1, and
concatenates the tokens into (B, 2N, hidden) (``adapter.py:84-98``); the
Swin DropPath masks are drawn in that order, before the fusion layers'.
Every backbone trains with float32 master parameters and bf16 compute:
dense and conv weights are cast at use, so their f32 grads come back
through the cast; LayerNorm and BatchNorm parameters, the Swin
relative-position tables and the ViT's class token and position table stay
float32. ``train`` puts the BatchNorms of the ResNet and the linear patch
on batch statistics. ``remat_backbone`` rematerialises the Swin's blocks
(``adapter.py:57``); JAX remats no other backbone, and neither does the
port.

A uint8 image is a raw (B, H, W, 3) (or (B, 2, H, W, 3)) frame of the device-normalize host
path (``ImageFolderSource(normalize="device")``, ``U8CacheSource``):
:func:`device_var_normalize` casts and normalizes it on the device first,
as JAX's adapter does (``adapter.py:26-39, 92-93``)."""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.linear_patch import LinearPatch
from mvlt_tpu_torch.models.backbones.resnet import ResNet
from mvlt_tpu_torch.models.backbones.swin import SwinTransformer
from mvlt_tpu_torch.models.backbones.vit import ViT
from mvlt_tpu_torch.ops.layers import Dense, gelu_exact


def device_var_normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 (..., 3, H, W): per image and
    channel ``(x - mean) / var`` over H and W, the population variance (the
    reference's variance-not-std quirk, ``run_pretrain_rgc_roco_medicat.py:
    104-110``), in f32 as :func:`mvlt_tpu_torch.data.transforms.
    normalize_image_var` computes it on the host. Plain torch, as JAX
    computes it in XLA. The result is a channels-first view of a
    channels-last tensor: moving the channels back is free."""
    x = img_u8.to(torch.float32)
    var, mean = torch.var_mean(x, dim=(-3, -2), correction=0, keepdim=True)
    return ((x - mean) / var).movedim(-1, -3)


def image_tokens(cfg: MVLTConfig, image_size: int = 224) -> int:
    """Tokens that one view of ``image_size`` pixels gives the fusion
    encoder: the Swin's and the ViT's at their config's image size (49 for
    Swin-S / Swin-B @224, 196 for ViT-B/16), the ResNet's map at stride 32
    and the linear patch's at stride 16 (49 and 196 at 224)."""
    conv = cfg.conv.lower()
    if conv in ("swin", "swintransformer"):
        side = cfg.swin.patches_resolution[0] // 2 ** (cfg.swin.num_layers - 1)
    elif conv in ("vit", "visiontransformer"):
        side = cfg.vit.image_size // cfg.vit.patch_size
    elif conv == "linear":
        side = image_size // 16
    elif conv in ("resnet101", "resnet50"):
        side = image_size // 32
    else:
        raise NotImplementedError(f"no such config.conv: {cfg.conv!r}")
    return side * side


class VisualAdapter(nn.Module):
    def __init__(self, cfg: MVLTConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None):
        super().__init__()
        conv = cfg.conv.lower()
        self.dtype = compute_dtype or dtype
        hidden = cfg.fusion.hidden_size
        # kind: how the backbone is called ("nchw": the cuDNN convolutions
        # of the ResNet and the linear patch); needs_proj: where JAX
        # creates resnet_fc (adapter.py:53, 59, 63, 67)
        if conv == "linear":
            self.kind, needs_proj = "nchw", False
            self.backbone = LinearPatch(hidden, dtype=dtype, device=device)
            width = hidden
        elif conv in ("swin", "swintransformer"):
            self.kind = "swin"
            self.backbone = SwinTransformer(cfg.swin, dtype=dtype, device=device,
                                            compute_dtype=self.dtype,
                                            remat=cfg.remat_backbone)
            width = cfg.swin.num_features
            needs_proj = width != hidden
        elif conv in ("resnet101", "resnet50"):
            self.kind, needs_proj = "nchw", True
            self.backbone = ResNet(cfg.resnet, dtype=dtype, device=device)
            width = cfg.resnet.feature_channels
        elif conv in ("vit", "visiontransformer"):
            self.kind = "vit"
            self.backbone = ViT(cfg.vit, dtype=dtype, device=device,
                                compute_dtype=self.dtype)
            width = cfg.vit.hidden_dim
            needs_proj = width != hidden
        else:
            raise NotImplementedError(f"no such config.conv: {cfg.conv!r}")
        self.resnet_fc = (Dense(width, hidden, dtype=dtype, device=device)
                          if needs_proj else None)

    def forward(self, image: torch.Tensor, ops, train: bool = False,
                masks=None) -> torch.Tensor:
        """image: float (B, C, H, W) or uint8 (B, H, W, 3), or their
        two-view forms (B, 2, C, H, W) / (B, 2, H, W, 3) -> (B, N, hidden)
        in the compute dtype (N twice a view's tokens for two views).
        ``train`` puts the BatchNorms of the ResNet and the linear patch on
        batch statistics; ``masks`` (a :class:`DropoutMasks`) turns the
        Swin backbone's DropPath and dropout and the ViT's dropout on."""
        if image.dtype == torch.uint8:
            image = device_var_normalize(image)
        if image.dim() == 5:
            return torch.cat([self._encode_one(image[:, v], ops, train, masks)
                              for v in range(image.shape[1])], dim=1)
        return self._encode_one(image, ops, train, masks)

    def _encode_one(self, image, ops, train, masks):
        if self.kind == "nchw":
            tokens = self.backbone(image.to(self.dtype), train)
        else:
            # a view of a two-view batch is strided; the patch embedding's
            # reshape copies it into the rows the kernels take
            x = image.permute(0, 2, 3, 1).to(self.dtype)            # NHWC
            tokens = self.backbone(x, ops, masks)        # Swin or ViT
        tokens = gelu_exact(tokens)
        if self.resnet_fc is not None:
            tokens = self.resnet_fc(tokens, ops)
        return tokens
