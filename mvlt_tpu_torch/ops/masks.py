"""Attention masks of the bidirectional fusion path (counterpart of
``mvlt_tpu/ops/masks.py:22-70``): the reference's key mask
``[1, image_mask, 1, text_mask]`` and its additive ``(1 - m) * -10000``
bias. The seq2seq and decode masks come with the decode slice."""

from __future__ import annotations

import torch

NEG_BIAS = -10000.0


def bidirectional_key_mask(image_mask: torch.Tensor,
                           text_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool key mask for [CLS] + image + [SEP] + text."""
    ones = torch.ones((image_mask.shape[0], 1), dtype=torch.bool,
                      device=image_mask.device)
    return torch.cat([ones, image_mask.bool(), ones, text_mask.bool()], dim=1)


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool key mask -> (B, S) float32 additive key bias with the
    -10000 fill (the (B, 1, 1, S) bias of the JAX package, squeezed to the
    per-key form its fused kernel takes, fusion.py:128-129)."""
    if mask.dim() != 2:
        raise ValueError(f"expected a (B, S) key mask, got {tuple(mask.shape)}")
    return (1.0 - mask.float()) * NEG_BIAS
