"""Attention masks of the fusion encoder (counterpart of
``mvlt_tpu/ops/masks.py:22-70``): the reference's bidirectional key mask
``[1, image_mask, 1, text_mask]``, its seq2seq (UniLM) mask, and their
additive ``(1 - m) * -10000`` bias, and the mask of one KV-cached decode
step."""

from __future__ import annotations

import torch

NEG_BIAS = -10000.0


def bidirectional_key_mask(image_mask: torch.Tensor,
                           text_mask: torch.Tensor = None) -> torch.Tensor:
    """(B, S) bool key mask for [CLS] + image + [SEP] (+ text, when
    ``text_mask`` is given)."""
    ones = torch.ones((image_mask.shape[0], 1), dtype=torch.bool,
                      device=image_mask.device)
    parts = [ones, image_mask.bool(), ones]
    if text_mask is not None:
        parts.append(text_mask.bool())
    return torch.cat(parts, dim=1)


def seq2seq_fusion_mask(batch: int, obj_end: int, total: int,
                        device=None) -> torch.Tensor:
    """(B, S, S) bool: causal, with every column of the image prefix
    (col <= obj_end) visible. As in the reference, text padding is ignored
    in this mode: padded keys stay visible (masks.py:9-10,36-41)."""
    idx = torch.arange(total, device=device)
    row, col = idx[:, None], idx[None, :]
    mask = (col <= row) | (col <= obj_end)
    return mask[None].expand(batch, total, total)


def decode_step_mask(batch: int, num_queries: int, cache_len: int,
                     write_pos: int, device=None) -> torch.Tensor:
    """(B, num_queries, cache_len) bool mask of one incremental decode step
    (``masks.py:44-56``): query i sits at absolute position ``write_pos +
    i`` and sees every cache slot at a position at or below its own; the
    slots not yet written lie above the last query and stay hidden."""
    q_pos = write_pos + torch.arange(num_queries, device=device)[:, None]
    k_pos = torch.arange(cache_len, device=device)[None, :]
    return (k_pos <= q_pos)[None].expand(batch, num_queries, cache_len)


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """Bool mask -> float32 additive bias with the -10000 fill. A (B, S) key
    mask gives the (B, S) key bias (the JAX package's (B, 1, 1, S) squeezed
    to the per-key form its fused kernel takes, fusion.py:128-129); a
    (B, S, S) mask gives the (B, S, S) per-query bias (its (B, 1, S, S)
    squeezed to the kernel's qbias, fusion.py:130-132)."""
    if mask.dim() not in (2, 3):
        raise ValueError(f"expected a (B, S) or (B, S, S) mask, got "
                         f"{tuple(mask.shape)}")
    return (1.0 - mask.float()) * NEG_BIAS
