"""Plain attention of the port (counterpart of ``mvlt_tpu/ops/attention.py``),
for the layers that JAX keeps out of its fused kernels: the KV-cached decode
steps and the prefill that returns each layer's (k, v)
(``fusion.py:113,236``), and the ViT's attention (flax's
``MultiHeadDotProductAttention``, with its dropout in training). JAX runs
them in XLA (``_use_pallas`` is false off the TPU and for decode shapes,
and ``flash_attention`` is a stub), so they are plain PyTorch here too, not
a kernel.

:func:`multi_head_attention`, what the layers call as JAX's layers do,
computes what JAX's dispatcher falls back to there, ``reference_attention``,
with ``F.scaled_dot_product_attention``, which reads a bf16 cache where it
lies instead of copying it to float32 (a decode step attends over the whole
static cache)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """JAX's ``reference_attention`` (``attention.py:35-55``) on
    ``F.scaled_dot_product_attention``. q, k, v (..., H, S, D); bias
    broadcastable to (..., H, S_q, S_k), additive (0 / -10000). Float32
    scores (scale on q) and softmax, probabilities rounded to v's dtype for
    PV, float32 accumulation; returns v's dtype. The bias is passed in q's
    dtype, as SDPA takes it: in bf16 the -10000 fill becomes -9984, which
    zeroes a key's weight just as -10000 does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        bias = bias.to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                          scale=scale)


def dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      masks, rate: float) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention`` with its attention dropout on
    (``dot_product_attention_weights``, ``broadcast_dropout=True``), in
    plain torch as JAX runs it in XLA. q, k, v (B, H, N, D). q is divided
    by sqrt(D) in its dtype; the scores and the softmax are float32 (flax
    keeps them in q's dtype: in bf16 the port rounds once, after the
    softmax, where flax rounds the scores too), the probabilities rounded to
    q's dtype and multiplied by ``keep.astype(dtype) / keep_prob`` in that
    dtype, one (1, 1, N, N) keep mask drawn from ``masks`` for every image
    and head; then PV. Returns (B, H, N, D) in v's dtype."""
    keep = 1.0 - rate
    dtype = q.dtype
    q = q / torch.tensor(q.shape[-1] ** 0.5, dtype=dtype)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)),
                      dim=-1).to(dtype)
    mask = masks.draw(keep, (1, 1) + tuple(p.shape[-2:]), p.device)
    p = p * (mask.to(dtype) / torch.tensor(keep, dtype=dtype,
                                           device=p.device))
    return torch.matmul(p, v)
