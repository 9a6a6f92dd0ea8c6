"""ViT-B/16 backbone of the port (counterpart of
``mvlt_tpu/models/backbones/vit.py:23-78``): all patch tokens, the class
token dropped, as the reference's ``VisionTransformerBaseWithoutPooling``
(``modules/visual_feature_extractor.py:65-107``) returns them.

Patchify as JAX does it: NHWC images reshaped to (B, H/p, p, W/p, p, C), each
patch flattened in (py, px, c) order and projected by ``patch_proj`` (a
dense layer); the class token prepended, the position table added. Then
``num_layers`` pre-LN blocks (LN -> multi-head attention -> +x, LN -> MLP
with the erf GELU -> +x), LayerNorm eps 1e-6 throughout, a final ``ln``,
and the class token dropped.

JAX computes this module in XLA, outside any Pallas kernel (flax
``MultiHeadDotProductAttention``, ``nn.Dense``, ``nn.LayerNorm``), so no
kernel replaces a TPU kernel here: the dense layers are :class:`Dense` (K1
in serving, ``F.linear`` under autograd), the LayerNorms :class:`LayerNorm`
(K3 in serving), and the attention
:func:`~mvlt_tpu_torch.ops.attention.multi_head_attention` (SDPA), as the
fusion encoder's decode path runs it. q / k / v are one fused ``qkv``
dense (3 * hidden, hidden) where flax keeps three ``DenseGeneral``
(``utils/convert.py`` maps them). Dropout above 0 in training is not
ported: both rates are 0 in JAX's default and in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import ViTConfig
from mvlt_tpu_torch.ops.attention import multi_head_attention
from mvlt_tpu_torch.ops.layers import Dense, LayerNorm, gelu_exact

VIT_LN_EPS = 1e-6


class ViTBlock(nn.Module):
    """Pre-LN encoder block (``vit.py:23-48``)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.ln_1 = LayerNorm(hidden, VIT_LN_EPS, device=device)
        self.qkv = Dense(hidden, 3 * hidden, dtype=dtype, device=device)
        self.out = Dense(hidden, hidden, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(hidden, VIT_LN_EPS, device=device)
        self.mlp_fc1 = Dense(hidden, mlp_dim, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(mlp_dim, hidden, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        B, N, C = x.shape
        nH = self.num_heads
        q, k, v = self.qkv(self.ln_1(x, ops), ops).view(
            B, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4).unbind(0)
        ctx = multi_head_attention(q, k, v)
        x = x + self.out(ctx.transpose(1, 2).reshape(B, N, C), ops)
        y = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.ln_2(x, ops), ops)),
                         ops)
        return x + y


class ViT(nn.Module):
    """ViT encoder on NHWC images (B, H, W, C) -> (B, N, hidden), N = (H / p)
    * (W / p) (``vit.py:51-78``). ``dtype`` is the parameters' dtype,
    ``compute_dtype`` (default: the same) the activations'; the class token
    and the position table stay float32, added in the compute dtype as JAX
    casts them. The position table has ``(image_size / p) ** 2 + 1`` rows."""

    def __init__(self, config: ViTConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None):
        super().__init__()
        cfg = config
        self.config, self.dtype = cfg, compute_dtype or dtype
        p = cfg.patch_size
        self.tokens = (cfg.image_size // p) ** 2
        self.patch_proj = Dense(p * p * 3, cfg.hidden_dim, dtype=dtype,
                                device=device)
        self.cls_token = nn.Parameter(torch.zeros(
            1, 1, cfg.hidden_dim, dtype=torch.float32, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(
            1, self.tokens + 1, cfg.hidden_dim, dtype=torch.float32,
            device=device))
        self.blocks = nn.ModuleList([
            ViTBlock(cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim, dtype=dtype,
                     device=device) for _ in range(cfg.num_layers)])
        self.ln = LayerNorm(cfg.hidden_dim, VIT_LN_EPS, device=device)

    def forward(self, x: torch.Tensor, ops, train: bool = False
                ) -> torch.Tensor:
        cfg = self.config
        if train and (cfg.dropout or cfg.attention_dropout):
            raise NotImplementedError(
                f"ViT training with dropout={cfg.dropout} / attention_dropout"
                f"={cfg.attention_dropout}: only 0 is ported (ROADMAP.md "
                "queue A, 'Other backbones')")
        B, H, W, C = x.shape
        p = cfg.patch_size
        n = (H // p) * (W // p)
        if n != self.tokens:
            raise ValueError(
                f"a {H}x{W} image gives {n} patches of {p}; the position "
                f"table was built for {self.tokens} (ViTConfig.image_size="
                f"{cfg.image_size})")
        x = x.to(self.dtype).reshape(B, H // p, p, W // p, p, C).permute(
            0, 1, 3, 2, 4, 5)
        x = self.patch_proj(x.reshape(B, n, p * p * C), ops)
        cls = self.cls_token.to(x.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        for block in self.blocks:
            x = block(x, ops)
        return self.ln(x[:, 1:], ops)       # per row: the class token drops
