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
(``utils/convert.py`` maps them).

Training with ``dropout`` / ``attention_dropout`` above 0 (both 0 in JAX's
default and in the reference) follows flax's ``ViT`` and ``ViTBlock``
(``vit.py:36-45, 70``), its masks drawn from the step's mask source in
flax's trace order: the position dropout, then in each block the
attention-probability dropout, the dropout after attention, after the GELU
and after ``mlp_fc2``. flax's ``MultiHeadDotProductAttention`` broadcasts
its attention mask (``broadcast_dropout=True``): one (1, 1, N, N) draw for
every image and head; that attention runs in plain torch with the explicit
mask (:func:`~mvlt_tpu_torch.ops.attention.dropout_attention`), as JAX
runs it in XLA, and SDPA serves wherever no attention dropout is on.

Tensor parallelism (:meth:`ViTBlock.set_tp`, from
:func:`mvlt_tpu_torch.parallel.shard.apply_mesh_`; JAX's Megatron rules,
``partition.py:37-47``): a block holds its rank's heads of ``qkv`` (q, k
and v of the same heads), its input columns of ``out`` and ``mlp_fc2`` and
its output columns of ``mlp_fc1``. ``qkv`` and ``mlp_fc1`` are
column-parallel after Megatron's *f* (``comm.copy_to_group``); attention
runs on the rank's heads (the attention dropout's (1, 1, N, N) draw is the
same for every head, so it needs no slice); ``out`` and ``mlp_fc2`` are
row-parallel: K1's f32 partial sums, *g* (``comm.reduce_from_group``), the
bias once, then the dropout and the residual; the GELU output's dropout is
the rank's columns of the whole draw. Where mp does not divide the heads
the attention half is held whole and only the MLP splits.
"""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import ViTConfig
from mvlt_tpu_torch.ops.attention import (dropout_attention,
                                          multi_head_attention)
from mvlt_tpu_torch.ops.blocks import row_parallel_dense
from mvlt_tpu_torch.ops.layers import (Dense, LayerNorm, dropout,
                                       dropout_part, gelu_exact)
from mvlt_tpu_torch.parallel import comm

VIT_LN_EPS = 1e-6


class ViTBlock(nn.Module):
    """Pre-LN encoder block (``vit.py:23-48``)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.ln_1 = LayerNorm(hidden, VIT_LN_EPS, device=device)
        self.qkv = Dense(hidden, 3 * hidden, dtype=dtype, device=device)
        self.out = Dense(hidden, hidden, dtype=dtype, device=device)
        self.ln_2 = LayerNorm(hidden, VIT_LN_EPS, device=device)
        self.mlp_fc1 = Dense(hidden, mlp_dim, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(mlp_dim, hidden, dtype=dtype, device=device)
        self.tp_attn = self.tp_mlp = None

    def set_tp(self, attn, mlp) -> None:
        """Put the block on a model group (``parallel/shard.TP``): ``attn``
        the group when its attention half is split over the heads (None:
        held whole), ``mlp`` the group when its MLP is split."""
        self.tp_attn, self.tp_mlp = attn, mlp

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        """``masks`` (a :class:`DropoutMasks`) turns the dropouts on."""
        B, N, C = x.shape
        rate, ta, tm = self.dropout, self.tp_attn, self.tp_mlp
        nH = self.num_heads // (1 if ta is None else ta.size)
        Dh = C // self.num_heads
        h = self.ln_1(x, ops)
        h = self.qkv(h if ta is None else comm.copy_to_group(h, ta.group), ops)
        q, k, v = h.view(B, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
        if masks is not None and self.attention_dropout > 0.0:
            ctx = dropout_attention(q, k, v, masks, self.attention_dropout)
        else:
            ctx = multi_head_attention(q, k, v)
        ctx = ctx.transpose(1, 2).reshape(B, N, nH * Dh)
        h = self.out(ctx, ops) if ta is None else \
            row_parallel_dense(self.out, ctx, ops, ta)
        x = x + dropout(h, masks, rate)
        h = self.ln_2(x, ops)
        h = self.mlp_fc1(h if tm is None else comm.copy_to_group(h, tm.group),
                         ops)
        y = dropout_part(gelu_exact(h), masks, rate, tm)
        y = self.mlp_fc2(y, ops) if tm is None else \
            row_parallel_dense(self.mlp_fc2, y, ops, tm)
        return x + dropout(y, masks, rate)


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
            ViTBlock(cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim, cfg.dropout,
                     cfg.attention_dropout, dtype=dtype, device=device)
            for _ in range(cfg.num_layers)])
        self.ln = LayerNorm(cfg.hidden_dim, VIT_LN_EPS, device=device)

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        """``masks`` (a :class:`DropoutMasks`) turns the dropouts on; its
        draws come in flax's order (module docstring)."""
        cfg = self.config
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
        x = dropout(x, masks, cfg.dropout)                  # vit.py:70
        for block in self.blocks:
            x = block(x, ops, masks)
        return self.ln(x[:, 1:], ops)       # per row: the class token drops
