"""Single-stream fusion encoder of the port (counterpart of
``mvlt_tpu/models/fusion.py``), the non-cached bidirectional path.

Sequence ``[CLS] <image tokens> [SEP] <text tokens>``; token type 1 for
positions <= obj_end and 0 for the text; positions a plain arange. As in the
reference, the word-embedding table has ``vocab_size + 1`` rows and the
embeddings enter the encoder with no LayerNorm (fusion.py:8-14, 331-343).
Each post-LN BERT layer runs ``fused_attn_ln`` then ``fused_mlp_ln``, with
q / k / v held as one fused (3H, H) dense (fusion.py:122-126).

Dense weights and embeddings are cast to the compute dtype at every use (as
the JAX layers do with ``.astype(cdt)``), so a model whose parameters are
float32 masters trains in bf16: the counterparts run as autograd Functions
whenever a gradient is needed, and their weight grads return through the
cast to the f32 masters. LayerNorm parameters stay f32.
"""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import FusionConfig
from mvlt_tpu_torch.ops import masks
from mvlt_tpu_torch.ops.layers import Dense, LayerNorm


class EncoderLayer(nn.Module):
    def __init__(self, cfg: FusionConfig, *, dtype: torch.dtype, device):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_heads, self.eps = cfg.num_attention_heads, eps
        self.qkv = Dense(H, 3 * H, dtype=dtype, device=device)
        self.out = Dense(H, H, dtype=dtype, device=device)
        self.out_layernorm = LayerNorm(H, eps, device=device)
        self.intermediate = Dense(H, cfg.intermediate_size, dtype=dtype,
                                  device=device)
        self.output = Dense(cfg.intermediate_size, H, dtype=dtype,
                            device=device)
        self.output_layernorm = LayerNorm(H, eps, device=device)
        self.scale = cfg.head_dim ** -0.5

    def forward(self, hidden: torch.Tensor, kbias: torch.Tensor,
                ops) -> torch.Tensor:
        dt = hidden.dtype

        def w(dense):
            return dense.weight.to(dt), dense.bias.to(dt)

        h = ops.fused_attn_ln(hidden, *w(self.qkv), *w(self.out), kbias,
                              self.out_layernorm.weight,
                              self.out_layernorm.bias, self.scale,
                              self.num_heads, self.eps)
        return ops.fused_mlp_ln(h, *w(self.intermediate), *w(self.output),
                                self.output_layernorm.weight,
                                self.output_layernorm.bias, self.eps)


class FusionEncoder(nn.Module):
    """Embeddings + key-padding bias + N post-LN layers + optional pooler
    (dense + tanh on [CLS], fusion.py:272-284). Returns (hidden, pooled)."""

    def __init__(self, cfg: FusionConfig, *, add_pooling_layer: bool,
                 cls_token_id: int, sep_token_id: int, dtype: torch.dtype,
                 device, compute_dtype=None):
        super().__init__()
        H = cfg.hidden_size
        self.compute_dtype = compute_dtype or dtype
        self.cls_token_id, self.sep_token_id = cls_token_id, sep_token_id

        def table(rows):
            return nn.Parameter(torch.empty(rows, H, dtype=dtype,
                                            device=device))
        self.word_embeddings = table(cfg.embedding_rows)
        self.position_embeddings = table(cfg.max_position_embeddings)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg, dtype=dtype, device=device)
             for _ in range(cfg.num_hidden_layers)])
        self.pooler = (Dense(H, H, dtype=dtype, device=device)
                       if add_pooling_layer else None)

    def forward(self, text_idx, text_mask, image_feature, image_mask, ops):
        B, num_obj = image_feature.shape[:2]
        obj_end = num_obj + 1                            # index of [SEP]
        total = num_obj + text_idx.shape[1] + 2
        dt = self.compute_dtype
        word = self.word_embeddings
        cls = word[self.cls_token_id].to(dt).expand(B, 1, -1)
        sep = word[self.sep_token_id].to(dt).expand(B, 1, -1)
        vl = torch.cat([cls, image_feature.to(dt), sep,
                        word[text_idx.long()].to(dt)], dim=1)
        pos = torch.arange(total, device=vl.device)
        token_type = (pos <= obj_end).long()
        hidden = (vl + self.token_type_embeddings[token_type].to(dt)[None]
                  + self.position_embeddings[pos].to(dt)[None])

        mask = masks.bidirectional_key_mask(image_mask, text_mask)
        kbias = masks.mask_to_bias(mask)                          # (B, S)
        for layer in self.layers:
            hidden = layer(hidden, kbias, ops)
        pooled = None
        if self.pooler is not None:
            first = self.pooler(hidden[:, 0], ops)
            pooled = torch.tanh(first.float()).to(first.dtype)
        return hidden, pooled
