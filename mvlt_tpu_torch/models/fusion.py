"""Single-stream fusion encoder of the port (counterpart of
``mvlt_tpu/models/fusion.py``), the non-cached path in both mask modes.

Sequence ``[CLS] <image tokens> [SEP] <text tokens>``; token type 1 for
positions <= obj_end and 0 for the text; positions a plain arange. As in the
reference, the word-embedding table has ``vocab_size + 1`` rows and the
embeddings enter the encoder with no LayerNorm and no dropout
(fusion.py:8-14, 331-352). Each post-LN BERT layer runs its attention half
then its MLP half, with q / k / v held as one fused (3H, H) dense
(fusion.py:122-126), routed as the JAX kernel gates route them
(fusion.py:113-179, 236-262): ``fused_attn_ln`` / ``fused_mlp_ln`` when
nothing is masked, ``fused_attn_ln_masked`` when a dropout mask or the
seq2seq bias is live, ``fused_mlp_ln_masked`` under hidden dropout.

Masks. The bidirectional mode adds the (B, S) key-padding bias; the seq2seq
(UniLM) mode adds a (B, S, S) per-query bias and no key bias (JAX passes a
zero key bias there, fusion.py:130-132; adding nothing is the same), and
ignores text padding, as the reference does. In training (a mask source
given) each layer draws, in JAX's order, the attention-dropout mask
(B, nH, S, S), the attention output's hidden-dropout mask (B, S, H) and the
MLP output's (B, S, H), each only where its rate is above 0.

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
from mvlt_tpu_torch.ops import masks as mask_lib
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
        self.attn_dropout = cfg.attention_probs_dropout_prob
        self.hidden_dropout = cfg.hidden_dropout_prob

    def forward(self, hidden: torch.Tensor, kbias, ops, qbias=None,
                masks=None) -> torch.Tensor:
        """kbias (B, S) f32 or None, qbias (B, S, S) f32 or None; ``masks``
        (a :class:`DropoutMasks`) turns training dropout on."""
        dt = hidden.dtype
        B, S, H = hidden.shape

        def w(dense):
            return dense.weight.to(dt), dense.bias.to(dt)

        def mask(rate, shape):
            if masks is None or rate <= 0.0:
                return None
            return masks.scaled(1.0 - rate, shape, dt, hidden.device)

        amask = mask(self.attn_dropout, (B, self.num_heads, S, S))
        hmask = mask(self.hidden_dropout, (B, S, H))
        ln1 = (self.out_layernorm.weight, self.out_layernorm.bias)
        if qbias is None and amask is None and hmask is None:
            h = ops.fused_attn_ln(hidden, *w(self.qkv), *w(self.out), kbias,
                                  *ln1, self.scale, self.num_heads, self.eps)
        else:
            h = ops.fused_attn_ln_masked(hidden, *w(self.qkv), *w(self.out),
                                         kbias, qbias, amask, hmask, *ln1,
                                         self.scale, self.num_heads, self.eps)
        ln2 = (self.output_layernorm.weight, self.output_layernorm.bias)
        hmask = mask(self.hidden_dropout, (B, S, H))
        if hmask is None:
            return ops.fused_mlp_ln(h, *w(self.intermediate), *w(self.output),
                                    *ln2, self.eps)
        return ops.fused_mlp_ln_masked(h, *w(self.intermediate),
                                       *w(self.output), hmask, *ln2, self.eps)


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

    def forward(self, text_idx, text_mask, image_feature, image_mask, ops,
                seq2seq: bool = False, masks=None):
        """Returns (hidden (B, S, H), pooled (B, H) or None). ``seq2seq``
        selects the UniLM mask; ``masks`` (a :class:`DropoutMasks`) turns
        training dropout on."""
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

        if seq2seq:
            kbias, qbias = None, mask_lib.mask_to_bias(
                mask_lib.seq2seq_fusion_mask(B, obj_end, total,
                                             vl.device)).contiguous()
        else:
            kbias, qbias = mask_lib.mask_to_bias(
                mask_lib.bidirectional_key_mask(image_mask, text_mask)), None
        for layer in self.layers:
            hidden = layer(hidden, kbias, ops, qbias, masks)
        pooled = None
        if self.pooler is not None:
            first = self.pooler(hidden[:, 0], ops)
            pooled = torch.tanh(first.float()).to(first.dtype)
        return hidden, pooled
