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
seq2seq bias is live, ``fused_mlp_ln_masked`` under hidden dropout, and
``fused_attn_ln_adrop`` when ``MVLT_KERNEL_DROPOUT`` is set, the compute
dtype is bf16 and attention dropout is on in training (fusion.py:143-150):
the layer then draws a (2,) seed in place of the attention-dropout mask
and the kernels draw the mask themselves.

Masks. The bidirectional mode adds the (B, S) key-padding bias; the seq2seq
(UniLM) mode adds a (B, S, S) per-query bias and no key bias (JAX passes a
zero key bias there, fusion.py:130-132; adding nothing is the same), and
ignores text padding, as the reference does. In training (a mask source
given) each layer draws, in JAX's order, the attention-dropout mask
(B, nH, S, S), the attention output's hidden-dropout mask (B, S, H) and the
MLP output's (B, S, H), each only where its rate is above 0 (with in-kernel
dropout the seed takes the attention mask's place in that order).

Dense weights and embeddings are cast to the compute dtype at every use (as
the JAX layers do with ``.astype(cdt)``), so a model whose parameters are
float32 masters trains in bf16: the counterparts run as autograd Functions
whenever a gradient is needed, and their weight grads return through the
cast to the f32 masters. LayerNorm parameters stay f32.

KV-cached decoding (``fusion.py:62-68,367-400``). ``forward_kv`` is the
prefill that returns each layer's (k, v) (JAX's ``need_kv``): its attention
halves leave the fused kernel and run plain, as JAX's gate sends them
(``fusion.py:113``): the qkv / out products through ``Dense`` (K1 in
serving), :func:`~mvlt_tpu_torch.ops.attention.multi_head_attention`, the
LayerNorm through ``LayerNorm`` (K3); its MLP halves stay on
``fused_mlp_ln``, whose JAX gate does not test ``need_kv``
(``fusion.py:236-262``). ``decode_step`` runs T = 1 or 2 tokens against a
static cache (:func:`init_cache`) with both halves plain, writing each
layer's new (k, v) into the stacked cache in place.

``remat=True`` (``MVLTConfig.remat_fusion``, JAX's ``nn.remat`` of every
``EncoderLayer``, fusion.py:309-312) runs each layer of :meth:`forward`
under :func:`~mvlt_tpu_torch.ops.layers.rematerialized` while autograd
records it, in both mask modes: the backward recomputes the layer on the
masks and the in-kernel dropout seed of its first run. The prefill and the
decode steps run without autograd and are unchanged.

Tensor parallelism (``tp``, set by :func:`mvlt_tpu_torch.parallel.shard.
apply_mesh_`; JAX's Megatron rules under GSPMD, ``partition.py:29-52``).
A layer then holds its rank's heads of the fused qkv (the same heads of q,
k and v), its rows of ``out``, its columns of ``intermediate`` and its rows
of ``output``, and runs the counterparts' TP form on ``num_heads / mp``
heads (``ops/blocks.py``: the row-parallel product, Megatron's *g*, then
bias, hidden mask, residual and LayerNorm). Without in-kernel dropout a
rank draws the (B, nH, S, S) attention-dropout mask of all heads and keeps
its own, and draws the (B, S, H) hidden masks whole: a model group draws
what one device draws. With it, the rank's heads are keyed by their global
index. The word embedding, when its rule splits it (vocab + 1 rows divisible
by mp), is a masked lookup of the rank's rows and *g*. ``forward_kv`` /
``decode_step`` run the plain route on the rank's heads with a cache of
those heads: Dense -> attention -> the row-parallel ``out`` (+ *g*, then its
bias).
"""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import FusionConfig
from mvlt_tpu_torch.ops import masks as mask_lib
from mvlt_tpu_torch.ops.attention import multi_head_attention
from mvlt_tpu_torch.ops.blocks import row_parallel
from mvlt_tpu_torch.ops.layers import (Dense, LayerNorm, gelu_exact,
                                       records_grad, rematerialized)
from mvlt_tpu_torch.parallel import comm
from mvlt_tpu_torch.utils.env import env_flag


def init_cache(cfg: FusionConfig, batch: int, max_len: int,
               dtype: torch.dtype, device, heads: int = None) -> dict:
    """The static KV cache (``fusion.py:62-68``): ``{"k", "v"}``, each
    (layers, B, heads, max_len, head_dim) zeros in ``dtype``; ``heads``
    defaults to the config's (a TP rank's cache holds its own)."""
    shape = (cfg.num_hidden_layers, batch, heads or cfg.num_attention_heads,
             max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
        self.tp = None                  # a TP rank's group (parallel.shard)

    def _heads(self) -> int:
        """The heads this rank computes."""
        return self.num_heads // (1 if self.tp is None else self.tp.size)

    def _row_parallel(self, dense, x, ops) -> torch.Tensor:
        """``dense`` on x; under TP the product's rows split over the model
        group (:func:`~mvlt_tpu_torch.ops.blocks.row_parallel`)."""
        if self.tp is None:
            return dense(x, ops)
        shape = x.shape
        y = row_parallel(ops, x.reshape(-1, shape[-1]).contiguous(),
                         dense.weight.to(x.dtype), dense.bias, self.tp)
        return y.to(x.dtype).view(*shape[:-1], y.shape[-1])

    def forward(self, hidden: torch.Tensor, kbias, ops, qbias=None,
                masks=None) -> torch.Tensor:
        """kbias (B, S) f32 or None, qbias (B, S, S) f32 or None; ``masks``
        (a :class:`DropoutMasks`) turns training dropout on."""
        dt = hidden.dtype
        B, S, H = hidden.shape
        nH = self._heads()
        tp = {} if self.tp is None else {"tp": self.tp}

        def w(dense):
            return dense.weight.to(dt), dense.bias.to(dt)

        def mask(rate, shape):
            if masks is None or rate <= 0.0:
                return None
            return masks.scaled(1.0 - rate, shape, dt, hidden.device)

        # in-kernel attention dropout: JAX's gate, read at call time
        adrop = (masks is not None and self.attn_dropout > 0.0
                 and dt == torch.bfloat16 and env_flag("MVLT_KERNEL_DROPOUT"))
        seed = masks.seed(hidden.device) if adrop else None
        amask = None if adrop else mask(self.attn_dropout,
                                        (B, self.num_heads, S, S))
        if amask is not None and self.tp is not None:
            h0 = self.tp.rank * nH              # this rank's heads of the draw
            amask = amask[:, h0:h0 + nH].contiguous()
        hmask = mask(self.hidden_dropout, (B, S, H))
        ln1 = (self.out_layernorm.weight, self.out_layernorm.bias)
        if adrop:
            h = ops.fused_attn_ln_adrop(hidden, *w(self.qkv), *w(self.out),
                                        kbias, qbias, hmask, *ln1, seed,
                                        self.scale, nH, self.attn_dropout,
                                        self.eps, **tp)
        elif qbias is None and amask is None and hmask is None:
            h = ops.fused_attn_ln(hidden, *w(self.qkv), *w(self.out), kbias,
                                  *ln1, self.scale, nH, self.eps, **tp)
        else:
            h = ops.fused_attn_ln_masked(hidden, *w(self.qkv), *w(self.out),
                                         kbias, qbias, amask, hmask, *ln1,
                                         self.scale, nH, self.eps, **tp)
        ln2 = (self.output_layernorm.weight, self.output_layernorm.bias)
        hmask = mask(self.hidden_dropout, (B, S, H))
        if hmask is None:
            return ops.fused_mlp_ln(h, *w(self.intermediate), *w(self.output),
                                    *ln2, self.eps, **tp)
        return ops.fused_mlp_ln_masked(h, *w(self.intermediate),
                                       *w(self.output), hmask, *ln2, self.eps,
                                       **tp)

    def _attention_plain(self, hidden: torch.Tensor, bias, ops, cache=None,
                         write_pos: int = 0):
        """JAX's plain attention half (``fusion.py:181-208``), deterministic:
        the fused qkv product split in query, key, value order, attention
        over the sequence or, with ``cache`` = (k, v) of one layer (B, nH,
        C, Dh), over the cache after the new rows are written at
        ``write_pos``; the out product, + hidden, LayerNorm. Returns (out,
        k, v), k / v (B, nH, S or C, Dh)."""
        B, S, H = hidden.shape
        nH = self._heads()
        qkv = self.qkv(hidden, ops).view(B, S, 3, nH, H // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        if cache is not None:
            ck, cv = cache
            ck[:, :, write_pos:write_pos + S] = k
            cv[:, :, write_pos:write_pos + S] = v
            k, v = ck, cv
        ctx = multi_head_attention(q, k, v, bias, scale=self.scale)
        ctx = ctx.transpose(1, 2).reshape(B, S, -1)
        out = self._row_parallel(self.out, ctx, ops)
        return self.out_layernorm(out + hidden, ops), k, v

    def forward_kv(self, hidden: torch.Tensor, bias, ops):
        """The prefill layer: plain attention half, ``fused_mlp_ln``.
        Returns (out, (k, v))."""
        h, k, v = self._attention_plain(hidden, bias, ops)
        dt = h.dtype
        out = ops.fused_mlp_ln(
            h, self.intermediate.weight.to(dt), self.intermediate.bias.to(dt),
            self.output.weight.to(dt), self.output.bias.to(dt),
            self.output_layernorm.weight, self.output_layernorm.bias,
            self.eps, **({} if self.tp is None else {"tp": self.tp}))
        return out, (k, v)

    def decode(self, hidden: torch.Tensor, bias, ops, cache,
               write_pos: int) -> torch.Tensor:
        """One cached decode step of the layer, both halves plain (JAX's
        ``cache_kv`` path): the MLP half is fc1 -> exact GELU -> fc2, +
        residual, LayerNorm (``fusion.py:264-269``)."""
        h, _, _ = self._attention_plain(hidden, bias, ops, cache, write_pos)
        m = gelu_exact(self.intermediate(h, ops))
        return self.output_layernorm(self._row_parallel(self.output, m, ops)
                                     + h, ops)


class FusionEncoder(nn.Module):
    """Embeddings + key-padding bias + N post-LN layers + optional pooler
    (dense + tanh on [CLS], fusion.py:272-284). Returns (hidden, pooled)."""

    def __init__(self, cfg: FusionConfig, *, add_pooling_layer: bool,
                 cls_token_id: int, sep_token_id: int, dtype: torch.dtype,
                 device, compute_dtype=None, remat: bool = False):
        super().__init__()
        H = cfg.hidden_size
        self.remat = remat
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
        self.vocab_tp = None    # the model group when the table is split

    def _words(self, ids: torch.Tensor) -> torch.Tensor:
        """Word embeddings of ``ids`` (any shape), in the table's dtype: a
        lookup, or with the table's rows split over the model group a
        masked lookup of this rank's rows and *g*."""
        table = self.word_embeddings
        if self.vocab_tp is None:
            return table[ids]
        n = table.shape[0]
        local = ids - self.vocab_tp.rank * n
        mine = (local >= 0) & (local < n)
        rows = table[torch.where(mine, local, torch.zeros_like(local))]
        rows = rows * mine[..., None].to(rows.dtype)
        return comm.reduce_from_group(rows, self.vocab_tp.group)

    def _embed(self, text_idx, image_feature):
        """(embeddings (B, S, H) in the compute dtype, obj_end) of
        ``[CLS] <image> [SEP] (<text>)``; ``text_idx`` may be None (the
        'normal' prefill, ``generation.py:70-73``)."""
        B, num_obj = image_feature.shape[:2]
        obj_end = num_obj + 1                            # index of [SEP]
        dt = self.compute_dtype
        if self.vocab_tp is None:
            word = self.word_embeddings
            cls, sep = word[self.cls_token_id], word[self.sep_token_id]
        else:
            cls, sep = self._words(torch.tensor(
                [self.cls_token_id, self.sep_token_id],
                device=image_feature.device))
        parts = [cls.to(dt).expand(B, 1, -1), image_feature.to(dt),
                 sep.to(dt).expand(B, 1, -1)]
        if text_idx is not None:
            parts.append(self._words(text_idx.long()).to(dt))
        vl = torch.cat(parts, dim=1)
        pos = torch.arange(vl.shape[1], device=vl.device)
        token_type = (pos <= obj_end).long()
        return (vl + self.token_type_embeddings[token_type].to(dt)[None]
                + self.position_embeddings[pos].to(dt)[None]), obj_end

    def _pool(self, hidden, ops):
        first = self.pooler(hidden[:, 0], ops)
        return torch.tanh(first.float()).to(first.dtype)

    def forward(self, text_idx, text_mask, image_feature, image_mask, ops,
                seq2seq: bool = False, masks=None, pool: bool = True):
        """Returns (hidden (B, S, H), pooled (B, H) or None). ``seq2seq``
        selects the UniLM mask; ``masks`` (a :class:`DropoutMasks`) turns
        training dropout on; ``pool=False`` skips the pooler (a head that
        does not read it). ``text_idx`` / ``text_mask`` may be None."""
        hidden, obj_end = self._embed(text_idx, image_feature)
        B, total = hidden.shape[:2]
        if seq2seq:
            kbias, qbias = None, mask_lib.mask_to_bias(
                mask_lib.seq2seq_fusion_mask(B, obj_end, total,
                                             hidden.device)).contiguous()
        else:
            kbias, qbias = mask_lib.mask_to_bias(
                mask_lib.bidirectional_key_mask(image_mask, text_mask)), None
        for layer in self.layers:
            if self.remat and records_grad(hidden, layer):
                hidden = rematerialized(layer, hidden, kbias, ops, qbias,
                                        masks=masks)
            else:
                hidden = layer(hidden, kbias, ops, qbias, masks)
        pooled = None
        if self.pooler is not None and pool:
            pooled = self._pool(hidden, ops)
        return hidden, pooled

    def forward_kv(self, text_idx, image_feature, ops):
        """The deterministic seq2seq forward that also returns every layer's
        (k, v), each (B, nH, S, Dh) (JAX's ``return_kv=True``; the decode
        prefill). Returns (hidden (B, S, H), [(k, v)] * layers)."""
        hidden, obj_end = self._embed(text_idx, image_feature)
        total = hidden.shape[1]
        bias = mask_lib.mask_to_bias(mask_lib.seq2seq_fusion_mask(
            1, obj_end, total, hidden.device))[:, None]     # (1, 1, S, S)
        kvs = []
        for layer in self.layers:
            hidden, kv = layer.forward_kv(hidden, bias, ops)
            kvs.append(kv)
        return hidden, kvs

    def decode_step(self, tokens: torch.Tensor, cache: dict, write_pos: int,
                    ops) -> torch.Tensor:
        """Run T (1 or 2) tokens (B, T) at positions ``write_pos + [0..T)``,
        token type 0, against the static cache (``fusion.py:367-400``).
        Each layer's new (k, v) is written into ``cache["k"][i]`` /
        ``cache["v"][i]`` in place. Returns hidden (B, T, H)."""
        B, T = tokens.shape
        dt = self.compute_dtype
        pos = write_pos + torch.arange(T, device=tokens.device)
        hidden = (self._words(tokens.long()).to(dt)
                  + self.token_type_embeddings[0].to(dt)
                  + self.position_embeddings[pos].to(dt)[None])
        ck, cv = cache["k"], cache["v"]
        bias = mask_lib.mask_to_bias(mask_lib.decode_step_mask(
            1, T, ck.shape[3], write_pos, tokens.device))[:, None]
        for i, layer in enumerate(self.layers):
            hidden = layer.decode(hidden, bias, ops, (ck[i], cv[i]), write_pos)
        return hidden
