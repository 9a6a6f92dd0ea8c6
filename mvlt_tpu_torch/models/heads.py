"""Task heads of the port (counterpart of ``mvlt_tpu/models/heads.py``).
This slice ports ``VQAModel`` (heads.py:65-94), its forward and its loss;
the pretraining, retrieval and caption heads come with their slices."""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.adapter import VisualAdapter
from mvlt_tpu_torch.models.fusion import FusionEncoder
from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
from mvlt_tpu_torch.ops.layers import Dense, cross_entropy_ignore_index


class VQAModel(nn.Module):
    """``MVLBertForVQA``: visual adapter -> fusion encoder -> pooled [CLS] ->
    linear. The head's dropout is the identity (the forward is
    deterministic; the loss requires zero fusion dropouts).

    ``dtype`` is the parameters' dtype; ``compute_dtype`` (default: the
    same) the activations'. Serving builds the model in bf16; training
    builds f32 masters with bf16 compute."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device="cpu", compute_dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.conv = VisualAdapter(cfg, dtype=dtype, device=device,
                                  compute_dtype=compute_dtype)
        self.fusion = FusionEncoder(cfg.fusion, add_pooling_layer=True,
                                    cls_token_id=cfg.cls_token_id,
                                    sep_token_id=cfg.sep_token_id,
                                    dtype=dtype, device=device,
                                    compute_dtype=compute_dtype)
        self.final_mlp = Dense(cfg.fusion.hidden_size, cfg.result_num,
                               dtype=dtype, device=device)

    def _logits(self, image, question, ops, train: bool):
        feat = self.conv(image, ops, train=train)
        text_mask = question > 0
        image_mask = torch.ones(feat.shape[:2], dtype=torch.bool,
                                device=feat.device)
        _, pooled = self.fusion(question, text_mask, feat, image_mask, ops)
        return self.final_mlp(pooled, ops)

    @torch.no_grad()
    def forward(self, image: torch.Tensor, question: torch.Tensor,
                plain: bool = False):
        """image: (B, C, H, W) float; question: (B, L) ids, 0 = padding.
        Returns (prob, logits). ``plain=True`` runs the same model on the
        kernels' plain PyTorch versions, for comparison on the card."""
        logits = self._logits(image, question,
                              PLAIN_OPS if plain else KERNEL_OPS, train=False)
        return torch.softmax(logits.float(), dim=-1).to(logits.dtype), logits

    def loss(self, image: torch.Tensor, question: torch.Tensor,
             label: torch.Tensor, plain: bool = False):
        """Training forward (``heads.py:90-94``): BatchNorms on batch
        statistics (their running averages updated), fusion encoder on the
        autograd counterparts. Returns (mean CE over labels != -100 in f32,
        logits)."""
        f = self.config.fusion
        if f.hidden_dropout_prob or f.attention_probs_dropout_prob:
            raise NotImplementedError(
                "fusion dropout in training (the hmask / amask options) comes "
                "with the pretrain slice (ROADMAP.md queue B, item 2); set the "
                "fusion dropouts to 0.0")
        logits = self._logits(image, question,
                              PLAIN_OPS if plain else KERNEL_OPS, train=True)
        return cross_entropy_ignore_index(logits, label), logits
