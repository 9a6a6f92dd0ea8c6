"""Task heads of the port (counterpart of ``mvlt_tpu/models/heads.py``).
This slice ports ``VQAModel`` (heads.py:65-88); the pretraining, retrieval
and caption heads come with their slices."""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.adapter import VisualAdapter
from mvlt_tpu_torch.models.fusion import FusionEncoder
from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
from mvlt_tpu_torch.ops.layers import Dense


class VQAModel(nn.Module):
    """``MVLBertForVQA``: Swin adapter -> fusion encoder -> pooled [CLS] ->
    linear; deterministic, so the head's dropout is the identity."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device="cpu"):
        super().__init__()
        cfg = config
        self.config = cfg
        self.conv = VisualAdapter(cfg, dtype=dtype, device=device)
        self.fusion = FusionEncoder(cfg.fusion, add_pooling_layer=True,
                                    cls_token_id=cfg.cls_token_id,
                                    sep_token_id=cfg.sep_token_id,
                                    dtype=dtype, device=device)
        self.final_mlp = Dense(cfg.fusion.hidden_size, cfg.result_num,
                               dtype=dtype, device=device)

    @torch.no_grad()
    def forward(self, image: torch.Tensor, question: torch.Tensor,
                plain: bool = False):
        """image: (B, C, H, W) float; question: (B, L) ids, 0 = padding.
        Returns (prob, logits). ``plain=True`` runs the same model on the
        kernels' plain PyTorch versions, for comparison on the card."""
        ops = PLAIN_OPS if plain else KERNEL_OPS
        feat = self.conv(image, ops)
        text_mask = question > 0
        image_mask = torch.ones(feat.shape[:2], dtype=torch.bool,
                                device=feat.device)
        _, pooled = self.fusion(question, text_mask, feat, image_mask, ops)
        logits = self.final_mlp(pooled, ops)
        return torch.softmax(logits.float(), dim=-1).to(logits.dtype), logits
