"""Task heads of the port (counterpart of ``mvlt_tpu/models/heads.py``):
``VQAModel`` (heads.py:65-94), its forward and its loss, the MLM+ITM
``PretrainModel`` (heads.py:97-156) with its heads, the retrieval
``RetrievalModel`` (heads.py:159-207): its 2-way match logits, P(match),
the image encoder and the fusion-only score over features the caller
already has (what the N x N grid of :mod:`mvlt_tpu_torch.tasks.retrieval`
sweeps), and its loss; and the report generation ``CaptionModel``
(heads.py:210-285): its image encoder, its training logits in both
learning strategies and its loss; its decoding is
:mod:`mvlt_tpu_torch.models.generation`.

The heads' products and LayerNorms sit outside any TPU kernel in JAX, so in
training they are plain PyTorch (``F.linear``, ``F.layer_norm``). Three
products are ``F.linear`` in serving too, by design, because K1 takes no N
% 8 != 0 and JAX computes them in XLA: the MLM decoder to the vocabulary
(N = 30,522), the retrieval head's ``final_linear`` (N = 2) and the VQA
head's ``final_mlp`` (N = the dataset's answer count, whatever it is).
The first two heads' 768 -> 768 transforms stay on ``Dense`` (K1 in
serving).

Over a mesh every loss takes ``group``, the data group (JAX's
``axis_name``): the NLL sum and the valid count are summed over it, so the
mean is the global batch's. Under tensor parallelism the MLM decoder's
vocabulary columns are split over the model group (15,261 a rank at mp = 2
with BERT's vocabulary; replicated where mp does not divide it, as JAX's
rule falls back): the loss is the vocab-parallel cross entropy on this
rank's logits, and the logits that a caller reads are all-gathered."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.models.backbones.adapter import (VisualAdapter,
                                                     image_tokens)
from mvlt_tpu_torch.models.fusion import FusionEncoder
from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
from mvlt_tpu_torch.ops.kernels import ATTENTION_LONG_MAX_N
from mvlt_tpu_torch.ops.layers import (Dense, LayerNorm,
                                       cross_entropy_ignore_index,
                                       gather_label_positions, gelu_exact)
from mvlt_tpu_torch.parallel import comm


def _check_masks(config: MVLTConfig, masks) -> None:
    f = config.fusion
    conv = config.conv.lower()
    swin = conv in ("swin", "swintransformer")
    vit = conv in ("vit", "visiontransformer")
    if masks is None and (f.hidden_dropout_prob or
                          f.attention_probs_dropout_prob or
                          (swin and config.swin.drop_path_rate) or
                          (vit and (config.vit.dropout or
                                    config.vit.attention_dropout))):
        raise ValueError("training with fusion dropout, Swin DropPath or ViT "
                         "dropout needs a mask source (masks=DropoutMasks("
                         "...)); the train steps pass theirs")


def check_fusion_fits(config: MVLTConfig, text_len: int, views: int = 1,
                      device="cuda", image_size: int = 224) -> int:
    """The fusion encoder's sequence length S = 1 + views x image tokens + 1
    + ``text_len``; on a CUDA device, ``NotImplementedError`` when S is
    beyond what K2 and K4 take (N <= ``ATTENTION_LONG_MAX_N`` = 46,340, the
    long form's 32-bit element indices; past N = 288 they run their long
    form: the caption path on ViT-B/16 or the linear patch, S = 348 at
    MIMIC-CXR's 150 text tokens, and two views of either, S = 474 at IU
    X-Ray's 80). The entry points call it before they build anything, so
    that such a path is refused before any launch, and never runs on the
    plain versions on the card; on the CPU (the plain versions) it only
    returns S."""
    S = 2 + views * image_tokens(config, image_size) + text_len
    if torch.device(device).type == "cuda" and S > ATTENTION_LONG_MAX_N:
        raise NotImplementedError(
            f"conv={config.conv!r}, {views} view(s) and {text_len} text "
            f"tokens make the fusion sequence S = {S}, beyond K2 / K4's N <= "
            f"{ATTENTION_LONG_MAX_N}")
    return S


class _Backbone(nn.Module):
    """Visual adapter + fusion encoder with its pooler, shared by the task
    models."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.conv = VisualAdapter(cfg, dtype=dtype, device=device,
                                  compute_dtype=compute_dtype)
        self.fusion = FusionEncoder(cfg.fusion, add_pooling_layer=True,
                                    cls_token_id=cfg.cls_token_id,
                                    sep_token_id=cfg.sep_token_id,
                                    dtype=dtype, device=device,
                                    compute_dtype=compute_dtype,
                                    remat=cfg.remat_fusion)

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor, plain: bool = False):
        """Backbone features (B, N, hidden) of raw pixels (B, C, H, W),
        deterministic."""
        return self.conv(image, PLAIN_OPS if plain else KERNEL_OPS)

    def _encode(self, image, text, ops, train: bool, seq2seq: bool = False,
                masks=None, pool: bool = True):
        # the backbone draws its masks (Swin DropPath) before the fusion
        # encoder, as JAX runs them
        feat = self.conv(image, ops, train=train, masks=masks)
        return self._fuse(feat, text, ops, seq2seq, masks, pool)

    def _fuse(self, feat, text, ops, seq2seq: bool = False, masks=None,
              pool: bool = True):
        image_mask = torch.ones(feat.shape[:2], dtype=torch.bool,
                                device=feat.device)
        hidden, pooled = self.fusion(text, text > 0, feat, image_mask, ops,
                                     seq2seq=seq2seq, masks=masks, pool=pool)
        return feat.shape[1] + 1, hidden, pooled      # obj_end: [SEP]


class VQAModel(_Backbone):
    """``MVLBertForVQA``: visual adapter -> fusion encoder -> pooled [CLS] ->
    dropout -> linear. The forward is deterministic; the loss trains with
    the fusion dropouts and the pooled output's dropout
    (``hidden_dropout_prob``, heads.py:75,86) from a mask source.

    ``dtype`` is the parameters' dtype; ``compute_dtype`` (default: the
    same) the activations'. Serving builds the model in bf16; training
    builds f32 masters with bf16 compute."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device="cpu", compute_dtype=None):
        super().__init__(config, dtype=dtype, device=device,
                         compute_dtype=compute_dtype)
        self.final_mlp = Dense(config.fusion.hidden_size, config.result_num,
                               dtype=dtype, device=device)

    def _logits(self, image, question, ops, train: bool, masks=None):
        _, _, pooled = self._encode(image, question, ops, train, masks=masks)
        rate = self.config.fusion.hidden_dropout_prob
        if masks is not None and rate > 0.0:
            # flax nn.Dropout: where(mask, x / keep, 0)
            keep = 1.0 - rate
            m = masks.draw(keep, pooled.shape, pooled.device)
            pooled = torch.where(m, pooled / keep, torch.zeros_like(pooled))
        # F.linear in serving too: N is the dataset's answer count, which K1
        # may refuse (N % 8 != 0), and JAX computes this head in XLA
        d = self.final_mlp
        return F.linear(pooled, d.weight.to(pooled.dtype),
                        d.bias.to(pooled.dtype))

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
             label: torch.Tensor, plain: bool = False, masks=None,
             group=None):
        """Training forward (``heads.py:90-94``): BatchNorms on batch
        statistics (their running averages updated), fusion encoder on the
        autograd counterparts, dropout masks from ``masks`` (a
        :class:`DropoutMasks`; needed when a dropout rate is above 0).
        Returns (mean CE over labels != -100 in f32, over the global batch
        of the data ``group``, logits)."""
        _check_masks(self.config, masks)
        logits = self._logits(image, question,
                              PLAIN_OPS if plain else KERNEL_OPS, train=True,
                              masks=masks)
        return cross_entropy_ignore_index(logits, label,
                                          group=group), logits


class HeadTransform(nn.Module):
    """HF ``BertPredictionHeadTransform``: dense + exact GELU + LayerNorm
    (statistics in f32, output in the input's dtype)."""

    def __init__(self, hidden: int, eps: float, *, dtype: torch.dtype,
                 device):
        super().__init__()
        self.transform_dense = Dense(hidden, hidden, dtype=dtype,
                                     device=device)
        self.transform_layernorm = LayerNorm(hidden, eps, device=device)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        x = gelu_exact(self.transform_dense(x, ops))
        ln = self.transform_layernorm
        return F.layer_norm(x.float(), (x.shape[-1],), ln.weight, ln.bias,
                            ln.eps).to(x.dtype)


class MLMHead(nn.Module):
    """HF ``BertOnlyMLMHead``: transform + decoder to vocab logits. The
    decoder is ``F.linear`` in serving as in training: K1 refuses the
    vocabulary's N = 30,522 (not a multiple of 8), and JAX runs this
    product in XLA; the transform's product stays on ``Dense``."""

    def __init__(self, hidden: int, vocab: int, eps: float, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.transform = HeadTransform(hidden, eps, dtype=dtype,
                                       device=device)
        self.decoder = Dense(hidden, vocab, dtype=dtype, device=device)

        self.vocab_tp = None    # the model group when the vocab is split

    @property
    def vocab_group(self):
        """The model group over which the decoder's columns are split, or
        None."""
        return None if self.vocab_tp is None else self.vocab_tp.group

    def forward(self, x: torch.Tensor, ops, local: bool = False
                ) -> torch.Tensor:
        """Vocab logits of x; with the vocabulary split, ``local=True``
        gives this rank's columns (for :func:`cross_entropy_ignore_index`'s
        ``vocab_group``) and otherwise they are all-gathered (no
        gradient)."""
        h, d = self.transform(x, ops), self.decoder
        if self.vocab_tp is None:
            return F.linear(h, d.weight.to(h.dtype), d.bias.to(h.dtype))
        if local:
            h = comm.copy_to_group(h, self.vocab_tp.group)     # Megatron f
        y = F.linear(h, d.weight.to(h.dtype), d.bias.to(h.dtype))
        return y if local else comm.all_gather_cat(y, self.vocab_tp.group,
                                                   dim=-1)


class PretrainModel(_Backbone):
    """``MVLBertForPretraining``: visual adapter -> fusion encoder (either
    mask mode) -> the MLM head of that mode on the gathered label positions
    (``mlm_gather_k``), and ``itm_mlp`` on the pooled [CLS]. ``device`` has
    no default: the caller says where the model lives."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device, compute_dtype=None):
        super().__init__(config, dtype=dtype, device=device,
                         compute_dtype=compute_dtype)
        f = config.fusion
        head = dict(dtype=dtype, device=device)
        self.mlm_head_seq2seq = MLMHead(f.hidden_size, f.vocab_size,
                                        f.layer_norm_eps, **head)
        self.mlm_head_bidir = MLMHead(f.hidden_size, f.vocab_size,
                                      f.layer_norm_eps, **head)
        self.itm_mlp = Dense(f.hidden_size, 2, **head)

    def loss(self, image: torch.Tensor, caption_masked: torch.Tensor,
             caption_label: torch.Tensor, itm_label: torch.Tensor = None,
             seq2seq: bool = False, plain: bool = False, masks=None,
             group=None):
        """Training forward (``heads.py:117-156``). image (B, C, H, W);
        caption_masked (B, L) ids, 0 = padding; caption_label (B, L), -100
        where no token is predicted; itm_label (B,) in {0, 1}. ``seq2seq``
        picks the UniLM mask and its MLM head. Returns (loss, {"mlm_loss",
        "itm_loss", "loss"}), the loss in f32: MLM CE [+ ITM CE]."""
        _check_masks(self.config, masks)
        cfg = self.config
        ops = PLAIN_OPS if plain else KERNEL_OPS
        obj_end, hidden, pooled = self._encode(image, caption_masked, ops,
                                               True, seq2seq, masks)
        text = hidden[:, obj_end + 1:obj_end + 1 + caption_masked.shape[1]]
        label = caption_label
        if cfg.mlm_gather_k:
            text, label = gather_label_positions(text, label,
                                                 cfg.mlm_gather_k)
        head = self.mlm_head_seq2seq if seq2seq else self.mlm_head_bidir
        metrics = {}
        loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if cfg.mlm_task:
            metrics["mlm_loss"] = cross_entropy_ignore_index(
                head(text, ops, local=True), label, group=group,
                vocab_group=head.vocab_group)
            loss = loss + metrics["mlm_loss"]
        if cfg.itm_task:
            metrics["itm_loss"] = cross_entropy_ignore_index(
                self.itm_mlp(pooled, ops), itm_label, group=group)
            loss = loss + metrics["itm_loss"]
        metrics["loss"] = loss
        return loss, metrics


class RetrievalModel(_Backbone):
    """``MVLBertForRetrieval`` (heads.py:159-207): visual adapter -> fusion
    encoder (bidirectional) -> pooled [CLS] -> ``final_transform`` (dense,
    exact GELU, LayerNorm) -> ``final_linear`` to 2-way match logits;
    P(match) is softmax[..., 1] (run_retrieval.py:204). ``final_linear``
    (N = 2) is ``F.linear`` in serving and training: K1 refuses N % 8 != 0
    and JAX computes it in XLA. ``encode_image`` / ``score_from_features``
    split the forward at the backbone, so that a grid runs the backbone
    once per image. ``device`` has no default: the caller says where the
    model lives."""

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device, compute_dtype=None):
        super().__init__(config, dtype=dtype, device=device,
                         compute_dtype=compute_dtype)
        f = config.fusion
        self.final_transform = HeadTransform(f.hidden_size, f.layer_norm_eps,
                                             dtype=dtype, device=device)
        self.final_linear = Dense(f.hidden_size, 2, dtype=dtype,
                                  device=device)

    def _head(self, pooled, ops) -> torch.Tensor:
        h, d = self.final_transform(pooled, ops), self.final_linear
        return F.linear(h, d.weight.to(h.dtype), d.bias.to(h.dtype))

    @staticmethod
    def _p_match(logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits.float(), dim=-1)[..., 1]

    @torch.no_grad()
    def forward(self, image: torch.Tensor, caption: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
        """Match logits (B, 2) of image (B, C, H, W) and caption (B, L)
        ids (0 = padding), deterministic. ``plain=True`` runs the same
        model on the kernels' plain versions."""
        ops = PLAIN_OPS if plain else KERNEL_OPS
        return self._head(self._encode(image, caption, ops, False)[2], ops)

    def score(self, image: torch.Tensor, caption: torch.Tensor,
              plain: bool = False) -> torch.Tensor:
        """P(match) (B,) in float32: the full model per pair, the backbone
        included."""
        return self._p_match(self(image, caption, plain))

    @torch.no_grad()
    def logits_from_features(self, feat: torch.Tensor, caption: torch.Tensor,
                             plain: bool = False) -> torch.Tensor:
        """Match logits (B, 2) from backbone features (B, N, hidden) (an
        ``expand``-ed view is taken as it is) and caption ids (B, L): the
        fusion encoder and the head only."""
        ops = PLAIN_OPS if plain else KERNEL_OPS
        return self._head(self._fuse(feat, caption, ops)[2], ops)

    def score_from_features(self, feat: torch.Tensor, caption: torch.Tensor,
                            plain: bool = False) -> torch.Tensor:
        """P(match) (B,) in float32 of :meth:`logits_from_features`."""
        return self._p_match(self.logits_from_features(feat, caption, plain))

    def loss(self, image: torch.Tensor, caption: torch.Tensor,
             label: torch.Tensor, plain: bool = False, masks=None,
             group=None):
        """Training forward (heads.py:202-207): Swin DropPath and the
        fusion's attention dropout from ``masks`` (a :class:`DropoutMasks`;
        needed when a rate is above 0), drawn in JAX's order. label (B,) in
        {0, 1}, -100 ignored. Returns (mean CE in f32, logits (B, 2))."""
        _check_masks(self.config, masks)
        ops = PLAIN_OPS if plain else KERNEL_OPS
        _, _, pooled = self._encode(image, caption, ops, True, masks=masks)
        logits = self._head(pooled, ops)
        return cross_entropy_ignore_index(logits, label,
                                          group=group), logits


class CaptionModel(_Backbone):
    """``MVLBertForImageCaption`` (heads.py:210-285): visual adapter ->
    fusion encoder under the seq2seq mask -> ``mlm_head_seq2seq``. The
    fusion encoder has its pooler, as in JAX, but no head reads it, so it
    is not run (in JAX its parameters get zero gradients).

    ``encode_forward`` computes the training logits in both learning
    strategies: 'unilm' predicts each (masked) token from its own hidden
    state; 'normal' shifts by one, [SEP]'s hidden state predicting the
    first token. ``loss`` projects only the gathered label positions for
    'unilm' (``mlm_gather_k``) and every position for 'normal'. Decoding
    lives in :mod:`mvlt_tpu_torch.models.generation`. ``device`` has no
    default: the caller says where the model lives."""

    STRATEGIES = ("unilm", "normal")

    def __init__(self, config: MVLTConfig, *, dtype: torch.dtype = torch.float32,
                 device, compute_dtype=None):
        super().__init__(config, dtype=dtype, device=device,
                         compute_dtype=compute_dtype)
        f = config.fusion
        self.mlm_head_seq2seq = MLMHead(f.hidden_size, f.vocab_size,
                                        f.layer_norm_eps, dtype=dtype,
                                        device=device)

    @staticmethod
    def _strategy(learning_strategy: str) -> str:
        if learning_strategy not in CaptionModel.STRATEGIES:
            raise NotImplementedError(
                f"learning_strategy {learning_strategy!r}")
        return learning_strategy

    def _text_logits(self, obj_end: int, hidden, L: int, strategy: str, ops,
                     local: bool = False):
        text = hidden[:, obj_end + 1:obj_end + 1 + L]
        if strategy == "normal":
            text = torch.cat([hidden[:, obj_end:obj_end + 1], text[:, :-1]],
                             dim=1)
        return self.mlm_head_seq2seq(text, ops, local=local)

    @torch.no_grad()
    def encode_forward(self, image_feature: torch.Tensor,
                       caption: torch.Tensor, learning_strategy: str = "unilm",
                       plain: bool = False) -> torch.Tensor:
        """Training logits (B, L, vocab) from backbone features and caption
        ids (B, L) (0 = padding), deterministic."""
        ops = PLAIN_OPS if plain else KERNEL_OPS
        strategy = self._strategy(learning_strategy)
        obj_end, hidden, _ = self._fuse(image_feature, caption, ops,
                                        seq2seq=True, pool=False)
        return self._text_logits(obj_end, hidden, caption.shape[1], strategy,
                                 ops)

    @torch.no_grad()
    def forward(self, image: torch.Tensor, caption: torch.Tensor,
                learning_strategy: str = "unilm", plain: bool = False):
        """Training logits (B, L, vocab) from raw pixels, deterministic
        (JAX's ``__call__``)."""
        return self.encode_forward(self.encode_image(image, plain), caption,
                                   learning_strategy, plain)

    def loss(self, image: torch.Tensor, caption: torch.Tensor,
             labels: torch.Tensor, learning_strategy: str = "unilm",
             plain: bool = False, masks=None, group=None):
        """Training forward (heads.py:264-285): Swin DropPath and fusion
        dropout from ``masks`` (a :class:`DropoutMasks`; needed when a rate
        is above 0), drawn in JAX's order. caption (B, L) ids; labels (B, L),
        -100 where no token is predicted. Returns (mean CE over labels !=
        -100 in f32, over the global batch of the data ``group``, logits of
        the projected positions: this rank's vocab columns when the decoder
        is split)."""
        _check_masks(self.config, masks)
        strategy = self._strategy(learning_strategy)
        ops = PLAIN_OPS if plain else KERNEL_OPS
        obj_end, hidden, _ = self._encode(image, caption, ops, True,
                                          seq2seq=True, masks=masks,
                                          pool=False)
        k = self.config.mlm_gather_k
        if strategy == "unilm" and k:
            L = caption.shape[1]
            text, labels = gather_label_positions(
                hidden[:, obj_end + 1:obj_end + 1 + L], labels, k)
            logits = self.mlm_head_seq2seq(text, ops, local=True)
        else:
            logits = self._text_logits(obj_end, hidden, caption.shape[1],
                                       strategy, ops, local=True)
        return cross_entropy_ignore_index(
            logits, labels, group=group,
            vocab_group=self.mlm_head_seq2seq.vocab_group), logits
