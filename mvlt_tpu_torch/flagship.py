"""The port's flagship entry points.

- The VQA forward (serving): Swin-S @224 + BERT-base fusion, VQA head with
  224 answers, bf16, deterministic (counterpart of
  ``mvlt_tpu/flagship.py:23-54``).
- The VQA finetune train step: ResNet-101 @224 + ``resnet_fc`` + BERT-base
  fusion (S = 1 + 49 + 1 + 23 = 74) + pooler + 224 answers, forward +
  backward + AdamW, bf16 compute with f32 master weights, fusion dropouts
  0.0 (the JAX ``make_vqa_step`` path, ``train/steps.py:236``).
- The MLM+ITM pretrain train step: ResNet-101 @224 + ``resnet_fc`` +
  BERT-base fusion over S = 1 + 49 + 1 + 80 = 131 in either mask mode, the
  two MLM heads on the gathered label positions and ``itm_mlp``, forward +
  backward + AdamW, bf16 compute with f32 masters, fusion dropouts 0.1 (the
  JAX ``make_pretrain_step`` path, ``train/steps.py:251``; text length 80
  as ``run_pretrain.py:31``).
- The pretrain train step of record: the same step on Swin-S @224 (no
  ``resnet_fc``: 768 is the fusion width), DropPath 0.3 as a linspace over
  the 24 blocks, fusion dropouts 0.1, b32, text length 80 (the model that
  ``bench.py:197-239`` ``measure_pretrain_step`` trains).
- Report generation at the MIMIC-CXR settings of
  ``run_report_generation.py`` (``unilm``, b32, beam 5: :46-52; caption
  length 150: :70-71): ``for_caption(max_length=150)`` on Swin-S @224 +
  BERT-base with the 30,522-word MLM decoder. Serving is the KV-cached
  greedy / sampling / beam decode in bf16 (the image encoded once per
  sample); training is the caption train step over S = 1 + 49 + 1 + 150 =
  201 under the seq2seq mask, fusion dropouts 0.1 and DropPath 0.3, bf16
  compute with f32 masters and AdamW (``train/steps.py:282-294``).
- Image-text retrieval at the settings of ``run_retrieval.py`` (Swin-S:
  :52; batch 32 pairs, lr 1e-6, caption length 80: :45-54; a test grid
  scored in chunks of 64: :133): ``for_retrieval`` on Swin-S @224 +
  BERT-base (attention dropout 0.1, hidden dropout 0.0) with the
  ``final_transform`` / ``final_linear`` match head. Serving is the N x N
  score grid in bf16, the backbone once per image and the fusion + head
  over every pair (S = 1 + 49 + 1 + 80 = 131); training is the retrieval
  train step on ``cat(pos, neg)`` (64 rows), bf16 compute with f32 masters
  and AdamW (``train/steps.py:266-279``).
- The other backbones (JAX's ``adapter.py:49-69``): VQA serving and the
  MLM+ITM pretrain step on ViT-B/16 @224 (12 layers, 768 wide, 12 heads,
  MLP 3072; 196 image tokens, so S = 1 + 196 + 1 + 23 = 221 for VQA and
  278 at text 80; no ``resnet_fc``), the VQA finetune step on the linear
  patch (conv 3 -> 768, k16 s16, BN, ReLU; S = 221, BN on batch
  statistics), and VQA serving on Swin-B @224 (its stage 4, C = 1024, on
  JAX's plain route). Each is its flagship config passed as ``config=`` to
  the ``build_*`` function above it. Report generation and retrieval run on
  them too, with one view or two (``views=2``: IU X-Ray's frontal and
  lateral views, 392 image tokens): the caption step at S = 1 + 196 + 1 +
  150 = 348, two views at S = 1 + 392 + 1 + 80 = 474, where K2 and K4 run
  their long form (N > 288), as JAX's fused encoder runs at any S.
- The Swin-S step of record with Swin dropout (``swin.drop_rate`` 0.1, and
  a variant with ``attn_drop_rate`` 0.1 too): every block trains on JAX's
  plain route (row 1 and its VJP; the XLA attention with dropout on its
  probabilities in the variant). The configs pass as ``config=`` to
  ``build_swin_pretrain_train_step``; the Swin route (``attn_impl``) is
  chosen as JAX's tests choose it, by building the backbone with it (JAX's
  drivers expose no option).
- What JAX runs on one device beside those: VQA serving and the step of
  record on Swin-S @448 (window 7; stage 4's 14 x 14 map has a shifted
  block on the wide routes; S = 221 / 278), Swin-S with ``ape`` (the
  absolute position table), the ViT-B/16 pretrain step with its dropouts at
  0.1, and the step of record with AdamW's first moment in bf16
  (``adam_mu_dtype``). Their configs pass as ``config=``; the builders size
  the images from the config (:func:`config_image_size`).

Weights are random, drawn from a numpy seed: normal(0, 0.02) for every dense
and conv weight, bias, embedding and relative-position table, and LayerNorm
and BatchNorm gamma 1, beta 0. (The JAX package's ``build_vqa_forward``
zero-initialises, which would make every kernel's output trivial.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from mvlt_tpu_torch.config import (MVLTConfig, ViTConfig, resnet101,
                                   swin_base, swin_small)
from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
from mvlt_tpu_torch.models import generation
from mvlt_tpu_torch.models.heads import (CaptionModel, PretrainModel,
                                         RetrievalModel, VQAModel,
                                         check_fusion_fits)
from mvlt_tpu_torch.ops.layers import DropoutMasks, LayerNorm
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.tasks import retrieval
from mvlt_tpu_torch.train.steps import (make_caption_step, make_pretrain_step,
                                        make_retrieval_step, make_vqa_step)


def flagship_vqa_config() -> MVLTConfig:
    cfg = MVLTConfig.for_vqa(result_num=224)
    return dataclasses.replace(cfg, conv="swin", swin=swin_small())


def flagship_vqa_train_config() -> MVLTConfig:
    """VQA finetune: ResNet-101 backbone, 224 answers, fusion dropouts 0.0."""
    cfg = MVLTConfig.for_vqa(result_num=224)
    return dataclasses.replace(
        cfg, conv="resnet101", resnet=resnet101(),
        fusion=dataclasses.replace(cfg.fusion, hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0))


def flagship_pretrain_config() -> MVLTConfig:
    """MLM+ITM pretraining: ``for_pretrain`` (fusion dropouts 0.1) with the
    ResNet-101 backbone, ITM on, text length 80."""
    return MVLTConfig.for_pretrain(conv="resnet101", resnet=resnet101(),
                                   itm_task=True, max_length=80)


def flagship_swin_pretrain_config() -> MVLTConfig:
    """The pretrain model of record: ``for_vqa(result_num=224)`` with Swin-S
    (DropPath 0.3), ITM on, text length 80, as ``bench.py:212-213`` builds
    it from ``flagship_vqa_config()``."""
    return dataclasses.replace(flagship_vqa_config(), itm_task=True,
                               max_length=80)


def flagship_swin_remat_pretrain_config() -> MVLTConfig:
    """The Swin-S step of record (:func:`flagship_swin_pretrain_config`)
    with ``remat_backbone`` and ``remat_fusion``: every Swin block and
    fusion layer rematerialised in training (JAX's ``nn.remat``)."""
    return dataclasses.replace(flagship_swin_pretrain_config(),
                               remat_backbone=True, remat_fusion=True)


def flagship_swin_dropout_pretrain_config() -> MVLTConfig:
    """The Swin-S step of record (:func:`flagship_swin_pretrain_config`: b32,
    S = 131, DropPath 0.3, fusion dropouts 0.1) with ``swin.drop_rate =
    0.1``. JAX's fused training routes need both Swin dropout rates at 0
    (``swin.py:285-288, 318-320``), so every block trains on its plain
    route, whose attention 'auto' resolves to ``window_block_attention``
    (row 1) and its VJP ``_block_bwd``."""
    cfg = flagship_swin_pretrain_config()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, drop_rate=0.1))


def flagship_swin_attn_dropout_pretrain_config() -> MVLTConfig:
    """:func:`flagship_swin_dropout_pretrain_config` with ``swin.
    attn_drop_rate = 0.1`` as well: the plain route's attention resolves to
    the XLA attention with dropout on its probabilities (``swin.py:170-180,
    216-228``)."""
    cfg = flagship_swin_dropout_pretrain_config()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, attn_drop_rate=0.1))


def flagship_caption_config() -> MVLTConfig:
    """Report generation at the MIMIC-CXR settings: ``for_caption(max_length
    =150)`` (fusion dropouts 0.1, lr 1e-5) with Swin-S (DropPath 0.3)."""
    return MVLTConfig.for_caption(max_length=150, conv="swin",
                                  swin=swin_small())


def flagship_retrieval_config() -> MVLTConfig:
    """Image-text retrieval at ``run_retrieval.py``'s settings:
    ``for_retrieval`` (attention dropout 0.1, hidden dropout 0.0, ITM on,
    caption length 80, lr 1e-6) with Swin-S (DropPath 0.3)."""
    return MVLTConfig.for_retrieval(conv="swin", swin=swin_small())


def flagship_vit_vqa_config() -> MVLTConfig:
    """VQA serving on ViT-B/16 @224: :func:`flagship_vqa_config` with
    ``conv='vit'`` (768 wide: no ``resnet_fc``); S = 221 at question 23."""
    return dataclasses.replace(flagship_vqa_config(), conv="vit",
                               vit=ViTConfig())


def flagship_vit_pretrain_config() -> MVLTConfig:
    """MLM+ITM pretraining on ViT-B/16 @224: :func:`flagship_pretrain_config`
    (fusion dropouts 0.1, ITM on, text 80) with ``conv='vit'``; S = 278."""
    return dataclasses.replace(flagship_pretrain_config(), conv="vit",
                               vit=ViTConfig())


def flagship_vit_caption_config(max_length: int = 150) -> MVLTConfig:
    """Report generation on ViT-B/16 @224: ``for_caption`` (fusion dropouts
    0.1, lr 1e-5) with ``conv='vit'``; S = 1 + 196 + 1 + 150 = 348 at
    MIMIC-CXR's length, 474 for two views at IU X-Ray's 80."""
    return MVLTConfig.for_caption(max_length=max_length, conv="vit",
                                  vit=ViTConfig())


def flagship_linear_caption_config(max_length: int = 80) -> MVLTConfig:
    """Report generation on the linear patch (BN on batch statistics in
    training): ``for_caption`` with ``conv='linear'``; S = 474 for IU
    X-Ray's two views at its 80 text tokens."""
    return MVLTConfig.for_caption(max_length=max_length, conv="linear")


def flagship_vit_retrieval_config() -> MVLTConfig:
    """Image-text retrieval on ViT-B/16 @224: ``for_retrieval`` (attention
    dropout 0.1, captions of 80) with ``conv='vit'``; S = 474 for two
    views."""
    return MVLTConfig.for_retrieval(conv="vit", vit=ViTConfig())


def flagship_linear_vqa_train_config() -> MVLTConfig:
    """VQA finetune on the linear patch: :func:`flagship_vqa_train_config`
    (224 answers, fusion dropouts 0.0) with ``conv='linear'``; S = 221."""
    return dataclasses.replace(flagship_vqa_train_config(), conv="linear")


def flagship_swin_base_vqa_config() -> MVLTConfig:
    """VQA serving on Swin-B @224 (``swin_base``: C = 128 .. 1024, heads 4
    .. 32, ``resnet_fc`` 1024 -> 768): :func:`flagship_vqa_config` with its
    Swin swapped; S = 74 at question 23."""
    return dataclasses.replace(flagship_vqa_config(), swin=swin_base())


def flagship_swin448_vqa_config() -> MVLTConfig:
    """VQA serving on Swin-S @448: :func:`flagship_vqa_config` with
    ``swin.img_size = 448`` and the published window 7 (the
    relative-position tables depend only on the window, so the window-7
    Swin-S weights load unchanged). The maps are 112 / 56 / 28 / 14: stage
    4 (C = 768) is larger than its window, 4 windows an image, and its
    second block is shifted (JAX's ``_fused_half_blocks`` with the roll,
    ``swin.py:483-530``); 196 image tokens, S = 1 + 196 + 1 + 23 = 221."""
    cfg = flagship_vqa_config()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, img_size=448))


def flagship_swin448_pretrain_config() -> MVLTConfig:
    """The Swin-S step of record (:func:`flagship_swin_pretrain_config`:
    DropPath 0.3, fusion dropouts 0.1, ITM, text 80) at 448: stage 4's
    shifted block trains on ``swin_half_block`` with the shift gather; S =
    1 + 196 + 1 + 80 = 278."""
    cfg = flagship_swin_pretrain_config()
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, img_size=448))


def flagship_swin_ape_vqa_config() -> MVLTConfig:
    """:func:`flagship_vqa_config` with ``swin.ape = True``: the absolute
    position table (1, 3136, 96) added after the patch embedding
    (``swin.py:612-617``; the reference Swin YAMLs' ``APE`` option)."""
    cfg = flagship_vqa_config()
    return dataclasses.replace(cfg,
                               swin=dataclasses.replace(cfg.swin, ape=True))


def flagship_swin_ape_pretrain_config() -> MVLTConfig:
    """The Swin-S step of record with ``swin.ape = True``."""
    cfg = flagship_swin_pretrain_config()
    return dataclasses.replace(cfg,
                               swin=dataclasses.replace(cfg.swin, ape=True))


def flagship_vit_dropout_pretrain_config() -> MVLTConfig:
    """MLM+ITM pretraining on ViT-B/16 @224
    (:func:`flagship_vit_pretrain_config`, S = 278) with ``vit.dropout =
    vit.attention_dropout = 0.1`` (the ViT paper pre-trains ViT-B on
    ImageNet-21k with dropout 0.1; JAX's dropouts are
    ``mvlt_tpu/models/backbones/vit.py:36-45, 70``)."""
    cfg = flagship_vit_pretrain_config()
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, dropout=0.1, attention_dropout=0.1))


def flagship_swin_bf16_moments_pretrain_config() -> MVLTConfig:
    """The Swin-S step of record with ``adam_mu_dtype = 'bfloat16'``: AdamW's
    first moment stored in bf16 (optax's ``mu_dtype``, ``mvlt_tpu/train/
    state.py:45-47``), 2 bytes less per trained element."""
    return dataclasses.replace(flagship_swin_pretrain_config(),
                               adam_mu_dtype="bfloat16")


def config_image_size(cfg: MVLTConfig) -> int:
    """The image side a config's backbone is built for: ``swin.img_size``
    or ``vit.image_size``; 224 for the ResNets and the linear patch."""
    conv = cfg.conv.lower()
    if conv in ("swin", "swintransformer"):
        return cfg.swin.img_size
    if conv in ("vit", "visiontransformer"):
        return cfg.vit.image_size
    return 224


def _need_cuda(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device='cuda') needs a CUDA device and "
                           "torch.cuda.is_available() is False")
    return device


@torch.no_grad()
def init_seeded_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` in
    ``named_parameters`` order: LayerNorms and BatchNorms gamma 1 / beta 0,
    everything else normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    ln_params = {id(p) for m in model.modules()
                 if isinstance(m, (LayerNorm, BatchNorm))
                 for p in m.parameters()}
    for name, p in model.named_parameters():
        if id(p) in ln_params:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            p.copy_(torch.from_numpy(
                rng.normal(0.0, 0.02, size=tuple(p.shape)).astype(np.float32)))
    return model


def example_inputs(batch: int, seq_len: int, seed: int = 0,
                   image_size: int = 224, vocab: int = 30000):
    """(image (B, 3, H, W) f32, question (B, L) int64) from a numpy seed.
    Questions have 5..L real tokens and zero padding after them, so the
    fusion encoder's key-padding bias is live."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, 3, image_size, image_size))
    question = rng.integers(1, vocab, size=(batch, seq_len))
    lengths = rng.integers(min(5, seq_len), seq_len + 1, size=batch)
    question[np.arange(seq_len)[None, :] >= lengths[:, None]] = 0
    return (torch.from_numpy(image.astype(np.float32)),
            torch.from_numpy(question.astype(np.int64)))


def build_vqa_forward(batch: int = 8, seq_len: int = 23,
                      dtype: torch.dtype = torch.bfloat16, device="cuda",
                      seed: int = 0, config: MVLTConfig = None,
                      image_size: int = None) -> Tuple[Callable, Tuple]:
    """(forward, (image, question)) for the flagship VQA forward.
    ``forward(image, question, plain=False)`` returns the (B, answers)
    logits; ``forward.model`` is the seeded :class:`VQAModel` of
    ``config`` (default :func:`flagship_vqa_config`); the images are
    ``image_size`` (default: :func:`config_image_size`). ``image_size`` and
    a tiny ``config`` shrink it for tests. ``device='cuda'`` without a CUDA
    device raises: the flagship never falls back to the CPU."""
    device = _need_cuda(device, "build_vqa_forward")
    cfg = config or flagship_vqa_config()
    model = VQAModel(cfg, dtype=dtype, device=device)
    init_seeded_(model, seed)
    image_size = image_size or config_image_size(cfg)
    image, question = example_inputs(batch, seq_len, seed, image_size,
                                     vocab=min(30000, cfg.fusion.vocab_size))

    def forward(image, question, plain: bool = False):
        return model(image, question, plain=plain)[1]

    forward.model = model
    return forward, (image.to(device), question.to(device))


def example_labels(batch: int, num_answers: int = 224, seed: int = 0):
    """(B,) int64 answer ids in [0, num_answers) from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, num_answers, size=batch)
                            .astype(np.int64))


def build_vqa_train_step(batch: int = 32, seq_len: int = 23, device="cuda",
                         seed: int = 0, plain: bool = False,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         config: MVLTConfig = None,
                         image_size: int = None) -> Tuple[Callable, dict]:
    """(step, batch) for the VQA finetune train step. ``step(batch)`` runs
    forward + backward + AdamW and returns ``{"loss", "accuracy"}``;
    ``step.model`` / ``step.optimizer`` are the seeded :class:`VQAModel`
    (f32 masters, ``compute_dtype`` math) and its AdamW. ``plain=True``
    runs the kernels' plain versions. ``config`` (default
    :func:`flagship_vqa_train_config`) and ``image_size`` shrink it for
    tests. ``device='cuda'`` without a CUDA
    device raises: the train step never falls back to the CPU."""
    device = _need_cuda(device, "build_vqa_train_step")
    cfg = config or flagship_vqa_train_config()
    model = VQAModel(cfg, dtype=torch.float32, device=device,
                     compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    image, question = example_inputs(batch, seq_len, seed,
                                     image_size or config_image_size(cfg),
                                     vocab=min(30000, cfg.fusion.vocab_size))
    label = example_labels(batch, cfg.result_num, seed)
    step = make_vqa_step(model, make_optimizer(model, cfg), plain=plain)
    data = {"image": image.to(device), "question": question.to(device),
            "label": label.to(device)}
    return step, data


def example_pretrain_batch(batch: int, text_len: int, seed: int = 0,
                           image_size: int = 224, vocab: int = 30000,
                           mask_token_id: int = 103) -> dict:
    """A pretrain batch from ``numpy.random.default_rng(seed)``: ``image``
    (B, 3, H, W) f32; captions of 5..``text_len`` real tokens in [1, vocab)
    with zero padding after them; each caption masked as the data pipeline
    masks it (``mvlt_tpu/data/transforms.py:125-137``: min(10, max(1,
    round(0.2 n))) of its n real positions, 80% [MASK], 10% a random token,
    10% kept), ``caption_label`` the original token there and -100
    elsewhere; ``itm_label`` in {0, 1}. Ids are int64."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, 3, image_size, image_size))
    tokens, lengths = _example_tokens(rng, batch, text_len, vocab)
    caption, label = _mask_words(rng, tokens, lengths, vocab, mask_token_id)
    itm = rng.integers(0, 2, size=batch)
    as_long = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return {"image": torch.from_numpy(image.astype(np.float32)),
            "caption_masked": as_long(caption),
            "caption_label": as_long(label), "itm_label": as_long(itm)}


def _example_tokens(rng, batch: int, text_len: int, vocab: int):
    """(tokens (B, L) with 5..L real ids in [1, vocab) and zero padding,
    lengths (B,))."""
    tokens = rng.integers(1, vocab, size=(batch, text_len))
    lengths = rng.integers(min(5, text_len), text_len + 1, size=batch)
    tokens[np.arange(text_len)[None, :] >= lengths[:, None]] = 0
    return tokens, lengths


def _mask_words(rng, tokens, lengths, vocab: int, mask_token_id: int):
    """The data pipeline's MLM masking (``mvlt_tpu/data/transforms.py:
    125-137``): min(10, max(1, round(0.2 n))) of a caption's n real
    positions, 80% [MASK], 10% a random token, 10% kept. Returns (masked
    tokens, labels: the original token there, -100 elsewhere)."""
    caption, label = tokens.copy(), np.full_like(tokens, -100)
    for b, n in enumerate(lengths):
        for i in rng.permutation(n)[:min(10, max(1, round(n * 0.2)))]:
            label[b, i] = tokens[b, i]
            p = rng.random()
            if p < 0.8:
                caption[b, i] = mask_token_id
            elif p < 0.9:
                caption[b, i] = rng.integers(1, vocab)
    return caption, label


def build_pretrain_train_step(batch: int = 32, text_len: int = 80,
                              device="cuda", seed: int = 0,
                              plain: bool = False,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              config: MVLTConfig = None,
                              image_size: int = None
                              ) -> Tuple[Callable, dict]:
    """(step, batch) for the MLM+ITM pretrain train step (ResNet-101; with
    ``config=flagship_swin_pretrain_config()`` the Swin-S step of record, as
    :func:`build_swin_pretrain_train_step` builds it).
    ``step(batch, seq2seq)`` runs forward + backward + AdamW in that mask
    mode and returns ``{"mlm_loss", "itm_loss", "loss"}``; ``step.model`` /
    ``step.optimizer`` are the seeded :class:`PretrainModel` (f32 masters,
    ``compute_dtype`` math) and its AdamW, ``step.masks`` its dropout-mask
    source (a generator on ``device`` seeded with ``seed``). ``plain=True``
    runs the kernels' plain versions. ``config`` (default
    :func:`flagship_pretrain_config`) and ``image_size`` (default:
    :func:`config_image_size`) shrink it for tests. ``device='cuda'`` without a CUDA device raises: the train step
    never falls back to the CPU."""
    device = _need_cuda(device, "build_pretrain_train_step")
    cfg = config or flagship_pretrain_config()
    model = PretrainModel(cfg, dtype=torch.float32, device=device,
                          compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_pretrain_batch(batch, text_len, seed,
                                  image_size or config_image_size(cfg),
                                  vocab=min(30000, cfg.fusion.vocab_size),
                                  mask_token_id=cfg.mask_token_id)
    step = make_pretrain_step(model, make_optimizer(model, cfg), plain=plain)
    step.masks = DropoutMasks(torch.Generator(device=device).manual_seed(seed))
    return step, {k: v.to(device) for k, v in data.items()}


def build_swin_pretrain_train_step(batch: int = 32, text_len: int = 80,
                                   device="cuda", seed: int = 0,
                                   plain: bool = False,
                                   compute_dtype: torch.dtype = torch.bfloat16,
                                   config: MVLTConfig = None,
                                   image_size: int = None
                                   ) -> Tuple[Callable, dict]:
    """(step, batch) for the pretrain train step of record: Swin-S @224 +
    BERT-base over S = 131, DropPath 0.3 and fusion dropouts 0.1, the
    step's mask source drawing the backbone's DropPath multipliers before
    the fusion's masks. The contract of :func:`build_pretrain_train_step`;
    ``config`` defaults to :func:`flagship_swin_pretrain_config`.
    ``device='cuda'`` without a CUDA device raises."""
    return build_pretrain_train_step(
        batch, text_len, device, seed, plain, compute_dtype,
        config or flagship_swin_pretrain_config(), image_size)


def _example_images(rng, n: int, views: int, image_size: int):
    """(n, 3, H, W) normal draws, or (n, views, 3, H, W) for two views (the
    adapter's 5-D input: one backbone call a view, tokens concatenated)."""
    if views not in (1, 2):
        raise ValueError(f"views={views}: the adapter takes one or two")
    shape = (3, image_size, image_size)
    return rng.normal(size=(n, *shape) if views == 1 else (n, views, *shape))


def example_caption_batch(batch: int, text_len: int, seed: int = 0,
                          device="cpu", *, image_size: int = 224,
                          vocab: int = 30000,
                          learning_strategy: str = "unilm",
                          mask_token_id: int = 103,
                          eos_token_id: int = 104, views: int = 1) -> dict:
    """A caption batch from ``numpy.random.default_rng(seed)`` on
    ``device``: ``image`` (B, 3, H, W) f32 (with ``views=2``: (B, 2, 3, H,
    W)); ``caption`` (B, L) reports of
    5..L tokens in [1, vocab) ending in eos, 0 = padding; ``mlm_labels``
    (B, L) as the caption data pipeline builds them
    (``mvlt_tpu/data/datasets.py:438-452``): for 'unilm' the caption masked
    as in pretraining, the original token at the at most 10 masked
    positions and -100 elsewhere; for 'normal' every real token (each
    predicted from the position before it), -100 at the padding. Ids are
    int64."""
    rng = np.random.default_rng(seed)
    image = _example_images(rng, batch, views, image_size)
    tokens, lengths = _example_tokens(rng, batch, text_len, vocab)
    tokens[np.arange(batch), lengths - 1] = eos_token_id
    if learning_strategy == "unilm":
        caption, label = _mask_words(rng, tokens, lengths, vocab,
                                     mask_token_id)
    elif learning_strategy == "normal":
        caption, label = tokens, np.where(tokens > 0, tokens, -100)
    else:
        raise NotImplementedError(f"learning_strategy {learning_strategy!r}")
    as_long = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return {"image": torch.from_numpy(image.astype(np.float32)).to(device),
            "caption": as_long(caption).to(device),
            "mlm_labels": as_long(label).to(device)}


def build_caption_generate(batch: int = 32, num_beams: int = 5,
                           max_length: int = 150, strategy: str = "unilm",
                           sample: bool = False,
                           dtype: torch.dtype = torch.bfloat16, device="cuda",
                           seed: int = 0, config: MVLTConfig = None,
                           image_size: int = 224, views: int = 1
                           ) -> Tuple[Callable, torch.Tensor]:
    """(generate, image) for report generation in serving: the seeded
    :class:`CaptionModel` of :func:`flagship_caption_config` (or
    ``config``) in ``dtype`` and an image batch (B, 3, H, W), or (B, 2, 3,
    H, W) with ``views=2``.
    ``generate(image, plain=False, noise=None, **spec)`` encodes each image
    once and decodes with the KV cache; it returns ``(sequences (B, L),
    lengths (B,), scores (B,))`` for beams and ``(ids (B, L), scores (B,
    L))`` for greedy / sampling (``num_beams=1``). Keywords override fields
    of ``generate.spec`` (``unroll``, ``suffix_reorder``, ``num_beams``,
    ``sample``, ...); sampling draws from ``noise``, by default a
    :class:`~mvlt_tpu_torch.models.generation.GumbelNoise` seeded with 0 on
    the image's device, so that two calls agree. ``plain=True`` runs the
    kernels' plain versions. ``device='cuda'`` without a CUDA device
    raises."""
    device = _need_cuda(device, "build_caption_generate")
    cfg = dataclasses.replace(config or flagship_caption_config(),
                              max_length=max_length)
    check_fusion_fits(cfg, max_length, views, device, image_size)
    model = CaptionModel(cfg, dtype=dtype, device=device)
    init_seeded_(model, seed)
    model.eval()
    spec = generation.GenerationSpec.from_config(
        cfg, num_beams=num_beams, strategy=strategy, sample=sample)
    image = torch.from_numpy(_example_images(
        np.random.default_rng(seed), batch, views, image_size
    ).astype(np.float32))

    def generate(image, plain: bool = False, noise=None, **overrides):
        return generation.generate(model, image,
                                   dataclasses.replace(spec, **overrides),
                                   noise, plain)

    generate.model, generate.spec = model, spec
    return generate, image.to(device)


def build_caption_train_step(batch: int = 32, text_len: int = 150,
                             learning_strategy: str = "unilm", device="cuda",
                             seed: int = 0, plain: bool = False,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             config: MVLTConfig = None,
                             image_size: int = 224,
                             views: int = 1) -> Tuple[Callable, dict]:
    """(step, batch) for the caption train step: ``step(batch)`` runs
    forward + backward + AdamW in ``learning_strategy`` and returns
    ``{"loss"}``; ``step.model`` / ``step.optimizer`` are the seeded
    :class:`CaptionModel` (f32 masters, ``compute_dtype`` math) and its
    AdamW, ``step.masks`` its DropPath / dropout source (a generator on
    ``device`` seeded with ``seed``). The batch is
    :func:`example_caption_batch` (``views=2``: two views a study).
    ``config`` (default :func:`flagship_caption_config`) and ``image_size``
    shrink it for tests. ``device='cuda'`` without a CUDA device raises."""
    device = _need_cuda(device, "build_caption_train_step")
    cfg = config or flagship_caption_config()
    check_fusion_fits(cfg, text_len, views, device, image_size)
    model = CaptionModel(cfg, dtype=torch.float32, device=device,
                         compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_caption_batch(
        batch, text_len, seed, device, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        learning_strategy=learning_strategy,
        mask_token_id=cfg.mask_token_id, eos_token_id=cfg.eos_token_id,
        views=views)
    step = make_caption_step(model, make_optimizer(model, cfg),
                             learning_strategy=learning_strategy, plain=plain)
    step.masks = DropoutMasks(torch.Generator(device=device).manual_seed(seed))
    return step, data


def _example_captions(rng, n: int, text_len: int, vocab: int,
                      eos_token_id: int):
    """(n, L) caption ids of 5..L tokens in [1, vocab) ending in eos, zero
    padding after them, as ``RetrievalDataset._cap_ids`` builds them."""
    tokens, lengths = _example_tokens(rng, n, text_len, vocab)
    tokens[np.arange(n), lengths - 1] = eos_token_id
    return tokens


def example_retrieval_batch(pairs: int, text_len: int, seed: int = 0,
                            device="cpu", *, image_size: int = 224,
                            vocab: int = 30000,
                            eos_token_id: int = 104, views: int = 1) -> dict:
    """A retrieval train batch from ``numpy.random.default_rng(seed)`` on
    ``device``, already ``cat(pos, neg)`` (2 * pairs rows): ``pairs``
    positive (image, caption) samples labelled 1, then one negative each
    labelled 0, which swaps either its image or its caption for another
    sample's, on a coin, as ``RetrievalDataset(swap="either")`` builds them
    (``mvlt_tpu/data/datasets.py:538-560``). ``image`` (2P, 3, H, W) f32
    (``views=2``: (2P, 2, 3, H, W), a swap moving both views), ``caption``
    (2P, L) and ``label`` (2P,) int64."""
    rng = np.random.default_rng(seed)
    image = _example_images(rng, pairs, views, image_size)
    caption = _example_captions(rng, pairs, text_len, vocab, eos_token_id)
    other = (np.arange(pairs) + rng.integers(1, max(pairs, 2),
                                             size=pairs)) % pairs
    swap_image = rng.random(pairs) < 0.5
    neg_image = np.where(
        swap_image.reshape((pairs,) + (1,) * (image.ndim - 1)), image[other],
        image)
    neg_caption = np.where(swap_image[:, None], caption, caption[other])
    as_long = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return {"image": torch.from_numpy(np.concatenate(
                [image, neg_image]).astype(np.float32)).to(device),
            "caption": as_long(np.concatenate([caption, neg_caption])
                               ).to(device),
            "label": as_long(np.repeat([1, 0], pairs)).to(device)}


def example_retrieval_grid(n: int, text_len: int, seed: int = 0, *,
                           image_size: int = 224, vocab: int = 30000,
                           eos_token_id: int = 104, views: int = 1):
    """A retrieval test set from ``numpy.random.default_rng(seed)``:
    (images (n, 3, H, W) f32 (``views=2``: (n, 2, 3, H, W)), caption ids
    (n, L) int64, ``cap_ids`` (n,)).
    One sample in eight repeats another's report, and shares its
    ``cap_id`` (a duplicate report, which the grid's labels count as a
    match)."""
    rng = np.random.default_rng(seed)
    image = _example_images(rng, n, views, image_size)
    caption = _example_captions(rng, n, text_len, vocab, eos_token_id)
    cap_ids = np.arange(n)
    dup = rng.permutation(n)[:2 * (n // 8)].reshape(2, -1)
    caption[dup[1]], cap_ids[dup[1]] = caption[dup[0]], cap_ids[dup[0]]
    return (torch.from_numpy(image.astype(np.float32)),
            torch.from_numpy(caption.astype(np.int64)), cap_ids)


def build_retrieval_grid(n: int = 128, text_len: int = 80,
                         batch_size: int = 64,
                         dtype: torch.dtype = torch.bfloat16, device="cuda",
                         seed: int = 0, config: MVLTConfig = None,
                         image_size: int = 224,
                         views: int = 1) -> Tuple[Callable, tuple]:
    """(grid, (images, captions, cap_ids)) for retrieval serving: the
    seeded :class:`RetrievalModel` of :func:`flagship_retrieval_config` (or
    ``config``) in ``dtype`` and a test set of ``n`` samples
    (:func:`example_retrieval_grid`, ``views`` a sample; images and
    captions on ``device``).
    ``grid(images, captions, cap_ids, plain=False)`` is
    :func:`mvlt_tpu_torch.tasks.retrieval.score_images` in chunks of
    ``batch_size``: ``{"similarities", "labels"}`` (n, n) numpy;
    ``grid.model`` is the model. ``device='cuda'`` without a CUDA device
    raises."""
    device = _need_cuda(device, "build_retrieval_grid")
    cfg = config or flagship_retrieval_config()
    check_fusion_fits(cfg, text_len, views, device, image_size)
    model = RetrievalModel(cfg, dtype=dtype, device=device)
    init_seeded_(model, seed)
    model.eval()
    images, captions, cap_ids = example_retrieval_grid(
        n, text_len, seed, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        eos_token_id=cfg.eos_token_id, views=views)

    def grid(images, captions, cap_ids, plain: bool = False):
        return retrieval.score_images(model, images, captions, cap_ids,
                                      batch_size, plain)

    grid.model = model
    return grid, (images.to(device), captions.to(device), cap_ids)


def build_retrieval_train_step(pairs: int = 32, text_len: int = 80,
                               device="cuda", seed: int = 0,
                               plain: bool = False,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               config: MVLTConfig = None,
                               image_size: int = 224, views: int = 1
                               ) -> Tuple[Callable, dict]:
    """(step, batch) for the retrieval train step: ``step(batch)`` runs
    forward + backward + AdamW on the ``cat(pos, neg)`` batch of 2 * pairs
    rows (:func:`example_retrieval_batch`, ``views`` a sample) and returns
    ``{"loss", "accuracy"}``; ``step.model`` / ``step.optimizer`` are the seeded
    :class:`RetrievalModel` (f32 masters, ``compute_dtype`` math) and its
    AdamW, ``step.masks`` its DropPath / attention-dropout source (a
    generator on ``device`` seeded with ``seed``). ``config`` (default
    :func:`flagship_retrieval_config`) and ``image_size`` shrink it for
    tests. ``device='cuda'`` without a CUDA device raises."""
    device = _need_cuda(device, "build_retrieval_train_step")
    cfg = config or flagship_retrieval_config()
    check_fusion_fits(cfg, text_len, views, device, image_size)
    model = RetrievalModel(cfg, dtype=torch.float32, device=device,
                           compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_retrieval_batch(
        pairs, text_len, seed, device, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        eos_token_id=cfg.eos_token_id, views=views)
    step = make_retrieval_step(model, make_optimizer(model, cfg), plain=plain)
    step.masks = DropoutMasks(torch.Generator(device=device).manual_seed(seed))
    return step, data


# ---------------------------------------------------------------------------
# multi-device entry points (``mvlt_tpu/flagship.py:57-261``)
# ---------------------------------------------------------------------------

def tiny_pretrain_config() -> MVLTConfig:
    """Structurally complete but tiny (``mvlt_tpu/flagship.py:57-67``): the
    multi-device dry runs on the CPU."""
    from mvlt_tpu_torch.config import FusionConfig, SwinConfig
    return MVLTConfig(
        conv="swin",
        fusion=FusionConfig(hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=128,
                            vocab_size=512, max_position_embeddings=128),
        swin=SwinConfig(img_size=32, patch_size=4, embed_dim=16,
                        depths=(1, 1), num_heads=(2, 4), window_size=4,
                        drop_path_rate=0.0),
        itm_task=True, lr=1e-3)


def lower_flagship_multichip(n_devices: int, seq_len: int = 80, mps=None
                             ) -> dict:
    """What JAX's AOT lowering proves (``flagship.py:70-136``), for eager
    torch: the flagship-geometry pretrain model (Swin-S @224 + BERT-base,
    MLM+ITM) built on the ``meta`` device and split for each model-axis
    size in ``mps`` (default: 1, and 2 when ``n_devices`` is even), every
    held parameter's local shape checked against its rule (the split
    dimension divided by mp, a fused qkv by heads). The fusion side only:
    the backbone is held replicated. Returns ``{mp: tensors split}``."""
    from mvlt_tpu_torch.parallel import partition
    cfg = dataclasses.replace(flagship_swin_pretrain_config(),
                              max_length=seq_len)
    model = PretrainModel(cfg, dtype=torch.float32, device="meta")
    if mps is None:
        mps = sorted({1, 2 if n_devices % 2 == 0 and n_devices > 1 else 1})
    heads = cfg.fusion.num_attention_heads
    out = {}
    for mp in mps:
        if n_devices % mp:
            raise ValueError(f"model_parallel={mp} does not divide device "
                             f"count {n_devices}")
        split = 0
        for name, p in model.named_parameters():
            shard = partition.shard_for(name, p.shape, mp)
            if shard.dim is None or not partition.held(name):
                continue
            local = partition.local_shard(p, shard, 0, mp)
            want = list(p.shape)
            want[shard.dim] //= mp
            if list(local.shape) != want:
                raise AssertionError(f"{name}: local {tuple(local.shape)}, "
                                     f"rule gives {tuple(want)}")
            if shard.parts == 3 and heads % mp:
                raise AssertionError(f"{name}: {heads} heads over mp={mp}")
            split += 1
        out[mp] = split
    return out


def _dryrun_batch(B: int, L: int, vocab: int = 400, image_size: int = 32,
                  seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(B, 3, image_size, image_size)).astype(
            np.float32),
        "caption_masked": rng.integers(1, vocab, (B, L)),
        "caption_label": np.where(rng.random((B, L)) < 0.2,
                                  rng.integers(1, vocab, (B, L)), -100),
        "itm_label": rng.integers(0, 2, (B,)),
    }


def _mesh_pretrain_step(cfg, mesh, device, batch: dict) -> float:
    """One DP x TP pretrain step of ``cfg`` over ``mesh`` on the global
    ``batch``: world rank 0's seeded init, each rank its shards and its
    rows. Returns the loss (finite) after checking the step count."""
    from mvlt_tpu_torch.train.state import TrainState
    from mvlt_tpu_torch.train.steps import shard_train_state
    model = PretrainModel(cfg, dtype=torch.float32, device=device,
                          compute_dtype=(torch.bfloat16 if device.type ==
                                         "cuda" else torch.float32))
    init_seeded_(model, 0)
    state = shard_train_state(
        TrainState(model, make_optimizer(model, cfg)), mesh)
    step = make_pretrain_step(model, state.optimizer, mesh=mesh)
    step.masks = DropoutMasks(torch.Generator(device=device).manual_seed(
        1 + mesh.data_rank))
    metrics = step(step.shard_batch(batch), False)
    state.step += 1
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} over mesh {mesh.shape}")
    assert state.step == 1
    return loss


def execute_flagship_multichip(n_devices: int, batch: int = 8,
                               seq_len: int = 80, device="cuda") -> float:
    """One real-shape flagship pretrain step (Swin-S @224 + BERT-base,
    MLM+ITM, text ``seq_len``) over an ``n_devices`` DP mesh at global
    batch ``batch`` (``flagship.py:139-197``), in a world of ``n_devices``
    ranks already up (:func:`dryrun_multichip` brings one up). Returns the
    loss, checked finite."""
    from mvlt_tpu_torch.config import MeshConfig
    from mvlt_tpu_torch.parallel import build_mesh
    device = _need_cuda(device, "execute_flagship_multichip")
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if world != n_devices:
        raise ValueError(f"execute_flagship_multichip({n_devices}) in a world "
                         f"of {world}")
    cfg = dataclasses.replace(flagship_swin_pretrain_config(),
                              max_length=seq_len)
    mesh = build_mesh(MeshConfig(), device=device)
    data = example_pretrain_batch(batch, seq_len, 0, config_image_size(cfg),
                                  vocab=30000,
                                  mask_token_id=cfg.mask_token_id)
    return _mesh_pretrain_step(cfg, mesh, device,
                               {k: v.numpy() for k, v in data.items()})


def _dryrun_rank(n_devices: int, geometry: str, device) -> float:
    """One rank's part of :func:`dryrun_multichip`."""
    from mvlt_tpu_torch.config import MeshConfig
    from mvlt_tpu_torch.parallel import build_mesh
    if geometry == "flagship_exec":
        return execute_flagship_multichip(n_devices, device=device)
    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    cfg = tiny_pretrain_config()
    mesh = build_mesh(MeshConfig(model_parallel=mp), device=device)
    dp = n_devices // mp
    loss = _mesh_pretrain_step(cfg, mesh, device,
                               _dryrun_batch(max(2, dp), 8))
    # and the DP-only mesh (JAX's shard_map path)
    _mesh_pretrain_step(cfg, build_mesh(MeshConfig(), device=device),
                        device, _dryrun_batch(max(2, n_devices), 8))
    return loss


def _dryrun_worker(rank: int, n_devices: int, geometry: str, device: str,
                   store: str, out: str) -> None:
    from mvlt_tpu_torch.parallel import initialize_distributed
    torch.set_num_threads(max(1, min(4, torch.get_num_threads()
                                     // n_devices)))
    dev = initialize_distributed(store, n_devices, rank, device=device)
    try:
        loss = _dryrun_rank(n_devices, geometry, dev)
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(loss))
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, geometry: str = "tiny", device="cuda"):
    """One full sharded training step (forward, backward, AdamW) of the
    pretraining model over an ``n_devices`` mesh (``flagship.py:200-261``).
    ``geometry='tiny'``: the tiny config over a (n / 2, 2) DP x TP mesh,
    then the DP-only mesh; ``'flagship'``: :func:`lower_flagship_multichip`
    (no process); ``'flagship_exec'``: :func:`execute_flagship_multichip`.
    When the caller is not already one of ``n_devices`` ranks it spawns
    them (a ``file://`` store in a temporary directory), each on its own
    card, or with ``device='cpu'`` on gloo; asked for ``cuda`` with fewer
    cards than ranks it raises. Returns rank 0's loss (None for
    'flagship')."""
    import os
    import tempfile
    if geometry == "flagship":
        lower_flagship_multichip(n_devices)
        return None
    if geometry not in ("tiny", "flagship_exec"):
        raise ValueError(f"unknown geometry {geometry!r}")
    device = torch.device(device)
    if (torch.distributed.is_initialized()
            and torch.distributed.get_world_size() == n_devices):
        return _dryrun_rank(n_devices, geometry, device)
    if device.type == "cuda":
        _need_cuda(device, "dryrun_multichip")
        if torch.cuda.device_count() < n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) on cuda: "
                             f"{torch.cuda.device_count()} cards")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "loss")
        mp.spawn(_dryrun_worker, args=(n_devices, geometry, device.type,
                                       f"file://{d}/store", out),
                 nprocs=n_devices, join=True)
        with open(out) as f:
            return float(f.read())


def entry():
    """Flagship forward at batch 8 on the card (counterpart of
    ``__graft_entry__.entry``)."""
    return build_vqa_forward(batch=8)
