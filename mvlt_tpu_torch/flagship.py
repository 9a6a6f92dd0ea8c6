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

from mvlt_tpu_torch.config import MVLTConfig, resnet101, swin_small
from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
from mvlt_tpu_torch.models import generation
from mvlt_tpu_torch.models.heads import (CaptionModel, PretrainModel,
                                         RetrievalModel, VQAModel)
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
                      seed: int = 0) -> Tuple[Callable, Tuple]:
    """(forward, (image, question)) for the flagship VQA forward.
    ``forward(image, question, plain=False)`` returns the (B, 224) logits;
    ``forward.model`` is the seeded :class:`VQAModel`. ``device='cuda'``
    without a CUDA device raises: the flagship never falls back to the CPU."""
    device = _need_cuda(device, "build_vqa_forward")
    model = VQAModel(flagship_vqa_config(), dtype=dtype, device=device)
    init_seeded_(model, seed)
    image, question = example_inputs(batch, seq_len, seed)

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
                         image_size: int = 224) -> Tuple[Callable, dict]:
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
    image, question = example_inputs(batch, seq_len, seed, image_size,
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
                              image_size: int = 224) -> Tuple[Callable, dict]:
    """(step, batch) for the MLM+ITM pretrain train step (ResNet-101; with
    ``config=flagship_swin_pretrain_config()`` the Swin-S step of record, as
    :func:`build_swin_pretrain_train_step` builds it).
    ``step(batch, seq2seq)`` runs forward + backward + AdamW in that mask
    mode and returns ``{"mlm_loss", "itm_loss", "loss"}``; ``step.model`` /
    ``step.optimizer`` are the seeded :class:`PretrainModel` (f32 masters,
    ``compute_dtype`` math) and its AdamW, ``step.masks`` its dropout-mask
    source (a generator on ``device`` seeded with ``seed``). ``plain=True``
    runs the kernels' plain versions. ``config`` (default
    :func:`flagship_pretrain_config`) and ``image_size`` shrink it for
    tests. ``device='cuda'`` without a CUDA device raises: the train step
    never falls back to the CPU."""
    device = _need_cuda(device, "build_pretrain_train_step")
    cfg = config or flagship_pretrain_config()
    model = PretrainModel(cfg, dtype=torch.float32, device=device,
                          compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_pretrain_batch(batch, text_len, seed, image_size,
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
                                   image_size: int = 224
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


def example_caption_batch(batch: int, text_len: int, seed: int = 0,
                          device="cpu", *, image_size: int = 224,
                          vocab: int = 30000,
                          learning_strategy: str = "unilm",
                          mask_token_id: int = 103,
                          eos_token_id: int = 104) -> dict:
    """A caption batch from ``numpy.random.default_rng(seed)`` on
    ``device``: ``image`` (B, 3, H, W) f32; ``caption`` (B, L) reports of
    5..L tokens in [1, vocab) ending in eos, 0 = padding; ``mlm_labels``
    (B, L) as the caption data pipeline builds them
    (``mvlt_tpu/data/datasets.py:438-452``): for 'unilm' the caption masked
    as in pretraining, the original token at the at most 10 masked
    positions and -100 elsewhere; for 'normal' every real token (each
    predicted from the position before it), -100 at the padding. Ids are
    int64."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(batch, 3, image_size, image_size))
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
                           image_size: int = 224
                           ) -> Tuple[Callable, torch.Tensor]:
    """(generate, image) for report generation in serving: the seeded
    :class:`CaptionModel` of :func:`flagship_caption_config` (or
    ``config``) in ``dtype`` and an image batch (B, 3, H, W).
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
    model = CaptionModel(cfg, dtype=dtype, device=device)
    init_seeded_(model, seed)
    model.eval()
    spec = generation.GenerationSpec.from_config(
        cfg, num_beams=num_beams, strategy=strategy, sample=sample)
    image = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, 3, image_size, image_size)).astype(np.float32))

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
                             image_size: int = 224) -> Tuple[Callable, dict]:
    """(step, batch) for the caption train step: ``step(batch)`` runs
    forward + backward + AdamW in ``learning_strategy`` and returns
    ``{"loss"}``; ``step.model`` / ``step.optimizer`` are the seeded
    :class:`CaptionModel` (f32 masters, ``compute_dtype`` math) and its
    AdamW, ``step.masks`` its DropPath / dropout source (a generator on
    ``device`` seeded with ``seed``). The batch is
    :func:`example_caption_batch`. ``config`` (default
    :func:`flagship_caption_config`) and ``image_size`` shrink it for tests.
    ``device='cuda'`` without a CUDA device raises."""
    device = _need_cuda(device, "build_caption_train_step")
    cfg = config or flagship_caption_config()
    model = CaptionModel(cfg, dtype=torch.float32, device=device,
                         compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_caption_batch(
        batch, text_len, seed, device, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        learning_strategy=learning_strategy,
        mask_token_id=cfg.mask_token_id, eos_token_id=cfg.eos_token_id)
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
                            eos_token_id: int = 104) -> dict:
    """A retrieval train batch from ``numpy.random.default_rng(seed)`` on
    ``device``, already ``cat(pos, neg)`` (2 * pairs rows): ``pairs``
    positive (image, caption) samples labelled 1, then one negative each
    labelled 0, which swaps either its image or its caption for another
    sample's, on a coin, as ``RetrievalDataset(swap="either")`` builds them
    (``mvlt_tpu/data/datasets.py:538-560``). ``image`` (2P, 3, H, W) f32,
    ``caption`` (2P, L) and ``label`` (2P,) int64."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(pairs, 3, image_size, image_size))
    caption = _example_captions(rng, pairs, text_len, vocab, eos_token_id)
    other = (np.arange(pairs) + rng.integers(1, max(pairs, 2),
                                             size=pairs)) % pairs
    swap_image = rng.random(pairs) < 0.5
    neg_image = np.where(swap_image[:, None, None, None], image[other], image)
    neg_caption = np.where(swap_image[:, None], caption, caption[other])
    as_long = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return {"image": torch.from_numpy(np.concatenate(
                [image, neg_image]).astype(np.float32)).to(device),
            "caption": as_long(np.concatenate([caption, neg_caption])
                               ).to(device),
            "label": as_long(np.repeat([1, 0], pairs)).to(device)}


def example_retrieval_grid(n: int, text_len: int, seed: int = 0, *,
                           image_size: int = 224, vocab: int = 30000,
                           eos_token_id: int = 104):
    """A retrieval test set from ``numpy.random.default_rng(seed)``:
    (images (n, 3, H, W) f32, caption ids (n, L) int64, ``cap_ids`` (n,)).
    One sample in eight repeats another's report, and shares its
    ``cap_id`` (a duplicate report, which the grid's labels count as a
    match)."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(n, 3, image_size, image_size))
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
                         image_size: int = 224) -> Tuple[Callable, tuple]:
    """(grid, (images, captions, cap_ids)) for retrieval serving: the
    seeded :class:`RetrievalModel` of :func:`flagship_retrieval_config` (or
    ``config``) in ``dtype`` and a test set of ``n`` samples
    (:func:`example_retrieval_grid`; images and captions on ``device``).
    ``grid(images, captions, cap_ids, plain=False)`` is
    :func:`mvlt_tpu_torch.tasks.retrieval.score_images` in chunks of
    ``batch_size``: ``{"similarities", "labels"}`` (n, n) numpy;
    ``grid.model`` is the model. ``device='cuda'`` without a CUDA device
    raises."""
    device = _need_cuda(device, "build_retrieval_grid")
    cfg = config or flagship_retrieval_config()
    model = RetrievalModel(cfg, dtype=dtype, device=device)
    init_seeded_(model, seed)
    model.eval()
    images, captions, cap_ids = example_retrieval_grid(
        n, text_len, seed, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        eos_token_id=cfg.eos_token_id)

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
                               image_size: int = 224
                               ) -> Tuple[Callable, dict]:
    """(step, batch) for the retrieval train step: ``step(batch)`` runs
    forward + backward + AdamW on the ``cat(pos, neg)`` batch of 2 * pairs
    rows (:func:`example_retrieval_batch`) and returns ``{"loss",
    "accuracy"}``; ``step.model`` / ``step.optimizer`` are the seeded
    :class:`RetrievalModel` (f32 masters, ``compute_dtype`` math) and its
    AdamW, ``step.masks`` its DropPath / attention-dropout source (a
    generator on ``device`` seeded with ``seed``). ``config`` (default
    :func:`flagship_retrieval_config`) and ``image_size`` shrink it for
    tests. ``device='cuda'`` without a CUDA device raises."""
    device = _need_cuda(device, "build_retrieval_train_step")
    cfg = config or flagship_retrieval_config()
    model = RetrievalModel(cfg, dtype=torch.float32, device=device,
                           compute_dtype=compute_dtype)
    init_seeded_(model, seed)
    data = example_retrieval_batch(
        pairs, text_len, seed, device, image_size=image_size,
        vocab=min(30000, cfg.fusion.vocab_size),
        eos_token_id=cfg.eos_token_id)
    step = make_retrieval_step(model, make_optimizer(model, cfg), plain=plain)
    step.masks = DropoutMasks(torch.Generator(device=device).manual_seed(seed))
    return step, data


def entry():
    """Flagship forward at batch 8 on the card (counterpart of
    ``__graft_entry__.entry``)."""
    return build_vqa_forward(batch=8)
