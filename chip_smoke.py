#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``
(``python3 chip_smoke.py --norm``: phases 1-2's build and K3 / K5 at the
step's shapes only; ``--caption`` / ``--retrieval`` / ``--backbones`` /
``--vqa-driver`` / ``--pretrain-driver`` / ``--caption-driver`` /
``--retrieval-driver`` / ``--swin-routes`` / ``--long-n`` /
``--single-card`` / ``--multi-device``: phases 1-2 and phase 10 / 11 / 12
/ 13 / 14 / 15 / 16 / 17 / 18 / 20 / 21 only; ``--loader-pace``:
phases 1-2 and
phases 13-16 with the drivers' loader-pace loops, which the default run
leaves out; with a driver's flag, that phase alone with its loops). It
imports nothing of JAX and nothing of the JAX package. Phases, each of
which raises on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``mvlt_tpu_torch/csrc`` with
   nvcc (sm_90a, one process per source, all at once) into
   ``build/torch_kernels/``; print K1's SASS instruction counts (``HGMMA``
   and ``UTMALDG``: its ``wgmma`` / TMA mainloop was compiled) and its
   wrapper's host time per call, K2's (``HGMMA``: S = Q K^T and P V on
   the tensor cores) with its wrapper's host time beside SDPA's, K4's
   (``HGMMA`` and no ``HMMA`` or atomic: its five products on ``wgmma``)
   with each template instance's registers and stack bytes, and K3's and
   K5's registers, stack and spill bytes per instance, K5's atomic count
   (0: its sums run in a fixed order) and their wrappers' host time beside
   ``torch.sum``'s and ``F.layer_norm``'s; K3's and K5's plans in C
   against the Python ones the wrappers allocate from, over a sweep (these
   reports print after phase 3's checks: their cuobjdump runs start in the
   background after the build and run beside the checks);
3. kernel checks: hold K1 ``gemm``, K2 ``biased_attention``, K3
   ``layernorm`` and the six forward counterparts of
   ``mvlt_tpu_torch.ops.blocks`` against their plain PyTorch versions on the
   card, in bf16 at the flagship batch-8 shapes; then K1's backward modes,
   K4 ``biased_attention_bwd``, K5 ``layernorm_bwd`` / ``column_sum`` and
   the two backward counterparts at the train step's shapes; then the mask
   options at the pretrain step's shapes (B*S = 32*131 rows, 12 heads): K2
   and K4 with qbias and amask, K4 at N = 128, K1's epilogue multiplier, K5
   with hmask, the two masked forward counterparts and the two backward
   ones with their masks, and the tile plans of K2 / K4 against the
   compiled ones (N = 1 .. 576 and the long form's cap); K2 and K4 at N =
   221 and 278 (a 196-token image with BERT text, b32, 12 heads: key bias,
   qbias + amask, in-kernel / regenerated dropout), two calls of K2 and of
   K4 bitwise equal in every mode, and both refusing what they cannot take
   (N = 46,341, N = 289 in pattern mode, head dim 24, a misaligned view)
   before a launch. Each is timed beside its plain
   version, the library call that computes the same function (never called
   by the port) and its bound on an H100 SXM (the larger of FLOPs / 989
   TFLOP/s and bytes / 3.35 TB/s); K2's to K5's cases also as CUDA graphs;
4. forward: run the flagship VQA forward (Swin-S @224 + BERT-base, bf16,
   batch 8, question length 23 with padding) through the kernels, check the
   launch counts, compare its logits with the same model on the plain
   versions, and time both;
5. train: build the VQA finetune train step (ResNet-101 @224 + BERT-base,
   batch 32, bf16 compute with f32 masters, AdamW) twice from one seed, on
   the kernels and on the plain versions; check the launch counts of one
   step, every parameter's gradient of step 1 and the losses of 3 steps
   against the plain run, then time the steps in turns;
6. pretrain: build the MLM+ITM pretrain train step (ResNet-101 @224 +
   BERT-base over S = 1 + 49 + 1 + 80 = 131, two MLM heads + ITM, batch 32,
   bf16 compute with f32 masters, fusion dropouts 0.1, AdamW) twice from one
   seed, the plain run replaying the kernel run's dropout masks; check the
   gradients from the initial parameters in both mask modes, the launch
   counts of one step and the losses of 3 steps (bidirectional, seq2seq,
   bidirectional), then time the steps in turns;
7. swin: at the Swin-S b32 shapes of each stage, K1's row scale, K4's
   pattern mode (one pattern and one per window; two calls bitwise equal),
   K5's pre-LN form and the scaled column sum, and the Swin training
   counterparts (the whole / half block forward, the three backward pieces,
   each block forward + backward); K3 and K5 at the step's shapes and the
   fusion's (column sums over stage 1's, stage 3's and the fusion's
   cotangents, the scaled one; the pre-LN LN2 / LN1 VJPs at stages 1 and 3;
   the fusion's VJP with and without hmask; LN1 through the shift gather
   and LN2 from the f32 res1), each also as CUDA graphs, two calls of each
   K5 case bitwise equal; K1's products of the step at each stage
   (NT forwards, NN data gradients, TN weight gradients, the split-K ones
   bitwise equal over two calls); then the pretrain step of record
   (Swin-S @224 with DropPath 0.3 + BERT-base, S = 131, b32, dropout 0.1)
   as phase 6 drives the ResNet one, the plain run replaying the kernel
   run's DropPath and dropout masks;
8. switches: the opt-in modes of K2 and K4 at the shapes the step of record
   gives them: in-kernel Philox dropout (``MVLT_KERNEL_DROPOUT``) at B*S =
   32*131, 12 heads, in the key-bias and seq2seq modes (the drawn mask
   bitwise equal to ``adrop_mask_plain``, its keep fraction, two calls
   bitwise equal), and the stored softmax (``MVLT_STOREP``) at Swin-S stage
   3 (128 windows of 49, C 384, 12 heads, one pattern and four), with the
   counterparts that run them; then the Swin-S step of record with both
   switches set, driven as in phase 7 (the plain run replaying the seeds
   and masks), its launch counts, and its step time and peak memory in
   turns with the switches off (off, on, on, off);
9. attn_impl: the counterparts of the last TPU kernels against their plain
   versions: row 8 (``window_attention``, K2 reading q, k, v through strides,
   and its backward on K4's pattern mode) at every Swin-S stage at b32, row
   7 (``swin_attn_half``) at window 12 and C = 768, row 9
   (``fused_seq_attention`` and its backward) at BERT-base b32, row 10
   (``full_forward_windows``) at Swin-S stage 3; then the flagship forward
   and the Swin-S step of record with the backbone on
   ``attn_impl='pallas'`` (row 8 in all 24 blocks), driven as in phases 4
   and 7 (logits / gradients / losses against the plain versions, launch
   counts), each timed in turns with the backbone on 'auto';
10. caption: K2 and K4 at the caption step's fusion shapes (b32, S = 1 +
    49 + 1 + 150 = 201, 12 heads, the seq2seq qbias with a dropout mask),
    rows of their own; then report generation at the MIMIC-CXR settings
    (``build_caption_generate``: Swin-S + BERT-base, bf16, b32, beam 5,
    length 150, unilm): the Swin features and the prefill's logits against
    the plain versions, the first 8 cached decode steps of a greedy run
    against the full seq2seq forward over the committed tokens (rows 15 and
    5 on the card), the launch counts of one call, two calls bitwise equal,
    ``unroll`` and ``suffix_reorder`` equal to the loop and the full
    gather, sampling reproducible under one seed, tokens/s (B x length /
    time, the median of 3 calls after a warm-up) of the kernel route (its
    loop, and unrolled) and the plain route, and peak memory; then the
    caption train step
    (``build_caption_train_step``: b32, text 150, unilm, DropPath 0.3,
    dropout 0.1) driven as phase 7 drives the Swin-S step (gradients and 3
    losses against the plain run on replayed masks, launch counts, ms/step
    in turns, peak memory). With the kernel checks, K2 and K4 also run at
    the two-view caption step's S = 1 + 2 x 49 + 1 + 80 = 180 (rows
    ``biased_attention_n180`` / ``biased_attention_bwd_n180``). ``python3
    chip_smoke.py --caption`` runs phases 1-2 and this phase only;
11. retrieval: K2 at the grid's score-call shape (b64, S = 1 + 49 + 1 + 80
    = 131, 12 heads, key bias), a row of its own; then image-text retrieval
    at ``run_retrieval.py``'s settings (``build_retrieval_grid``: Swin-S +
    BERT-base, bf16, a test grid of 128 samples scored in chunks of 64, the
    backbone once per image): the b64 Swin features and the 2-way logits of
    a 16 x 64 sub-grid against the plain versions, the launch counts of one
    grid, two grids bitwise equal, grid rows against the full model's score
    per pair, pairs/s (n^2 / time, the median of 3 grids after a warm-up)
    beside the bound, and peak memory; then the retrieval train step
    (``build_retrieval_train_step``: 32 pairs, cat(pos, neg) = 64 rows,
    DropPath 0.3, attention dropout 0.1, hidden dropout 0.0) driven as
    phase 10 drives the caption step. ``python3 chip_smoke.py --retrieval``
    runs phases 1-2 and this phase only;
12. other backbones, each with kernels against plain at full width: the
    VQA forward on ViT-B/16 @224 + BERT-base (b8, question 23: K2 at S =
    1 + 196 + 1 + 23 = 221, the ViT on K1 / K3 and SDPA; logits to the
    flagship forward's bar); the MLM+ITM pretrain step on ViT-B/16 (b32,
    text 80: K2 / K4 at S = 278, fusion dropouts 0.1 in both mask modes,
    the masks replayed into the plain run, AdamW; gradients and losses to
    the Swin step's bars); the VQA finetune step on the linear patch (conv
    3 -> 768 k16 s16, BN on batch statistics, ReLU; b32, S = 221; losses,
    gradients and the BN running buffers against plain); and the VQA
    forward on Swin-B @224 (b8: stages 1-3 on rows 2 / 3, stage 4 at C =
    1024 on row 1's plain route). Each checks its launch counts and the
    sequence length of every K2 / K4 launch, and is timed in turns with
    its plain run. ``python3 chip_smoke.py --backbones`` runs phases 1-2
    and this phase only;
13. vqa driver: the VQA task driver, ``python -m mvlt_tpu_torch.run_vqa``
    (``run_vqa.main``), at its defaults (Swin-S @224 + BERT-base,
    ``for_vqa``: dropouts 0.1, DropPath 0.3, lr 4e-5, b64) on a synthetic
    SLAKE written as pickles (64 images, 224 answers, 320 / 100 / 100
    questions), 2 epochs with loader worker processes, in a process of its
    own under a time limit (a fork that hangs fails the run): the launch
    counts of one driver step and of one eval batch, every device batch
    bitwise equal to its host batch, ``results.json``'s keys; the first
    epoch on the plain versions replaying the masks (3 losses, step 1's
    gradients), eval logits against the plain versions; a save and a
    restore into a fresh runner (state and predictions bitwise equal, one
    more step bitwise equal); then, on a train split of SLAKE's length
    (76 steps at b64), the driver's train loop for the CLI default (loader
    processes) and threads (whole-epoch samples/s, the epoch start, the
    steady interval between steps) beside the bare step on a resident
    batch, the loader alone, eval samples/s and peak memory (the train
    split's epochs and the loader alone only with ``--loader-pace``).
    ``python3 chip_smoke.py --vqa-driver`` runs phases 1-2 and this phase
    only;
14. pretrain driver: ``python -m mvlt_tpu_torch.run_pretrain``
    (``run_pretrain.main``) at its defaults (Swin-S @224 + BERT-base,
    ``for_pretrain`` with ITM: dropouts 0.1, DropPath 0.3, text 80, lr 4e-5,
    b32, the per-batch coin flip) on the RGC f32 pickles of a synthetic
    corpus of 96 samples, 2 epochs with loader worker processes, in a
    process of its own under a time limit: the launch counts of one driver
    step in each mode (the bidirectional one equal to the Swin-S step of
    phase 7's), the seeded flips, every device batch bitwise equal to its
    host batch, both exports (the last merged into a fresh VQA runner);
    the first epoch on the plain versions replaying the masks (3 losses,
    step 1's gradients); the driver's checkpoint restored into a fresh
    runner (state bitwise, one more step bitwise); ``device_var_normalize``
    against the host's ``normalize_image_var``; one step on a uint8 batch
    (prefetched as uint8) against its plain step; the ROCO split's PNG
    frames equal to the uint8 cache's; then a bare step on a resident uint8
    batch in each mode, and one epoch of 1,536 samples through
    ``train_pretrain`` for the uint8 cache and the RGC f32 pickles, each
    with the CLI default (processes) and threads, the loader alone and the
    peak memory (the epochs of 1,536 samples and the loader alone only with
    ``--loader-pace``). ``python3 chip_smoke.py --pretrain-driver`` runs
    phases 1-2 and this phase only;
15. caption driver: ``python -m mvlt_tpu_torch.run_report_generation
    --dataset iu_xray`` (``run_report_generation.main``) at its IU X-Ray
    settings (Swin-S @224 + BERT-base, ``for_caption(max_length=80)``,
    unilm, b32, beam 5; two views a study, S = 180) with a partial
    ``--pretrained`` export (uint8 frames normalized on the card) on a
    synthetic IU X-Ray tree (``build/iu_xray``: 96 / 16 / 32 studies of two
    256-px views), 2 epochs of 3 steps with loader processes and the test
    after the second, in a process of its own: the launch counts of one
    driver step and one eval batch (the Swin counterparts twice as often
    as in phase 10's single-view step and generate call, the fusion
    counterparts as often), each device batch against its host batch, the
    first epoch on the plain versions replaying the masks, the Swin
    features, the prefill's and the first decode step's logits against
    the plain route, two evals decoding the same ids, the checkpoint
    restored into a fresh runner; the driver again with ``--do_test
    --quant int8w`` on that checkpoint (weight-only int8 serving): its
    launch counts (two eval batches) and its scores equal to
    ``eval_caption(quant="int8w")`` on the trained runner; then eval
    reports/s, a generate call, and one epoch of 1,536 studies (48 steps) through ``train_caption``
    beside the bare step for uint8 with the export (loader processes) and
    f32 ImageNet crops without (processes, threads), and the peak memory
    (the epochs of 1,536 studies only with ``--loader-pace``; without it
    the bare steps run on the data tree's batches). ``python3 chip_smoke.py
    --caption-driver`` runs phases 1-2 and this phase only;
16. retrieval driver: ``python -m mvlt_tpu_torch.run_retrieval
    --iu_xray_root`` (``run_retrieval.main``; swap 'image', 32 pairs = 64
    rows of two views, S = 180, uint8 frames) on the same tree, one epoch
    of 3 steps and ``eval_retrieval`` on 32 studies with ``eval.json``, in
    a process of its own: the launch counts of one step (against phase
    11's step as phase 14 does) and of one grid, the batches, the epoch on
    the plain versions replaying the masks, the grid's P(match) against
    the plain route, two grids bitwise equal; then pairs/s and one epoch
    of 1,536 studies (48 steps) through ``train_retrieval`` beside the bare
    step for uint8 (processes, threads); f32 host-normalized batches get
    the features check and the bare step (the epochs only with
    ``--loader-pace``). ``python3 chip_smoke.py --retrieval-driver`` runs
    phases 1-2 and this phase only;
17. swin routes: JAX's plain Swin block route and the backward rules it
    needs. Row 1's backward (``window_block_attention_bwd``, ``_block_bwd``)
    at every Swin-S b32 stage (2,048 / 512 / 128 / 32 windows of 49 at C =
    96 / 192 / 384 / 768; one pattern, and one per window where the stage
    shifts), row 6's (``fused_mlp_preln_bwd``) at stage 4's 1,568 x 768,
    row 7's (``swin_attn_half_bwd``) at window 12 and C = 768 (phase 9's
    shape) and ``attention_core_op`` (forward and backward) at stage 3 with
    four patterns, each against its plain version, two calls bitwise
    equal, timed beside the library's autograd of the same layers and its
    bound, also as CUDA graphs; then the Swin-S step of record with
    ``swin.drop_rate`` 0.1 (every block on row 1 and its VJP), driven as in
    phase 7 on replayed masks and timed in turns with the step of record;
    the flagship forward and the Swin-S step with the backbone on
    ``attn_impl='pallas_block'`` (timed in turns with 'auto'); the step on
    'xla' and the step with ``attn_drop_rate`` 0.1 as well (the XLA
    attention with dropout on its probabilities), checked and counted.
    ``python3 chip_smoke.py --swin-routes`` runs phases 1-2 and this phase
    only;
18. long form: K2 and K4 past N = 288 (their long form: the keys, or in
    K4's second pass the queries, streamed through a ring of 64-row
    chunks) against their plain versions at S = 298, 348 and 474 (b32, 12
    heads, head dim 64: ViT-B/16 or the linear patch with RGC's 100 or
    MIMIC-CXR's 150 text tokens, and two IU X-Ray views at 80), with a key
    bias, the key bias or the seq2seq qbias with a dropout mask, and
    in-kernel (regenerated) dropout with either bias: ``KERNEL_BAR``, two
    calls bitwise equal, the keep mask bitwise equal to the plain Philox
    stream, timed eagerly and as CUDA graphs beside SDPA or the bf16
    composition and the bound (rows ``biased_attention_long_form``,
    ``biased_attention_bwd_long_form``); the window modes refusing N = 289
    before a launch; then the paths, each against its plain run on
    replayed masks (gradients, 3 losses, launch counts with every K2 / K4
    launch's N, ms/step in turns, peak memory): the caption step on
    ViT-B/16 (b32, text 150, S = 348), the two-view caption step on the
    linear patch (b32, IU X-Ray's 80, S = 474), the two-view retrieval step
    on ViT-B/16 (32 pairs, S = 474); the two-view ViT grid (32 x 32: K2 at
    N = 474, P(match) against plain); one two-view ViT generate call (b16,
    beam 5: no K2, logits against plain); and ``run_report_generation
    --conv vit`` on the synthetic IU X-Ray tree, in a process of its own
    under a time limit. ``python3 chip_smoke.py --long-n`` runs phases 1-2
    and this phase only;
19. int8w and remat: report generation on weight-only int8 through the
    port's entry (``caption_generate_int8w``: ``tasks.caption.
    decode_reports(..., quant="int8w")`` on a ``TaskRunner``, Swin-S @224
    + BERT-base, 32 studies, beam 5, length 150, f32 masters and bf16
    compute) from a seeded checkpoint in the reference's layout
    (``MVLBertForImageCaption`` names), read by the port's
    ``caption_state_dict_from_torch`` and loaded with ``strict=True``: the
    launch counts of one int8w decode, two int8w decodes bitwise equal, the
    count the decode logs equal to JAX's predicate's on the converted
    JAX-layout tree, ``eval_caption(quant="int8w")``'s scores finite; on
    the runner's int8 tree, the features, the prefill's and the first
    decode step's logits, kernels against plain; the int8w first step
    against bf16's (relative error, cosine); the quantized bytes, the int8
    tree's resident memory, each route's peak memory in a decode and
    tokens/s of the int8w and bf16 decodes in turns; then the Swin-S step
    of record with ``remat_backbone`` and ``remat_fusion``
    (``swin_pretrain_remat_train_step``) against the step without, from
    one seed and on the same masks: gradients in both mask modes, the
    forward rows launched twice a step and the backward rows as often, 3
    losses, the peak memory and ms/step in turns, and one step with both
    switches (``MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1``) held the same way.
    The default run only;
20. single card: what JAX does on one device beside the paths above, each
    against its plain run at full width. The kernel cases of a shifted
    wide stage (Swin-S @448's stage 4, b8, P = 4: row 1 with the residual,
    row 18 with the shift gather forward and forward + backward, rows 19 /
    21; row 7's own kernel on a shifted map, window 8 at C = 768); then the
    VQA forward on Swin-S @448 (b8, window 7, S = 221: stage 4 rolled on
    rows 1 + 6; logits, launch counts, samples/s 2 x 10 in turns), the step
    of record at 448 (b8, S = 278: stage 4's shifted block on row 18;
    gradients in both modes to ``SWIN_GRAD_BAR``, 3 losses, ms/step), the
    forward and the step of record with ``ape`` (the table's gradient to
    ``SWIN_GRAD_BAR``), the ViT-B/16 pretrain step with its dropouts at 0.1
    (b32, S = 278: the ViT's masks replayed into the plain run with the
    fusion's; gradients to ``vit_bars``, 3 losses, ms/step 2 x 4), the step
    of record with bf16 AdamW moments (b32: 3 losses against plain, the
    moment's dtype and bytes against the f32 optimizer's, ms/step and peak
    memory in turns with the step of record) and one of its steps traced
    through ``utils.profiling.trace`` (the file names the annotation and
    K1-K5). ``python3 chip_smoke.py --single-card`` runs phases 1-2 and this
    phase only;
21. multi-device, in processes of its own under ``MULTI_DEVICE_TIMEOUT``
    (``--multi-device-run``, the process group killed at the limit): K2 /
    K4's in-kernel dropout on a TP rank's heads (6-11 of 12, ``head0`` =
    6; the mask and the outputs bitwise the 12-head launch's); the step of
    record (Swin-S + BERT-base, b32, S = 131, DropPath 0.3, dropout 0.1)
    one process on recorded masks; (a) the same through
    ``make_pretrain_step(mesh=...)`` on a (1, 1) mesh over NCCL at world
    size 1: losses and parameters bitwise, launches as
    ``EXPECTED_SWIN_PRETRAIN``; then two gloo ranks both on ``cuda:0``
    (NCCL refuses two ranks on one card), rank 0's weights broadcast: (b)
    DP 2, 16 rows a rank replaying their rows of the masks, and (c) TP 2,
    the fusion split on 6 heads a rank and the MLM decoders vocab-split
    and the Swin backbone split (Swin-S stage 1's attention halves held
    whole, 3 heads) (``EXPECTED_TP_STEP``): 3 losses to ``LOSS_BAR``, step
    1's gradients (gathered) to ``swin_bars``, the replicated parameters
    bitwise equal on both ranks, each rank's launches (K1-K5 as one
    device's at b16 / b32), the backbone parameters a rank holds and the
    step's peak memory; (d) the linear-patch VQA step at DP 2 (S = 221):
    the BatchNorm buffers after step 1 within ``BN_BUFFER_BAR`` of one
    process's and equal on both ranks; (e) the ViT-B/16 pretrain step at TP
    2 (its blocks and the fusion split), held to the one-process step as
    (c) (``vit_bars``; K1 ``VIT_TP_K1_EXTRA`` a block more), its reference
    built while the ranks run (b)-(d); ms/step of (a)-(c) and (e) beside
    one device's (informative: gloo on one card measures nothing a user
    runs). ``python3 chip_smoke.py
    --multi-device`` runs phases 1-2 and this phase only;
22. print ``{"kernels": [...]}``, then ``{"ok": true, "device": {...}}``
    last.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent
# ``--loader-pace``: the drivers' loader-pace loops (set in __main__)
LOADER_PACE = False

# bars, stated as a multiple of the largest |value| of the plain output:
# one kernel vs its plain version differ only in summation order, so by at
# most about one bf16 rounding step (2^-8 relative) at the largest value.
KERNEL_BAR = 2.0 ** -7
# a counterpart chains up to seven kernels; a rounding step that flips in
# one intermediate can grow through the next LN / GELU / softmax.
BLOCK_BAR = 2.0 ** -5
# the whole forward chains 136 counterpart calls and 40 other kernel calls.
LOGITS_BAR = 0.05
# train step, kernels vs plain, both bf16 with the same rounding points: a
# bf16 step that flips in one of the ~250 kernel calls of a step passes
# through 12 layers, the pooler and the head. Per tensor of the fusion
# encoder, the heads and resnet_fc, relative to the plain gradient's max|.|.
GRAD_BAR = 0.05
# The ResNet's gradients are those differences carried back through 104
# BatchNorm backwards in bf16, and a BN bias gradient is a sum over
# B*H*W = 32*112*112 positions with heavy cancellation: its largest element
# moved by 0.23 x max|grad| at the stem in one run. The backbone is held in
# relative Frobenius norm per tensor instead. Losses: relative.
BACKBONE_GRAD_BAR = 0.25
# The Swin backbone has no BatchNorm: its gradients pass through the 24
# blocks' store-residual backwards, LayerNorms and DropPath scales, with
# the same rounding points on both sides, so each tensor is held to the
# encoder's max-abs bar, the relative-position tables included. A table's
# gradient sums ds over up to 2048 windows (stage 1 at b32), and cancelling
# sums could have asked for a Frobenius bar, but the measurement did not:
# on an H100 the tables' worst max abs err was 0.029 x max|plain grad| and
# the other Swin tensors' 0.024, in both mask modes (PERF.md, section 6).
SWIN_GRAD_BAR = 0.05
LOSS_BAR = 1e-2
TRAIN_BATCH, TRAIN_STEPS = 32, 3
PRETRAIN_TEXT = 80
PRETRAIN_MODES = (False, True, False)          # seq2seq per step

# H100 SXM peaks (NVIDIA data sheet; dense bf16 tensor cores, HBM3)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# calls per CUDA graph in ``graph_ms``
GRAPH_REPS = 10

# calls per flagship forward of each TPU kernel on the JAX path, traced with
# the TPU kernel gates forced on: port function -> (count, TPU kernel)
EXPECTED = {
    "swin_full_block": (11, "mvlt_tpu/ops/pallas_attn.py:652"),
    "swin_full_block_shift": (11, "mvlt_tpu/ops/pallas_attn.py:702"),
    "window_block_attention": (2, "mvlt_tpu/ops/pallas_attn.py:166"),
    "fused_mlp_preln": (2, "mvlt_tpu/ops/pallas_attn.py:3359"),
    "fused_attn_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
    # the 'pallas' route's kernel stays off on 'auto'
    "window_attention": (0, "mvlt_tpu/ops/pallas_attn.py:40"),
    "swin_attn_half": (0, "mvlt_tpu/ops/pallas_attn.py:3228"),
}
# calls per VQA train step of each TPU kernel on the JAX path (12 layers,
# forward and backward)
EXPECTED_TRAIN = {
    "fused_attn_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
    "seq_attention_core_bwd": (12, "mvlt_tpu/ops/pallas_attn.py:2413"),
    "mlp_ln_half_bwd": (12, "mvlt_tpu/ops/pallas_attn.py:2931"),
}
# calls per pretrain step (12 layers, forward and backward, dropout on)
EXPECTED_PRETRAIN = {
    "fused_attn_ln_masked": (12, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_mlp_ln_masked": (12, "mvlt_tpu/ops/pallas_attn.py:3194"),
    "seq_attention_core_bwd": (12, "mvlt_tpu/ops/pallas_attn.py:2413"),
    "mlp_ln_half_bwd": (12, "mvlt_tpu/ops/pallas_attn.py:2931"),
}
# calls per Swin-S pretrain step (24 Swin blocks: stages 1-3 on the whole
# block, block 0 without DropPath, every second one shifted; stage 4 on the
# half block; each block's stored backward; then the fusion encoder as
# in the ResNet pretrain step)
EXPECTED_SWIN_PRETRAIN = {
    "swin_full_block_train": (11, "mvlt_tpu/ops/pallas_attn.py:760"),
    "swin_full_block_train_shift": (11, "mvlt_tpu/ops/pallas_attn.py:868"),
    "swin_half_block": (2, "mvlt_tpu/ops/pallas_attn.py:3467"),
    "attention_core": (2, "mvlt_tpu/ops/pallas_attn.py:3614"),
    "attention_core_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:3782"),
    "swin_mlp_half_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:1618"),
    "swin_qkv_tail_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:1787"),
    **EXPECTED_PRETRAIN,
    "swin_full_block": (0, "mvlt_tpu/ops/pallas_attn.py:652"),
    "window_block_attention": (0, "mvlt_tpu/ops/pallas_attn.py:166"),
    # the opt-in modes stay off by default
    "fused_attn_ln_adrop": (0, "mvlt_tpu/ops/pallas_attn.py:2770"),
    "seq_attention_core_bwd_adrop": (0, "mvlt_tpu/ops/pallas_attn.py:2485"),
    "swin_full_block_train_store_p": (0, "mvlt_tpu/ops/pallas_attn.py:791"),
    "swin_full_block_train_shift_store_p": (
        0, "mvlt_tpu/ops/pallas_attn.py:928"),
    "attention_core_bwd_store_p": (0, "mvlt_tpu/ops/pallas_attn.py:3859"),
    "biased_attention_adrop": (0, None), "biased_attention_save_p": (0, None),
    "biased_attention_bwd_adrop": (0, None),
    "biased_attention_bwd_stored_p": (0, None),
    "window_attention": (0, "mvlt_tpu/ops/pallas_attn.py:40"),
    "window_attention_bwd": (0, "mvlt_tpu/ops/pallas_attn.py:128"),
}
# the Swin-S step with MVLT_KERNEL_DROPOUT and MVLT_STOREP set: every fusion
# layer on the in-kernel dropout, its backward regenerating the mask; the 18
# stage-3 blocks (9 unshifted, 9 shifted) storing p, their backward from it
SWITCHES = ("MVLT_KERNEL_DROPOUT", "MVLT_STOREP")
EXPECTED_SWITCHES = {
    **EXPECTED_SWIN_PRETRAIN,
    "fused_attn_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_attn_ln_adrop": (12, "mvlt_tpu/ops/pallas_attn.py:2770"),
    "seq_attention_core_bwd_adrop": (12, "mvlt_tpu/ops/pallas_attn.py:2485"),
    "swin_full_block_train_store_p": (9, "mvlt_tpu/ops/pallas_attn.py:791"),
    "swin_full_block_train_shift_store_p": (
        9, "mvlt_tpu/ops/pallas_attn.py:928"),
    "attention_core_bwd_store_p": (18, "mvlt_tpu/ops/pallas_attn.py:3859"),
    "biased_attention_adrop": (12, None), "biased_attention_save_p": (18, None),
    "biased_attention_bwd_adrop": (12, None),
    "biased_attention_bwd_stored_p": (18, None),
}
# the TPU kernels that no entry point reaches at Swin-S 224 (ROADMAP.md B
# before PR 8): their counterparts are held to their plain versions in
# attn_impl_kernel_checks, and no path launches them
UNREACHED = {
    "swin_attn_half": (0, "mvlt_tpu/ops/pallas_attn.py:3228"),
    "fused_seq_attention": (0, "mvlt_tpu/ops/pallas_attn.py:334"),
    # the VJP that JAX runs in XLA (_seq_bwd)
    "fused_seq_attention_bwd": (0, "mvlt_tpu/ops/pallas_attn.py:440"),
    "full_forward_windows": (0, "mvlt_tpu/ops/pallas_attn.py:1161"),
}
# the flagship forward with the backbone on attn_impl='pallas': row 8 in
# each of the 24 Swin blocks (Dense / LN on K1 / K3 around it), no fused
# Swin kernel; the fusion encoder as on 'auto'
EXPECTED_PALLAS = {
    "window_attention": (24, "mvlt_tpu/ops/pallas_attn.py:40"),
    "biased_attention_heads": (24, None),
    "swin_full_block": (0, "mvlt_tpu/ops/pallas_attn.py:652"),
    "swin_full_block_shift": (0, "mvlt_tpu/ops/pallas_attn.py:702"),
    "window_block_attention": (0, "mvlt_tpu/ops/pallas_attn.py:166"),
    "fused_mlp_preln": (0, "mvlt_tpu/ops/pallas_attn.py:3359"),
    "fused_attn_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
    "window_attention_bwd": (0, "mvlt_tpu/ops/pallas_attn.py:128"),
    **UNREACHED,
}
# the Swin-S step of record with the backbone on 'pallas': 24 row-8
# forwards under autograd and their 24 backwards on K4's pattern mode (the
# Dense / LN / GELU layers on F.linear / F.layer_norm, as JAX leaves them to
# XLA), no Swin block kernel; the fusion encoder as on 'auto'
EXPECTED_SWIN_PALLAS = {
    **{k: (0, v[1]) for k, v in EXPECTED_SWIN_PRETRAIN.items()},
    **EXPECTED_PRETRAIN,
    "window_attention": (24, "mvlt_tpu/ops/pallas_attn.py:40"),
    "window_attention_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:128"),
    "biased_attention_heads": (24, None),
    **UNREACHED,
}
# the backward rules that no path of record differentiates (rows 6 and 7
# reach autograd only at the op level, as in JAX, and attention_core_op only
# inside other VJPs there): held to their plain versions in
# swin_routes_kernel_checks
ROUTE_UNREACHED = {
    "fused_mlp_preln_bwd": (0, "mvlt_tpu/ops/pallas_attn.py:3429"),
    "swin_attn_half_bwd": (0, "mvlt_tpu/ops/pallas_attn.py:3345"),
    "attention_core_op": (0, "mvlt_tpu/ops/pallas_attn.py:4120"),
}
_NO_SWIN_STEP = {**{k: (0, v[1]) for k, v in EXPECTED_SWIN_PRETRAIN.items()},
                 **EXPECTED_PRETRAIN, **ROUTE_UNREACHED,
                 "biased_attention_heads": (0, None),
                 "window_block_attention_bwd": (
                     0, "mvlt_tpu/ops/pallas_attn.py:2092")}
# the Swin-S step of record with swin.drop_rate 0.1 (JAX's fused training
# routes need both Swin dropout rates at 0, swin.py:285-288, 318-320): every
# block on JAX's plain route, whose 'auto' attention is row 1 (swin.py:
# 170-180): 24 row-1 forwards under autograd and their 24 _block_bwd's, each
# recomputing ctx on attention_core (row 19) and differentiating through
# attention_core_bwd (row 21); LN / Mlp / DropPath / dropout around them on
# F.layer_norm / F.linear / F.gelu, as JAX leaves them to XLA; the fusion
# encoder as in the step of record. 'pallas_block' at rates 0 runs the same.
EXPECTED_SWIN_DROPOUT = {
    **_NO_SWIN_STEP,
    "window_block_attention": (24, "mvlt_tpu/ops/pallas_attn.py:166"),
    "window_block_attention_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:2092"),
    "attention_core": (24, "mvlt_tpu/ops/pallas_attn.py:3614"),
    "attention_core_bwd": (24, "mvlt_tpu/ops/pallas_attn.py:3782"),
}
# the Swin-S step on 'xla', and with attn_drop_rate 0.1 (which 'auto' sends
# to 'xla'): the attention in plain torch, as JAX computes it in XLA; no
# Swin counterpart runs, the fusion's do
EXPECTED_SWIN_XLA = _NO_SWIN_STEP
EXPECTED_SWIN_ROUTES = {"pallas": EXPECTED_SWIN_PALLAS,
                        "pallas_block": EXPECTED_SWIN_DROPOUT,
                        "xla": EXPECTED_SWIN_XLA}
# the flagship forward with the backbone on 'pallas_block': row 1 in all 24
# blocks (LN / Mlp on K3 / K1 around it), no row 2 / 3 / 6
EXPECTED_PALLAS_BLOCK = {
    **EXPECTED_PALLAS, **ROUTE_UNREACHED,
    "window_attention": (0, "mvlt_tpu/ops/pallas_attn.py:40"),
    "biased_attention_heads": (0, None),
    "window_block_attention": (24, "mvlt_tpu/ops/pallas_attn.py:166"),
}
EXPECTED_FORWARD_ROUTES = {"auto": EXPECTED, "pallas": EXPECTED_PALLAS,
                           "pallas_block": EXPECTED_PALLAS_BLOCK}
# report generation at the MIMIC-CXR settings (run_report_generation.py:
# 46-52, 70-71): b32, beam 5, caption length 150 (S = 1 + 49 + 1 + 150)
CAPTION_TEXT, CAPTION_BEAMS = 150, 5
# cached decode steps held against the uncached forward
CAPTION_CACHED_STEPS = 8
# beam-shaped decode steps (B * K rows) held against the plain versions
CAPTION_BEAM_STEPS = 4
# calls per generate call: the Swin serving rows once per batch (the
# features are repeated K-fold after the prefill), the prefill's 12 MLP
# halves on row 5 and its attention halves plain (JAX's need_kv gate,
# fusion.py:113), the decode steps plain (K1 / K3 through Dense / LayerNorm)
EXPECTED_CAPTION_GENERATE = {
    **EXPECTED,
    "fused_attn_ln": (0, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_attn_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
}
# the caption step runs the Swin-S pretrain step's kernels in seq2seq mode
EXPECTED_CAPTION_STEP = EXPECTED_SWIN_PRETRAIN
# the counterparts of the Swin-S step that run in the forward of a Swin
# block or a fusion layer: with remat_backbone and remat_fusion each runs
# twice a step (the forward, and the recompute before the backward); the
# backward ones as often as without remat
REMAT_FORWARD_ROWS = (
    "swin_full_block_train", "swin_full_block_train_shift", "swin_half_block",
    "attention_core", "fused_attn_ln_masked", "fused_mlp_ln_masked",
    "fused_attn_ln_adrop", "swin_full_block_train_store_p",
    "swin_full_block_train_shift_store_p", "biased_attention_adrop",
    "biased_attention_save_p")
REMAT_BACKWARD_ROWS = (
    "attention_core_bwd", "swin_mlp_half_bwd", "swin_qkv_tail_bwd",
    "seq_attention_core_bwd", "mlp_ln_half_bwd",
    "seq_attention_core_bwd_adrop", "attention_core_bwd_store_p",
    "biased_attention_bwd_adrop", "biased_attention_bwd_stored_p")
# int8w report generation: the timed calls per route, in turns
INT8W_TIMED_CALLS = 3
# image-text retrieval at run_retrieval.py's settings: a test grid of
# RETRIEVAL_N samples scored in chunks of 64 (:133), caption length 80 (S =
# 1 + 49 + 1 + 80 = 131); a train batch of 32 pairs, cat(pos, neg) = 64
# rows (:45-54, tasks/retrieval.py:31-35)
RETRIEVAL_N, RETRIEVAL_CHUNK, RETRIEVAL_TEXT = 128, 64, 80
RETRIEVAL_PAIRS = 32
# the sub-grid held against the plain versions: images x captions
RETRIEVAL_SUB = (16, 64)
# grid rows held against the full model's score (backbone per pair)
RETRIEVAL_FULL_ROWS = (0, 77, 127)
_CHUNKS = -(-RETRIEVAL_N // RETRIEVAL_CHUNK)
_SCORE_CALLS = RETRIEVAL_N * _CHUNKS
# calls per grid: the Swin serving rows once per chunk of images, rows 4
# and 5 in each of the n x ceil(n / 64) fusion-only score calls
EXPECTED_RETRIEVAL_GRID = {
    **{k: (v[0] * _CHUNKS, v[1]) for k, v in EXPECTED.items()},
    "fused_attn_ln": (12 * _SCORE_CALLS, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12 * _SCORE_CALLS, "mvlt_tpu/ops/pallas_attn.py:2817"),
    "fused_attn_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
}
# the retrieval step: the Swin-S step's backbone rows; in the fusion,
# attention dropout without hidden dropout: row 15 with an amask and no
# hmask, row 5 in its training form, row 16, row 17 without hmask2
EXPECTED_RETRIEVAL_STEP = {
    **EXPECTED_SWIN_PRETRAIN,
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
}
# the VQA task driver at run_vqa.py's defaults (:19-41): for_vqa (fusion
# dropouts 0.1, lr 4e-5) on Swin-S (DropPath 0.3), b64, SLAKE's question
# length 23 (S = 1 + 49 + 1 + 23 = 74), 2 epochs, loader worker processes;
# on a synthetic SLAKE in pickles: 64 images, 224 answers, 320 train
# questions (5 steps of b64), 100 validate and 100 test (a tail of 36)
VQA_DRIVER_DATA = dict(images=64, answers=224, image_size=224, train=320,
                       validate=100, test=100)
VQA_DRIVER_BATCH, VQA_DRIVER_EPOCHS, VQA_DRIVER_WORKERS = 64, 2, 2
# the timed train loops: one epoch each of a train split as long as the
# English SLAKE release's (76 steps at b64), many times the loader's
# lookahead (workers + prefetch pool jobs, 2 batches queued, 2 in the device
# prefetch), for the CLI default (-1: 7 processes on an 8-core host) and
# threads (0; since PR 16 no longer the 2 processes of the driver run, whose
# epoch PR 15 timed at 0.144-0.202x the bare rate: the pretrain driver's
# loops took its time); bare steps a timed bare run
VQA_DRIVER_TIMED_WORKERS = (-1, 0)
VQA_DRIVER_BARE_STEPS = 20
# every driver phase's timed epoch reads the loop's pace while the loader
# builds: without the first DRIVER_STEADY_FROM steps, which its read-ahead
# with 7 processes serves (7 + 2 batches submitted, 2 queued, 2 in the
# device prefetch: 13 batches built before the loop asks for them), and
# without the last DRIVER_STEADY_FROM, which drain that read-ahead after
# the loader's last batch
DRIVER_STEADY_FROM = 16
# batches the loader alone delivers a setting in the probe
VQA_PROBE_BATCHES = 28
# the phase's own limit, in seconds: it runs in a process of its own
VQA_DRIVER_TIMEOUT = 600
VQA_DRIVER_TAG = "vqa driver launches: "
# the pretrain driver at run_pretrain.py's defaults (:19-46): for_pretrain
# (fusion dropouts 0.1) with ITM on, text 80 (S = 131), Swin-S (DropPath
# 0.3), b32, lr 4e-5, the per-batch coin flip; 2 epochs of 3 steps on a
# synthetic corpus of 96 samples (seeded uint8 frames of 224) written as RGC
# f32 pickles (the kernel run's source), a uint8 cache and, with Pillow, a
# ROCO split of PNG frames; loader worker processes in the kernel run
PRETRAIN_DRIVER_DATA = dict(n=96, image_size=224, seed=0)
PRETRAIN_DRIVER_BATCH, PRETRAIN_DRIVER_EPOCHS = 32, 2
PRETRAIN_DRIVER_WORKERS = 2
PRETRAIN_KEYS = ("image", "caption_masked", "caption_label", "itm_label")
# the driver's losses against the plain run's, relative: step 1 (one set
# of weights, kernels vs plain alone) and a uint8 step within
# PRETRAIN_DRIVER_LOSS_BAR; the later steps, after AdamW moved each route's
# weights by its own gradients, within LOSS_BAR as in every other phase. At
# step 1 AdamW moves every weight by about +-lr whatever its gradient's
# size, so a gradient near 0 that rounds to the other sign moves a weight
# by 2 lr the other way: the ITM loss (a 2-way CE near ln 2) of step 2 sat
# at 1.26e-3 relative on an H100 (PERF.md, PR 16)
PRETRAIN_DRIVER_LOSS_BAR = 1e-3
# the timed loops: one epoch of PRETRAIN_TIMED_SAMPLES (48 steps at b32,
# 16 read while the loader builds) for each source and each of
# PRETRAIN_TIMED_WORKERS (the CLI default, threads); bare steps per mode on
# a resident batch
PRETRAIN_TIMED_SAMPLES = 1536
PRETRAIN_TIMED_WORKERS = (-1, 0)
PRETRAIN_DRIVER_BARE_STEPS = 10
PRETRAIN_DRIVER_TIMEOUT = 600
PRETRAIN_DRIVER_TAG = "pretrain driver launches: "
# device_var_normalize on the card against normalize_image_var on the
# host: within this share of max|out| beyond the host's own distance from
# the float64 value (the host sums in f32 in another order)
NORMALIZE_BAR = 1e-5
# one driver step: the Swin-S step's backbone rows and, with both fusion
# dropouts, rows 15 (amask + hmask), 16, 17 (hmask2) and 17' as the pretrain
# step runs them; one eval batch runs the forward's serving rows (EXPECTED)
EXPECTED_VQA_DRIVER_STEP = EXPECTED_SWIN_PRETRAIN
# the Swin counterparts: a two-view (IU X-Ray) batch runs each once per
# view; the fusion counterparts run once per step either way
SWIN_COUNTERPARTS = {
    "swin_full_block", "swin_full_block_shift", "window_block_attention",
    "fused_mlp_preln", "swin_attn_half", "window_attention",
    "window_attention_bwd", "swin_full_block_train",
    "swin_full_block_train_shift", "swin_full_block_train_store_p",
    "swin_full_block_train_shift_store_p", "swin_half_block",
    "attention_core", "attention_core_bwd", "attention_core_bwd_store_p",
    "swin_mlp_half_bwd", "swin_qkv_tail_bwd", "full_forward_windows",
    "window_block_attention_bwd", "fused_mlp_preln_bwd", "swin_attn_half_bwd",
    "attention_core_op"}


def two_view(expected: dict) -> dict:
    """The counts of ``expected`` for a two-view batch: the Swin
    counterparts twice, the others as they are."""
    return {k: (2 * n if k in SWIN_COUNTERPARTS else n, src)
            for k, (n, src) in expected.items()}


# the report generation driver at run_report_generation.py's IU X-Ray
# settings (:34-71): for_caption(max_length=80), unilm (fusion dropouts 0.1,
# DropPath 0.3), b32, beam 5, two 224-px views a study: S = 1 + 2 x 49 + 1
# + 80 = 180, a decode prefix of 100; 2 epochs of 3 steps on a synthetic
# IU X-Ray tree (two 256-px views a study: 96 / 16 / 32 studies), the test
# after the second epoch (32 studies in eval_caption's batches of 16)
IU_XRAY_TEXT = 80
IU_XRAY_DATA = dict(splits={"train": 96, "val": 16, "test": 32},
                    image_size=256, seed=0)
CAPTION_DRIVER_BATCH, CAPTION_DRIVER_EPOCHS, CAPTION_DRIVER_BEAMS = 32, 2, 5
CAPTION_DRIVER_WORKERS = 2
# eval_caption's batch (tasks/caption.py:51, JAX's default)
CAPTION_EVAL_BATCH = 16
# one driver step: the caption step's (phase 10) with the Swin rows twice;
# one eval batch: a generate call's, the Swin serving rows twice
EXPECTED_CAPTION_DRIVER_STEP = two_view(EXPECTED_CAPTION_STEP)
EXPECTED_CAPTION_DRIVER_EVAL = two_view(EXPECTED_CAPTION_GENERATE)
# the timed loops: one epoch of IU_XRAY_TIMED studies (48 steps of either
# driver, 16 read while the loader builds) per image layout and loader
# setting (-1: the CLI default, 7 processes on an 8-core host; 0: threads),
# beside TASK_DRIVER_BARE_STEPS bare steps on a resident batch. Caption:
# uint8 with an export (processes), f32 ImageNet crops without (processes,
# threads); retrieval: uint8 (processes, threads), and for f32
# host-normalized batches (a non-default option) the features and the bare
# step only: their epochs took 2.46x the bare step with threads and 10.5-
# 12.6 s to the first step with processes (PERF.md §6), and the whole
# script stays well inside its limit without them
IU_XRAY_TIMED = 1536
TASK_DRIVER_BARE_STEPS = 10
CAPTION_DRIVER_TIMEOUT = 420
CAPTION_DRIVER_TAG = "caption driver launches: "
# the retrieval driver at run_retrieval.py --iu_xray_root's settings
# (:33-62, swap 'image'): for_retrieval (attention dropout 0.1, hidden 0.0,
# DropPath 0.3), 32 pairs = 64 rows of two views, S = 180; one epoch of 3
# steps, then eval_retrieval on the 32 test studies (one chunk of 32)
RETRIEVAL_DRIVER_PAIRS, RETRIEVAL_DRIVER_WORKERS = 32, 2
EXPECTED_RETRIEVAL_DRIVER_STEP = two_view(EXPECTED_RETRIEVAL_STEP)
RETRIEVAL_DRIVER_TIMEOUT = 360
RETRIEVAL_DRIVER_TAG = "retrieval driver launches: "
# the other backbones (JAX's adapter.py:49-69) at full width, each a phase
# of its own with kernels against plain: ViT-B/16 @224 and the linear patch
# give 196 image tokens, so the fusion encoder runs K2 / K4 at S = 1 + 196 +
# 1 + 23 = 221 (VQA, question 23) and 1 + 196 + 1 + 80 = 278 (pretrain,
# text 80), the lengths of the ``*_long_n`` rows. The ViT runs K1 / K3
# through Dense / LayerNorm and its own attention on SDPA, as JAX computes
# it in XLA: no Swin counterpart runs, the fusion's rows do.
VIT_VQA_N, VIT_PRETRAIN_N = 221, 278
_NO_SWIN = {k: (0, v[1]) for k, v in EXPECTED.items()}
EXPECTED_VIT_FORWARD = {**_NO_SWIN,
                        "fused_attn_ln": EXPECTED["fused_attn_ln"],
                        "fused_mlp_ln": EXPECTED["fused_mlp_ln"]}
EXPECTED_VIT_PRETRAIN = {**_NO_SWIN, **EXPECTED_PRETRAIN}
EXPECTED_LINEAR_TRAIN = {**_NO_SWIN, **EXPECTED_TRAIN}
# K2 / K4 past N = 288 (their long form) on the paths that need it: report
# generation and retrieval on ViT-B/16 or the linear patch (196 image tokens
# a view) at RGC's 100 text tokens (S = 298), MIMIC-CXR's 150 (348) and two
# IU X-Ray views at 80 (474), as JAX's fused encoder runs them (it has no
# length gate, mvlt_tpu/models/fusion.py:105-117)
LONG_FORM_N = (1 + 196 + 1 + 100, 1 + 196 + 1 + CAPTION_TEXT,
               1 + 2 * 196 + 1 + IU_XRAY_TEXT)
# the first N of the long form (K2 / K4's register form stops at 288)
LONG_FORM_FIRST = 289
# CUDA-event calls a long-form case is timed over (its plain version takes
# up to some hundred ms a call at N = 474 with the Philox mask), and the
# steps of each timed turn of a long-form path
LONG_FORM_ITERS, LONG_STEP_TIMED = 3, 2
# the generate call (eval_caption's batch, beam 5, IU X-Ray's length) and
# the two-view retrieval grid (one chunk of 32 studies, as the retrieval
# driver's test) on ViT-B/16
LONG_GEN_BATCH, LONG_GRID_N = CAPTION_EVAL_BATCH, 32
# the report generation driver on ViT-B/16 (two views, S = 474) in a
# process of its own: seconds it may take
LONG_DRIVER_TIMEOUT = 300
# a caption step with no Swin backbone: the fusion's rows 15, 17', 16, 17
# (both dropouts) as the pretrain step runs them; the retrieval step's
# fusion: row 15 with an amask and no hmask, row 5's training form, 16, 17
EXPECTED_LONG_CAPTION_STEP = _NO_SWIN_STEP
EXPECTED_LONG_RETRIEVAL_STEP = {
    **_NO_SWIN_STEP,
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
}
# a two-view grid of LONG_GRID_N studies in one chunk: the ViT once per
# chunk (K1 / K3 / SDPA), rows 4 and 5 in each of the n score calls
EXPECTED_LONG_GRID = {
    **_NO_SWIN,
    "fused_attn_ln": (12 * LONG_GRID_N, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12 * LONG_GRID_N, "mvlt_tpu/ops/pallas_attn.py:2817"),
    "fused_attn_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
}
# a generate call: the prefill's 12 MLP halves on row 5, its attention
# halves and the decode steps plain (JAX's need_kv / cache_kv gate,
# fusion.py:34-43, 149-170): no K2 at any S
EXPECTED_LONG_GENERATE = {
    **_NO_SWIN,
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
    "fused_attn_ln": (0, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_attn_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:2721"),
    "fused_mlp_ln_masked": (0, "mvlt_tpu/ops/pallas_attn.py:3194"),
}
# Swin-B @224 serving (b8): stages 1-3 (C = 128 / 256 / 512) on rows 2 / 3,
# stage 4 (C = 1024: its MLP half's 8 C^2 bf16 weights exceed 12 MiB) on
# JAX's plain route, row 1 with LN / Mlp around it
# (mvlt_tpu/models/backbones/swin.py:307-311, 338-366): no row 6
EXPECTED_SWIN_BASE_FORWARD = {
    **EXPECTED, "fused_mlp_preln": (0, "mvlt_tpu/ops/pallas_attn.py:3359")}

# phase 20, what JAX runs on one device beside the paths above, at full
# width: Swin-S @448 (window 7) serving and training at b8 (maps 112 / 56 /
# 28 / 14: stage 4 has 4 windows an image and a shifted second block),
# Swin-S with ``ape``, the ViT-B/16 pretrain step with its dropouts at 0.1
# (b32) and the step of record with bf16 AdamW moments (b32)
SINGLE_CARD_BATCH = 8
# the roll changes stage 4's bias patterns (P = 1, then nW = 4), not the
# rows: serving runs each counterpart as often as at 224, stage 4 on row 1
# (JAX's swin_attn_half finds no group at N = 49, merged 98) and row 6
EXPECTED_SWIN448_FORWARD = EXPECTED
# the step at 448: stage 4's shifted block on row 18 with the shift gather
# (JAX's _fused_half_train rolls the map around swin_half_block)
EXPECTED_SWIN448_STEP = {
    **EXPECTED_SWIN_PRETRAIN,
    "swin_half_block": (1, "mvlt_tpu/ops/pallas_attn.py:3467"),
    "swin_half_block_shift": (1, "mvlt_tpu/ops/pallas_attn.py:3467")}
# ape adds its table before the blocks, bf16 moments change the optimizer:
# the rows of the forward and of the step of record
EXPECTED_APE_FORWARD = EXPECTED
EXPECTED_APE_STEP = EXPECTED_SWIN_PRETRAIN
EXPECTED_BF16_MOMENTS = EXPECTED_SWIN_PRETRAIN
# the ViT's dropped attention in plain torch (flax's attention runs in XLA);
# the fusion rows of the ViT step at S = 278
EXPECTED_VIT_DROPOUT = EXPECTED_VIT_PRETRAIN
# what one traced Swin-S step's Chrome trace must name: the annotation and
# a kernel of each of K1-K5
# phase 21, multi-device: the step of record over a (data, model) mesh in
# processes of its own (the coordinator and two gloo ranks on one card)
MULTI_DEVICE_TIMEOUT = 300
MULTI_DEVICE_TAG = "multi-device launches: "
MULTI_DEVICE_TIMED = 2
MULTI_DEVICE_RANK_DEVICE = "cuda:0"      # both ranks: gloo on one card
BN_BUFFER_BAR = 1e-4
# TP 2: the fusion rows 15 / 16 / 17 / 17' and the Swin rows split at the
# all-reduce run each counterpart as often as one device (K2 and K4 on the
# rank's heads: 6 of the fusion's 12, 3 / 6 / 12 of Swin-S stages 2-4;
# stage 1's 3 heads run whole, its MLP split). K1-K5 launch as one device's;
# a product that writes f32 partials has no epilogue and may take K1's
# split-K (``gemm_plan`` at the halved shapes), so ``gemm_splitk`` follows
# the plan and is printed, not held
EXPECTED_TP_STEP = EXPECTED_SWIN_PRETRAIN
# (e) ViT-B/16 at TP 2: the fusion rows as one device's; the ViT's `out` and
# `mlp_fc2` run row-parallel on K1 (f32 partials: its forward and its two
# backward products, where one device runs F.linear), so K1 launches
# VIT_TP_K1_EXTRA a block more than one device's, K2-K5 as many
EXPECTED_VIT_TP_STEP = EXPECTED_VIT_PRETRAIN
VIT_TP_K1_EXTRA = 6
TRACE_NAMES = {"annotation": "mvlt swin step", "K1": "gemm_wgmma_kernel",
               "K2": "attention_wgmma_kernel", "K3": "layernorm_kernel",
               "K4": "attention_bwd_dq_kernel", "K5": "ln_bwd_kernel"}

# the hand-written kernels and the TPU code whose pieces each carries
KERNEL_SOURCES = {
    "gemm": ("mvlt_tpu_torch/csrc/gemm.cu", "mvlt_tpu/ops/pallas_attn.py:571"),
    "biased_attention": ("mvlt_tpu_torch/csrc/attention.cu",
                         "mvlt_tpu/ops/pallas_attn.py:512"),
    "layernorm": ("mvlt_tpu_torch/csrc/layernorm.cu",
                  "mvlt_tpu/ops/pallas_attn.py:494"),
    "biased_attention_bwd": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                             "mvlt_tpu/ops/pallas_attn.py:2413"),
    "layernorm_bwd": ("mvlt_tpu_torch/csrc/layernorm_bwd.cu",
                      "mvlt_tpu/ops/pallas_attn.py:2970"),
    "column_sum": ("mvlt_tpu_torch/csrc/layernorm_bwd.cu",
                   "mvlt_tpu/ops/pallas_attn.py:3003"),
    # the opt-in modes of K2 / K4, each a row of its own
    "biased_attention_adrop": ("mvlt_tpu_torch/csrc/attention.cu",
                               "mvlt_tpu/ops/pallas_attn.py:2133"),
    "biased_attention_save_p": ("mvlt_tpu_torch/csrc/attention.cu",
                                "mvlt_tpu/ops/pallas_attn.py:774"),
    "biased_attention_bwd_adrop": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                   "mvlt_tpu/ops/pallas_attn.py:2485"),
    "biased_attention_bwd_stored_p": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                      "mvlt_tpu/ops/pallas_attn.py:3859"),
    # K2's head-major layout (q, k, v through strides)
    "biased_attention_heads": ("mvlt_tpu_torch/csrc/attention.cu",
                               "mvlt_tpu/ops/pallas_attn.py:40"),
    # K2 and K4 at S = 221 / 278 (ViT-B/16 or the linear patch with BERT
    # text); launched as K2 / K4 on the vit / linear paths, whose launches
    # at N >= 221 the rows count
    "biased_attention_long_n": ("mvlt_tpu_torch/csrc/attention.cu",
                                "mvlt_tpu/ops/pallas_attn.py:512"),
    "biased_attention_bwd_long_n": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                    "mvlt_tpu/ops/pallas_attn.py:2413"),
    # K2 and K4 at the caption step's S = 201 with the seq2seq qbias and a
    # dropout mask; launched as K2 / K4 on the caption_step path
    "biased_attention_n201": ("mvlt_tpu_torch/csrc/attention.cu",
                              "mvlt_tpu/ops/pallas_attn.py:512"),
    "biased_attention_bwd_n201": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                  "mvlt_tpu/ops/pallas_attn.py:2413"),
    # K2 and K4 at the two-view caption step's S = 180 (two Swin-S views and
    # an IU X-Ray report) with the seq2seq qbias and a dropout mask;
    # launched as K2 / K4 on the caption_driver and retrieval_driver paths
    "biased_attention_n180": ("mvlt_tpu_torch/csrc/attention.cu",
                              "mvlt_tpu/ops/pallas_attn.py:512"),
    "biased_attention_bwd_n180": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                  "mvlt_tpu/ops/pallas_attn.py:2413"),
    # K2 at the retrieval grid's score calls: b64, S = 131, 12 heads, the
    # key bias of padded captions; launched as K2 on the retrieval paths
    "biased_attention_b64": ("mvlt_tpu_torch/csrc/attention.cu",
                             "mvlt_tpu/ops/pallas_attn.py:512"),
    # K2 and K4's long form past N = 288 (`attention_long_kernel`, the
    # `attention_bwd_*_long_kernel` pair): the fused encoder's attention
    # half and its backward at S = 298 / 348 / 474; launched as K2 / K4 on
    # the long-form paths, whose launches at N > 288 the rows count
    "biased_attention_long_form": ("mvlt_tpu_torch/csrc/attention.cu",
                                   "mvlt_tpu/ops/pallas_attn.py:2156"),
    "biased_attention_bwd_long_form": ("mvlt_tpu_torch/csrc/attention_bwd.cu",
                                       "mvlt_tpu/ops/pallas_attn.py:2413"),
    # K1's split-K weight gradients: the sums that _swin_mlp_bwd_kernel
    # carries across its sequential grid (:1689-1695)
    "gemm_splitk": ("mvlt_tpu_torch/csrc/gemm.cu",
                    "mvlt_tpu/ops/pallas_attn.py:1618"),
}
# the modes' counts on the kernel wrappers (``kernels.MODE_COUNTS``)
MODE_ROWS = {"splitk_launches": "splitk",
             "adrop_launches": "adrop", "save_p_launches": "save_p",
             "stored_p_launches": "stored_p", "heads_launches": "heads"}
# the modes' counts on the counterparts (``blocks.COUNTS``)
COUNTERPART_MODES = {
    "swin_full_block": {"shift_launches": "shift",
                        "train_launches": "train",
                        "train_shift_launches": "train_shift",
                        "train_store_p_launches": "train_store_p",
                        "train_shift_store_p_launches": "train_shift_store_p"},
    "swin_half_block": {"shift_launches": "shift"},
    "attention_core_bwd": {"store_p_launches": "store_p"},
    "seq_attention_core_bwd": {"adrop_launches": "adrop"},
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls (warm L2: the caller's data stays resident)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn) -> float:
    """Mean device time of one call of ``fn`` in ms, as a CUDA graph of
    ``GRAPH_REPS`` calls replayed 5 times: the wrapper's host time, which
    paces ``cuda_ms`` on small cases, drops out (warm L2). Captured on
    ``fn.stream`` where ``fn`` names one (``library_backward``)."""
    side = getattr(fn, "stream", None) or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * GRAPH_REPS)


def _tensors(out):
    """The tensors of an output, in order, leaving out None."""
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    return [t for t in out if t is not None]


def bound(flops: float, nbytes: float):
    """(least ms on an H100 SXM, what bounds it) for one call."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Checker:
    """Runs each kernel case against its plain twin and keeps the numbers:
    per row (kernel name) the max abs error and the sums over its cases of
    the kernel's, the plain version's and the library call's times and of
    the bound."""

    def __init__(self):
        self.rows = {}

    def case(self, name: str, kernel_fn, plain_fn, bar: float, *,
             flops: float, nbytes: float, library_fn=None,
             floor: float = 1.0, also: tuple = (),
             graph: bool = False, label: str = "", iters: int = 20) -> None:
        """``bar`` is a multiple of the largest |value| of each plain output
        (at least ``floor``); ``flops`` / ``nbytes`` are what the function
        must do and move (each input read once, each output written once).
        The numbers are kept under ``name`` and under each row of ``also``.
        With ``graph`` the kernel and the library call are also timed as
        CUDA graphs (``graph_ms``; printed only). ``label`` names the case
        in its line; ``iters`` the CUDA-event calls each time is taken
        over."""
        got, want = _tensors(kernel_fn()), _tensors(plain_fn())
        torch.cuda.synchronize()
        assert len(got) == len(want), (name, len(got), len(want))
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, \
                (name, i, g.shape, w.shape, g.dtype, w.dtype)
            assert torch.isfinite(g).all(), f"{name}: non-finite output {i}"
            e = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            limit = bar * max(scale, floor)
            if not e <= limit:
                raise AssertionError(f"{name}: output {i} max abs err {e} > "
                                     f"{limit} (bar {bar} x max|plain| {scale})")
            err = max(err, e)
        ms, plain_ms = cuda_ms(kernel_fn, iters), cuda_ms(plain_fn, iters)
        lib_ms = cuda_ms(library_fn, iters) if library_fn is not None else None
        b_ms, b_by = bound(flops, nbytes)
        for rname in (name, *also):
            row = self.rows.setdefault(rname, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "bound_ms": 0.0, "_ops": 0.0,
                "_bytes": 0.0, "_nolib": False})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms            # summed over the cases of one kernel
            row["plain_ms"] += plain_ms
            row["bound_ms"] += b_ms
            row["_ops" if b_by == "operations" else "_bytes"] += b_ms
            if lib_ms is None:
                row["_nolib"] = True
            else:
                row["library_ms"] += lib_ms
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        graphs = ""
        if graph:
            g_lib = ("none" if library_fn is None
                     else f"{graph_ms(library_fn):.4f} ms")
            graphs = (f"; as graphs kernel {graph_ms(kernel_fn):.4f} ms "
                      f"library {g_lib}")
        what = f"{name} [{label}]" if label else name
        print(f"check {what}: max_abs_err {err:.3g} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms library {lib} bound {b_ms:.4f} ms ({b_by}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB){graphs}",
              flush=True)

    def row(self, name: str) -> dict:
        r = dict(self.rows[name])
        r["bound_by"] = "operations" if r.pop("_ops") >= r.pop("_bytes") \
            else "bytes"
        if r.pop("_nolib"):
            r["library_ms"] = None
        return r


class Inputs:
    """Seeded bf16 / f32 tensors on the card."""

    def __init__(self, dev, seed: int = 0):
        self.dev = dev
        self.gen = torch.Generator().manual_seed(seed)

    def rnd(self, *shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=self.gen) * std).to(self.dev, dtype)

    def dense(self, k, n):
        return self.rnd(n, k, std=k ** -0.5), self.rnd(n, std=0.1)

    def ln(self, c):
        return (self.rnd(c, std=0.1, dtype=torch.float32) + 1.0,
                self.rnd(c, std=0.1, dtype=torch.float32))

    def perm(self, m):
        return torch.randperm(m, generator=self.gen).to(self.dev, torch.int32)

    def key_bias(self, lengths, S):
        return torch.where(torch.arange(S)[None] < torch.tensor(lengths)[:, None],
                           0.0, -10000.0).to(self.dev)


# ---- library compositions (timed only; the port never calls them) --------

def lib_attention(qkv, G, N, nH, mask, scale):
    """SDPA over fused rows; ``mask`` an additive bf16 mask broadcastable to
    (G, nH, N, N), or None."""
    C = qkv.shape[1] // 3
    t = qkv.view(G, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=mask,
                                       scale=scale)
    return o.permute(0, 2, 1, 3).reshape(G * N, C)


def bf16_ln(g, b):
    return g.to(torch.bfloat16), b.to(torch.bfloat16)


def lib_swin_block(x, params, mask, scale, nH, gather=None, scatter=None,
                   dp=(1.0, 1.0)):
    """``dp``: per-row DropPath multipliers (M, 1) of the two branches."""
    BW, N, C = x.shape
    (ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2) = params
    rows = x.reshape(BW * N, C)
    src = rows if gather is None else rows.index_select(0, gather)
    h = F.layer_norm(src, (C,), ln1s, ln1b, 1e-5)
    ctx = lib_attention(F.linear(h, wqkv, bqkv), BW, N, nH, mask, scale)
    res1 = F.linear(ctx, wproj, bproj) * dp[0] + src
    h2 = F.layer_norm(res1, (C,), ln2s, ln2b, 1e-5)
    out = F.linear(F.gelu(F.linear(h2, w1, b1)), w2, b2) * dp[1] + res1
    if scatter is not None:
        out = out.index_select(0, scatter)
    return out.view(BW, N, C)


def lib_attn_ln(x, wqkv, bqkv, wproj, bproj, mask, lns, lnb, scale, nH,
                eps=1e-12):
    B, N, C = x.shape
    rows = x.reshape(B * N, C)
    ctx = lib_attention(F.linear(rows, wqkv, bqkv), B, N, nH, mask, scale)
    return F.layer_norm(F.linear(ctx, wproj, bproj) + rows, (C,), lns, lnb,
                        eps).view(B, N, C)


def lib_mlp_ln(x, w1, b1, w2, b2, lns, lnb, eps=1e-12):
    rows = x.reshape(-1, x.shape[-1])
    y = F.linear(F.gelu(F.linear(rows, w1, b1)), w2, b2) + rows
    return F.layer_norm(y, (x.shape[-1],), lns, lnb, eps).view(x.shape)


def library_backward(forward, inputs, cotangent):
    """A function that times only the backward of ``forward(*inputs)``:
    the graph is built once and ``torch.autograd.grad`` replays it. On the
    card the forward runs on a stream of its own, which the backward's
    kernels then run on: ``graph_ms`` captures them on that stream
    (``fn.stream``), as autograd does not launch on a capturing stream that
    its forward did not run on."""
    stream = torch.cuda.Stream() if inputs[0].is_cuda else None
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = forward(*leaves)
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)

    def fn():
        return torch.autograd.grad(out, leaves, cotangent, retain_graph=True)

    fn.stream = stream
    return fn


def kernel_checks(chk: Checker, dev) -> None:
    """The PR-2 forward cases at the flagship batch-8 shapes."""
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    inp = Inputs(dev)
    rnd, dense, ln, perm = inp.rnd, inp.dense, inp.ln, inp.perm
    bf = torch.bfloat16

    # K1 at the flagship's product shapes (M, K, N, gelu, residual, indices);
    # library: F.linear (cuBLAS), the product alone
    for M, Kd, N, gelu, res, idx in [
            (25088, 96, 288, False, False, False),   # stage-1 qkv
            (25088, 384, 96, False, True, True),     # stage-1 SW-MSA fc2
            (1568, 384, 1536, True, False, False),   # stage-3 fc1
            (392, 768, 2304, False, False, False),   # stage-4 qkv
            (592, 768, 3072, True, False, False),    # BERT fc1
            (592, 3072, 768, False, True, False)]:   # BERT fc2
        a, (w, b) = rnd(M, Kd), dense(Kd, N)
        r = rnd(M, N) if res else None
        ri, si = (perm(M), perm(M)) if idx else (None, None)
        kw = dict(gelu=gelu, residual=r, residual_index=ri, store_index=si)
        out = torch.empty(M, N, dtype=bf, device=dev)
        chk.case("gemm", lambda: K.gemm(a, w, b, **kw),
                 lambda: K.gemm_plain(a, w, b, **kw), KERNEL_BAR,
                 library_fn=lambda: F.linear(a, w, b),
                 flops=2.0 * M * N * Kd,
                 nbytes=nbytes(a, w, b, r, ri, si, out))

    # K2: Swin windows (shift patterns per window at stages 1-3), BERT rows;
    # library: SDPA with the bias expanded to a bf16 float mask
    for G, N, C, nH, P, padded in [(512, 49, 96, 3, 64, False),
                                   (32, 49, 384, 12, 4, False),
                                   (8, 49, 768, 24, 1, False),
                                   (8, 74, 768, 12, 0, True)]:
        qkv = rnd(G * N, 3 * C)
        pat = rnd(P, nH, N, N, dtype=torch.float32) if P else None
        kb = None
        if padded:
            kb = torch.where(torch.rand(G, N, generator=inp.gen) < 0.2,
                             -10000.0, 0.0).to(dev)
        mask = (pat.to(bf)[torch.arange(G, device=dev) % P] if P
                else kb.to(bf)[:, None, None, :])
        sc = (C // nH) ** -0.5
        ctx = torch.empty(G * N, C, dtype=bf, device=dev)
        chk.case("biased_attention",
                 lambda: K.biased_attention(qkv, nH, N, sc, pat, kb),
                 lambda: K.biased_attention_plain(qkv, nH, N, sc, pat, kb),
                 KERNEL_BAR,
                 library_fn=lambda: lib_attention(qkv, G, N, nH, mask, sc),
                 flops=4.0 * G * nH * N * N * (C // nH),
                 nbytes=nbytes(qkv, pat, kb, ctx), graph=True)

    # K3: stage-1 LN1 with the shift gather, stage-3 merge norm, BERT LN;
    # library: F.layer_norm (bf16 gamma / beta), without the gather
    for M, C, idx, eps in [(25088, 96, True, 1e-5), (392, 1536, False, 1e-5),
                           (592, 768, False, 1e-12)]:
        x = rnd(M, C, std=2.0) + 0.5
        g, b = ln(C)
        gb, bb = bf16_ln(g, b)
        ri = perm(M) if idx else None
        chk.case("layernorm", lambda: K.layernorm(x, g, b, eps, ri),
                 lambda: K.layernorm_plain(x, g, b, eps, ri), KERNEL_BAR,
                 library_fn=lambda: F.layer_norm(x, (C,), gb, bb, eps),
                 flops=8.0 * M * C, nbytes=nbytes(x, g, b, ri, x), graph=True)

    # the six counterparts at stages 1-3 / stage 4 / BERT, batch 8
    for res, C, nH in [(56, 96, 3), (28, 192, 6), (14, 384, 12)]:
        N, nW = 49, (res // 7) ** 2
        BW = 8 * nW
        x = rnd(BW, N, C)
        params = (*ln(C), *dense(C, 3 * C), *dense(C, C), *ln(C),
                  *dense(C, 4 * C), *dense(4 * C, C))
        lparams = (*bf16_ln(*params[0:2]), *params[2:6],
                   *bf16_ln(*params[6:8]), *params[8:])
        rel = rnd(1, nH, N, N, dtype=torch.float32)
        mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3), device=dev)
        shifted = (rel + mask[:, None]).contiguous()
        sc = (C // nH) ** -0.5
        cost = dict(flops=2.0 * BW * N * C * 12 * C
                    + 4.0 * BW * nH * N * N * (C // nH),
                    nbytes=nbytes(x, *params, x))
        chk.case("swin_full_block",
                 lambda: blocks.swin_full_block(x, params, rel, sc, nH),
                 lambda: blocks.swin_full_block_plain(x, params, rel, sc, nH),
                 BLOCK_BAR,
                 library_fn=lambda: lib_swin_block(x, lparams, rel.to(bf), sc,
                                                   nH),
                 nbytes=cost["nbytes"] + nbytes(rel), flops=cost["flops"])
        spec = (res, res, 7, 3)
        gather = blocks._shift_index(8, res, res, 7, 3, dev).long()
        scatter = torch.argsort(gather)
        smask = shifted.to(bf)[torch.arange(BW, device=dev) % nW]
        chk.case("swin_full_block_shift",
                 lambda: blocks.swin_full_block(x, params, shifted, sc, nH,
                                                shift_spec=spec),
                 lambda: blocks.swin_full_block_plain(x, params, shifted, sc,
                                                      nH, shift_spec=spec),
                 BLOCK_BAR,
                 library_fn=lambda: lib_swin_block(x, lparams, smask, sc, nH,
                                                   gather, scatter),
                 nbytes=cost["nbytes"] + nbytes(shifted, gather),
                 flops=cost["flops"])

    C, nH = 768, 24
    x, h = rnd(8, 49, C), rnd(8, 49, C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    rel = rnd(1, nH, 49, 49, dtype=torch.float32)
    sc = (C // nH) ** -0.5

    def lib_window(h, x):
        rows = h.reshape(-1, C)
        ctx = lib_attention(F.linear(rows, wq, bq), 8, 49, nH, rel.to(bf), sc)
        return (F.linear(ctx, wp, bp) + x.reshape(-1, C)).view(8, 49, C)

    chk.case("window_block_attention",
             lambda: blocks.window_block_attention(h, wq, bq, wp, bp, rel, sc,
                                                   nH, residual=x),
             lambda: blocks.window_block_attention_plain(
                 h, wq, bq, wp, bp, rel, sc, nH, residual=x), BLOCK_BAR,
             library_fn=lambda: lib_window(h, x),
             flops=2.0 * 392 * C * 4 * C + 4.0 * 8 * nH * 49 * 49 * (C // nH),
             nbytes=nbytes(h, x, wq, bq, wp, bp, rel, x))
    mlp = (*ln(C), *dense(C, 4 * C), *dense(4 * C, C))
    lmlp = (*bf16_ln(*mlp[:2]), *mlp[2:])

    def lib_preln(x, lns, lnb, w1, b1, w2, b2):
        rows = x.reshape(-1, C)
        hh = F.layer_norm(rows, (C,), lns, lnb, 1e-5)
        return (F.linear(F.gelu(F.linear(hh, w1, b1)), w2, b2) + rows).view(
            x.shape)

    chk.case("fused_mlp_preln", lambda: blocks.fused_mlp_preln(x, *mlp),
             lambda: blocks.fused_mlp_preln_plain(x, *mlp), BLOCK_BAR,
             library_fn=lambda: lib_preln(x, *lmlp),
             flops=2.0 * 392 * C * 8 * C, nbytes=nbytes(x, *mlp, x))

    C, nH, S = 768, 12, 74
    x = rnd(8, S, C)
    kb = inp.key_bias([74, 70, 60, 55, 74, 53, 66, 58], S)
    attn = (*dense(C, 3 * C), *dense(C, C), kb, *ln(C), (C // nH) ** -0.5,
            nH, 1e-12)
    lattn = (*attn[:4], kb.to(bf)[:, None, None, :], *bf16_ln(*attn[5:7]),
             *attn[7:9])
    chk.case("fused_attn_ln", lambda: blocks.fused_attn_ln(x, *attn),
             lambda: blocks.fused_attn_ln_plain(x, *attn), BLOCK_BAR,
             library_fn=lambda: lib_attn_ln(x, *lattn),
             flops=2.0 * 8 * S * C * 4 * C + 4.0 * 8 * nH * S * S * (C // nH),
             nbytes=nbytes(x, *attn[:7], x))
    bert_mlp = (*dense(C, 4 * C), *dense(4 * C, C), *ln(C), 1e-12)
    lbert = (*bert_mlp[:4], *bf16_ln(*bert_mlp[4:6]))
    chk.case("fused_mlp_ln", lambda: blocks.fused_mlp_ln(x, *bert_mlp),
             lambda: blocks.fused_mlp_ln_plain(x, *bert_mlp), BLOCK_BAR,
             library_fn=lambda: lib_mlp_ln(x, *lbert),
             flops=2.0 * 8 * S * C * 8 * C, nbytes=nbytes(x, *bert_mlp[:6], x))


def train_kernel_checks(chk: Checker, dev) -> None:
    """K1's backward modes, K4, K5 and the two backward counterparts at the
    VQA train step's shapes: B*S = 32*74 = 2368 rows, C 768, I 3072, 12
    heads, a padded key bias."""
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    inp = Inputs(dev, seed=1)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, S, C, I, nH = TRAIN_BATCH, 74, 768, 3072, 12
    M = B * S
    x, dy = rnd(M, C), rnd(M, C, std=0.1)
    (w1, b1), (w2, b2) = dense(C, I), dense(I, C)
    a1 = rnd(M, I, dtype=f32)
    m = rnd(M, I)
    dres = rnd(M, C, std=0.1, dtype=f32)
    dI = rnd(M, I, std=0.1)
    dqkv = rnd(M, 3 * C, std=0.1)

    def out(*shape, dtype=bf):
        return torch.empty(*shape, dtype=dtype, device=dev)

    # K1 backward modes (bar relative to max|plain| per output, floor 1)
    cases = [
        # fc1 recompute: GELU out + the saved f32 pre-activation
        (dict(a=x, w=w1, b=b1, gelu=True, save_preact=True),
         lambda: F.linear(x, w1, b1), (M, C, I), (x, w1, b1, out(M, I),
                                                  out(M, I, dtype=f32))),
        # dctx = da @ Wproj (nn)
        (dict(a=dy, w=w2[:, :C].contiguous(), layout="nn"), None, (M, C, C),
         None),
        # da1 = dmlp @ W2 * gelu'(a1) (nn, GELU' epilogue)
        (dict(a=dy, w=w2, layout="nn", gelu_grad=a1),
         lambda: torch.matmul(dy, w2), (M, C, I), (dy, w2, a1, out(M, I))),
        # dx = da1 @ W1 + dres (nn, f32 residual, f32 out)
        (dict(a=dI, w=w1, layout="nn", residual=dres, out_dtype=f32),
         lambda: torch.matmul(dI, w1), (M, I, C),
         (dI, w1, dres, out(M, C, dtype=f32))),
        # dW2 = dmlp^T m (tn, f32 out)
        (dict(a=dy, w=m, layout="tn", out_dtype=f32),
         lambda: torch.matmul(dy.t(), m), (C, M, I),
         (dy, m, out(C, I, dtype=f32))),
        # dW1 = da1^T x (tn, f32 out)
        (dict(a=dI, w=x, layout="tn", out_dtype=f32),
         lambda: torch.matmul(dI.t(), x), (I, M, C),
         (dI, x, out(I, C, dtype=f32))),
        # dWqkv = dqkv^T x (tn, f32 out)
        (dict(a=dqkv, w=x, layout="tn", out_dtype=f32),
         lambda: torch.matmul(dqkv.t(), x), (3 * C, M, C),
         (dqkv, x, out(3 * C, C, dtype=f32))),
    ]
    for kw, lib, (mm, kk, nn_), io in cases:
        kw = dict(kw)
        a, w, b = kw.pop("a"), kw.pop("w"), kw.pop("b", None)
        if lib is None:                      # dctx: (M, C) @ (C, C)
            lib = lambda a=a, w=w: torch.matmul(a, w)  # noqa: E731
            io = (a, w, out(mm, nn_))
        chk.case("gemm", lambda a=a, w=w, b=b, kw=kw: K.gemm(a, w, b, **kw),
                 lambda a=a, w=w, b=b, kw=kw: K.gemm_plain(a, w, b, **kw),
                 KERNEL_BAR, library_fn=lib, flops=2.0 * mm * kk * nn_,
                 nbytes=nbytes(*io))

    # K4 and its counterpart: the attention core VJP at S = 74, 12 heads
    lengths = [74 - (7 * i) % 30 for i in range(B)]
    kb = inp.key_bias(lengths, S)
    qkv = rnd(M, 3 * C, std=0.5)
    dctx = rnd(M, C)
    sc = (C // nH) ** -0.5
    Dh = C // nH
    t = qkv.view(B, S, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    lib_k4 = library_backward(
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=kb.to(bf)[:, None, None, :], scale=sc),
        (t[0].contiguous(), t[1].contiguous(), t[2].contiguous()),
        dctx.view(B, S, nH, Dh).permute(0, 2, 1, 3).contiguous())
    k4_cost = dict(flops=10.0 * B * nH * S * S * Dh,
                   nbytes=nbytes(qkv, dctx, kb, qkv, kb))
    chk.case("biased_attention_bwd",
             lambda: K.biased_attention_bwd(qkv, dctx, nH, S, sc, kb),
             lambda: K.biased_attention_bwd_plain(qkv, dctx, nH, S, sc, kb),
             KERNEL_BAR, library_fn=lib_k4, floor=1e-6, graph=True,
             **k4_cost)
    q3, d3 = qkv.view(B, S, 3 * C), dctx.view(B, S, C)
    chk.case("seq_attention_core_bwd",
             lambda: blocks.seq_attention_core_bwd(q3, d3, kb, None, None, sc,
                                                   nH),
             lambda: blocks.seq_attention_core_bwd_plain(q3, d3, kb, None,
                                                         None, sc, nH),
             KERNEL_BAR, library_fn=lib_k4, floor=1e-6, **k4_cost)

    # K5: LN VJP from the f32 pre-LN sum; the column sum over (M, I)
    res = rnd(M, C, std=2.0, dtype=f32) + 0.3
    lns, lnb = ln(C)
    g = rnd(M, C)

    def lib_ln_bwd_forward(r, s, b):
        return F.layer_norm(r, (C,), s, b, 1e-12)

    ln_grads = library_backward(lib_ln_bwd_forward, (res, lns, lnb), g.float())

    def lib_k5():
        dr, ds, db = ln_grads()
        return dr, dr.sum(0)

    lib_k5.stream = ln_grads.stream      # graph_ms captures autograd there

    chk.case("layernorm_bwd", lambda: K.layernorm_bwd(res, lns, g, 1e-12),
             lambda: K.layernorm_bwd_plain(res, lns, g, 1e-12), KERNEL_BAR,
             library_fn=lib_k5, floor=1e-6, flops=12.0 * M * C,
             nbytes=nbytes(res, lns, g, res, g) + 12 * C, graph=True)
    chk.case("column_sum", lambda: K.column_sum(dI),
             lambda: K.column_sum_plain(dI), KERNEL_BAR, floor=1e-6,
             library_fn=lambda: torch.sum(dI, 0, dtype=f32),
             flops=1.0 * M * I, nbytes=nbytes(dI) + 4 * I, graph=True)

    # the MLP-half VJP at the train shapes; library: the autograd backward
    # of the same forward built from F.linear / F.gelu / F.layer_norm in bf16
    xr = rnd(M, C)
    w1m, b1m = dense(C, I)
    w2m, b2m = dense(I, C)
    with torch.no_grad():
        mm_ = F.gelu(F.linear(xr.float(), w1m.float(), b1m.float()))
        res2 = (F.linear(mm_.to(bf).float(), w2m.float(), b2m.float())
                + xr.float()).contiguous()
    lib_mlp = library_backward(
        lambda xx, a, b, c, d: lib_mlp_ln(xx, a, b, c, d, lns.to(bf),
                                          lnb.to(bf)),
        (xr, w1m, b1m, w2m, b2m), g)
    chk.case("mlp_ln_half_bwd",
             lambda: blocks.mlp_ln_half_bwd(xr, res2, g, None, w1m, b1m, w2m,
                                            lns),
             lambda: blocks.mlp_ln_half_bwd_plain(xr, res2, g, None, w1m, b1m,
                                                  w2m, lns),
             BLOCK_BAR, library_fn=lib_mlp, floor=1e-6,
             flops=5 * 2.0 * M * C * I,
             nbytes=nbytes(xr, res2, g, w1m, b1m, w2m, lns) + 4 * (
                 M * C + 2 * C * I + I + 3 * C))


def lib_masked_attention(qkv, G, N, nH, bias, amask, scale):
    """bf16 matmul / softmax / mul / matmul over fused rows; ``bias``
    broadcastable to (G, nH, N, N). SDPA takes no probability mask."""
    C = qkv.shape[1] // 3
    t = qkv.view(G, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    s = torch.matmul(t[0], t[1].transpose(-1, -2)) * scale + bias
    p = torch.softmax(s, dim=-1) * amask
    return torch.matmul(p, t[2]).permute(0, 2, 1, 3).reshape(G * N, C)


def pretrain_kernel_checks(chk: Checker, dev) -> None:
    """The mask options at the pretrain step's shapes: B*S = 32*131 = 4192
    rows, C 768, I 3072, 12 heads; a seq2seq qbias, a key-padding bias, and
    dropout masks of 0 or 1/0.9 in bf16."""
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask

    # the wrappers' shared-memory reckoning is the compiled one: K2's and
    # K4's tile plans for every N through the register form's cap and well
    # into the long form, and at the long form's cap and one past it (-1:
    # not taken), at every head dim the plans take and one they refuse, K4
    # in both modes (pattern mode: -1 past N = 288) and with its scratch
    libs = K.build()
    bwd = libs["attention_bwd"]
    sweep = [*range(1, 2 * K.ATTENTION_MAX_N + 1), K.ATTENTION_LONG_MAX_N,
             K.ATTENTION_LONG_MAX_N + 1]
    for Dh in (16, 24, 32, 48, 64):
        for n in sweep:
            for amask in (False, True):
                assert K.attention_smem_bytes(n, Dh, amask) == \
                    libs["attention"].mvlt_attention_smem(n, Dh, amask), \
                    (n, Dh, amask)
            for flags in range(4):       # K4: pattern, amask
                assert K.attention_bwd_smem_bytes(
                    n, Dh, bool(flags & 1), bool(flags & 2)) == \
                    bwd.mvlt_attention_bwd_smem(n, Dh, flags), (n, Dh, flags)
            try:
                words = K.attention_bwd_plan(n, Dh).scratch_words
            except ValueError:
                words = -1
            assert words == bwd.mvlt_attention_bwd_scratch(n, Dh), (n, Dh)
    assert K.attention_smem_bytes(K.ATTENTION_LONG_MAX_N + 1, 64) == -1
    assert K.attention_bwd_smem_bytes(K.ATTENTION_MAX_N + 1, 64, True) == -1
    optin = K.smem_optin(dev)
    top = K.max_attention_n(64, optin, amask=True)
    long_n = K.ATTENTION_MAX_N + 1
    print(f"shared memory per block (opt-in): {optin} bytes; K2 admits N <= "
          f"{top} at head dim 64 ({K.attention_smem_bytes(top, 64, True)} "
          f"bytes a block with an amask; the register form "
          f"{K.attention_smem_bytes(K.ATTENTION_MAX_N, 64, True)} at N = "
          f"{K.ATTENTION_MAX_N}), its window modes N <= "
          f"{K.max_attention_n(64, optin, window=True)}; K4 N <= "
          f"{K.max_attention_n(64, optin, backward=True)} in pattern mode "
          f"({K.attention_bwd_smem_bytes(K.ATTENTION_MAX_N, 64, True)} bytes "
          f"a block), the long form "
          f"{K.attention_bwd_smem_bytes(long_n, 64, False, True)} bytes; "
          f"the plans in C and Python agree for N = 1 .. "
          f"{2 * K.ATTENTION_MAX_N}, {K.ATTENTION_LONG_MAX_N} and "
          f"{K.ATTENTION_LONG_MAX_N + 1} at head dims 16, 24, 32, 48, 64",
          flush=True)

    inp = Inputs(dev, seed=2)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, S, C, I, nH = TRAIN_BATCH, 1 + 49 + 1 + PRETRAIN_TEXT, 768, 3072, 12
    M, Dh = B * S, C // nH
    sc = Dh ** -0.5

    def keep_mask(*shape):
        return ((torch.rand(*shape, generator=inp.gen) < 0.9).to(bf)
                / 0.9).to(dev)

    lengths = [S - (11 * i) % 75 for i in range(B)]
    kb = inp.key_bias(lengths, S)
    qb = mask_to_bias(seq2seq_fusion_mask(B, 50, S, dev)).contiguous()
    amask, hmask = keep_mask(B, nH, S, S), keep_mask(M, C)
    qkv = rnd(M, 3 * C, std=0.5)
    dctx = rnd(M, C)
    x = rnd(M, C)

    # K2 with amask, in both mask modes
    for kbias, qbias in ((kb, None), (None, qb)):
        bias = (kb.to(bf)[:, None, None, :] if qbias is None
                else qb.to(bf)[:, None])
        chk.case("biased_attention",
                 lambda: K.biased_attention(qkv, nH, S, sc, None, kbias,
                                            qbias, amask),
                 lambda: K.biased_attention_plain(qkv, nH, S, sc, None, kbias,
                                                  qbias, amask),
                 KERNEL_BAR,
                 library_fn=lambda: lib_masked_attention(qkv, B, S, nH, bias,
                                                         amask, sc),
                 flops=4.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(qkv, kbias, qbias, amask, dctx), graph=True)

    # K4 with qbias / amask at N = 131, and at N = 128 (the largest N the
    # earlier layout claimed and could not launch)
    q4 = qkv.view(B, S, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    d4 = dctx.view(B, S, nH, Dh).permute(0, 2, 1, 3).contiguous()
    for kbias, qbias in ((kb, None), (None, qb)):
        bias = (kb.to(bf)[:, None, None, :] if qbias is None
                else qb.to(bf)[:, None])
        lib = library_backward(
            lambda q, k, v, bias=bias: torch.matmul(
                torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * sc
                              + bias, dim=-1) * amask, v),
            (q4[0].contiguous(), q4[1].contiguous(), q4[2].contiguous()), d4)
        cost = dict(flops=10.0 * B * nH * S * S * Dh,
                    nbytes=nbytes(qkv, dctx, kbias, qbias, amask, qkv, kb))
        chk.case("biased_attention_bwd",
                 lambda kbias=kbias, qbias=qbias: K.biased_attention_bwd(
                     qkv, dctx, nH, S, sc, kbias, qbias, amask),
                 lambda kbias=kbias, qbias=qbias: K.biased_attention_bwd_plain(
                     qkv, dctx, nH, S, sc, kbias, qbias, amask),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, graph=True, **cost)
        q3, d3 = qkv.view(B, S, 3 * C), dctx.view(B, S, C)
        chk.case("seq_attention_core_bwd",
                 lambda kbias=kbias, qbias=qbias: blocks.seq_attention_core_bwd(
                     q3, d3, kbias, qbias, amask, sc, nH),
                 lambda kbias=kbias, qbias=qbias:
                 blocks.seq_attention_core_bwd_plain(q3, d3, kbias, qbias,
                                                     amask, sc, nH),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
    N8 = 128
    q8, c8 = rnd(B * N8, 3 * C, std=0.5), rnd(B * N8, C)
    kb8 = inp.key_bias([N8 - (5 * i) % 40 for i in range(B)], N8)
    t8 = q8.view(B, N8, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    chk.case("biased_attention_bwd",
             lambda: K.biased_attention_bwd(q8, c8, nH, N8, sc, kb8),
             lambda: K.biased_attention_bwd_plain(q8, c8, nH, N8, sc, kb8),
             KERNEL_BAR, floor=1e-6,
             library_fn=library_backward(
                 lambda q, k, v: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=kb8.to(bf)[:, None, None, :],
                     scale=sc),
                 (t8[0].contiguous(), t8[1].contiguous(), t8[2].contiguous()),
                 c8.view(B, N8, nH, Dh).permute(0, 2, 1, 3).contiguous()),
             flops=10.0 * B * nH * N8 * N8 * Dh,
             nbytes=nbytes(q8, c8, kb8, q8, kb8), graph=True)

    # K1's epilogue multiplier: proj (+x, f32 out) and fc2 (+x, f32 out)
    for Kd in (C, I):
        a, (w, b) = rnd(M, Kd), dense(Kd, C)
        chk.case("gemm",
                 lambda a=a, w=w, b=b: K.gemm(a, w, b, residual=x, emask=hmask,
                                              out_dtype=f32),
                 lambda a=a, w=w, b=b: K.gemm_plain(a, w, b, residual=x,
                                                    emask=hmask, out_dtype=f32),
                 KERNEL_BAR,
                 library_fn=lambda a=a, w=w, b=b: F.linear(a, w, b) * hmask + x,
                 flops=2.0 * M * Kd * C,
                 nbytes=nbytes(a, w, b, x, hmask) + 4 * M * C)

    # K5 with hmask
    res = rnd(M, C, std=2.0, dtype=f32) + 0.3
    lns, lnb = ln(C)
    g = rnd(M, C)
    ln_grads = library_backward(
        lambda r, s_, b_: F.layer_norm(r, (C,), s_, b_, 1e-12), (res, lns, lnb),
        g.float())

    def lib_k5():
        dr = ln_grads()[0]
        da = dr * hmask
        return dr, da, da.sum(0)

    lib_k5.stream = ln_grads.stream

    chk.case("layernorm_bwd",
             lambda: K.layernorm_bwd(res, lns, g, 1e-12, hmask=hmask),
             lambda: K.layernorm_bwd_plain(res, lns, g, 1e-12, hmask=hmask),
             KERNEL_BAR, library_fn=lib_k5, floor=1e-6, flops=14.0 * M * C,
             nbytes=nbytes(res, lns, g, hmask, res, g) + 12 * C, graph=True)

    # the masked forward counterparts (B, S, C); library: F.linear, the
    # masked attention above, F.layer_norm, in bf16
    x3, h3 = x.view(B, S, C), hmask.view(B, S, C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    lns2, lnb2 = ln(C)
    lgb = bf16_ln(lns2, lnb2)
    for kbias, qbias in ((kb, None), (None, qb)):
        bias = (kb.to(bf)[:, None, None, :] if qbias is None
                else qb.to(bf)[:, None])
        args = (x3, wq, bq, wp, bp, kbias, qbias, amask, h3, lns2, lnb2, sc,
                nH, 1e-12)

        def lib_attn(bias=bias):
            ctx = lib_masked_attention(F.linear(x, wq, bq), B, S, nH, bias,
                                       amask, sc)
            return F.layer_norm(F.linear(ctx, wp, bp) * hmask + x, (C,),
                                *lgb, 1e-12).view(B, S, C)

        chk.case("fused_attn_ln_masked",
                 lambda args=args: blocks.fused_attn_ln_masked(*args),
                 lambda args=args: blocks.fused_attn_ln_masked_plain(*args),
                 BLOCK_BAR, library_fn=lib_attn,
                 flops=2.0 * M * C * 4 * C + 4.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(x, wq, bq, wp, bp, kbias, qbias, amask, hmask,
                               lns2, lnb2, x))
    (w1, b1), (w2, b2) = dense(C, I), dense(I, C)
    mlp = (x3, w1, b1, w2, b2, h3, lns2, lnb2, 1e-12)

    def lib_mlp(xx=x, h=hmask):
        y = F.linear(F.gelu(F.linear(xx, w1, b1)), w2, b2) * h + xx
        return F.layer_norm(y, (C,), *lgb, 1e-12).view(B, S, C)

    chk.case("fused_mlp_ln_masked", lambda: blocks.fused_mlp_ln_masked(*mlp),
             lambda: blocks.fused_mlp_ln_masked_plain(*mlp), BLOCK_BAR,
             library_fn=lib_mlp, flops=2.0 * M * C * 2 * I,
             nbytes=nbytes(x, w1, b1, w2, b2, hmask, lns2, lnb2, x))

    # the MLP-half VJP with hmask; library: the autograd backward of lib_mlp
    with torch.no_grad():
        mm_ = F.gelu(F.linear(x.float(), w1.float(), b1.float()))
        res2 = (F.linear(mm_.to(bf).float(), w2.float(), b2.float())
                * hmask.float() + x.float()).contiguous()
    lib_bwd = library_backward(
        lambda xx, a_, b_, c_, d_: (F.layer_norm(
            F.linear(F.gelu(F.linear(xx, a_, b_)), c_, d_) * hmask + xx, (C,),
            *lgb, 1e-12)), (x, w1, b1, w2, b2), g)
    chk.case("mlp_ln_half_bwd",
             lambda: blocks.mlp_ln_half_bwd(x, res2, g, hmask, w1, b1, w2,
                                            lns2),
             lambda: blocks.mlp_ln_half_bwd_plain(x, res2, g, hmask, w1, b1,
                                                  w2, lns2),
             BLOCK_BAR, library_fn=lib_bwd, floor=1e-6,
             flops=5 * 2.0 * M * C * I,
             nbytes=nbytes(x, res2, g, hmask, w1, b1, w2, lns2) + 4 * (
                 M * C + 2 * C * I + I + 3 * C))


# Swin-S @224 stages: (map side, C, heads); 49-token windows, head dim 32
SWIN_STAGES = [(56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24)]


def _swin_dp(inp, dev, B: int, keep: float = 0.7):
    """A (B,) f32 DropPath multiplier, 0 or 1/keep, image 0 dropped."""
    m = (torch.rand(B, generator=inp.gen) < keep).float()
    m[0] = 0.0
    return (m * float(torch.tensor(1.0) / torch.tensor(keep))).to(dev)


def check_block_grads(fn, fn_plain, x, params, bias, cotangent, what: str,
                      **kw) -> None:
    """One Swin training block, forward and backward through its autograd
    Function, kernels vs plain on the same inputs: the output, dx, every
    parameter grad and the pattern grad within BLOCK_BAR x max|plain| (floor
    1e-6). Not timed: its pieces are."""
    outs = []
    for f in (fn, fn_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (x, bias, *params)]
        y = f(leaves[0], leaves[2:], leaves[1], **kw)
        y.backward(cotangent)
        outs.append([y.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(*outs)):
        assert torch.isfinite(g).all(), f"{what}: non-finite output {i}"
        err = (g.float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 1e-6)
        if not err <= BLOCK_BAR * scale:
            raise AssertionError(f"{what}: forward/backward output {i} max abs "
                                 f"err {err} > {BLOCK_BAR} x {scale}")
        worst = max(worst, err / scale)
    print(f"check {what} forward + backward: worst max abs err "
          f"{worst:.3g} x max|plain| over {len(outs[0])} outputs", flush=True)


def swin_kernel_checks(chk: Checker, dev) -> None:
    """The Swin training slice at the Swin-S b32 shapes of each stage (M =
    32 * H * W rows): K1's row scale, K4's pattern mode (one pattern, and
    one per window at the shifted stages; two calls bitwise equal), K5's
    pre-LN form and the scaled column sum, and the training counterparts:
    the whole / half block's forward, the three backward pieces, and each
    block forward + backward through its autograd Function, shifted and
    unshifted, with DropPath multipliers that zero some images."""
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    inp = Inputs(dev, seed=3)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, N = TRAIN_BATCH, 49
    for res, C, nH in SWIN_STAGES:
        nW = (res // 7) ** 2
        BW, I, Dh = B * nW, 4 * C, C // nH
        M, sc, shifted = BW * N, Dh ** -0.5, nW > 1
        rows = M // B
        dp1, dp2 = _swin_dp(inp, dev, B), _swin_dp(inp, dev, B)
        r1, r2 = (d.repeat_interleave(rows)[:, None] for d in (dp1, dp2))
        x = rnd(M, C)
        (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
        (w1, b1), (w2, b2) = dense(C, I), dense(I, C)
        ln1, ln2 = ln(C), ln(C)
        params = (*ln1, wq, bq, wp, bp, *ln2, w1, b1, w2, b2)
        lparams = (*bf16_ln(*ln1), wq, bq, wp, bp, *bf16_ln(*ln2), w1, b1, w2,
                   b2)
        rel = rnd(1, nH, N, N, std=0.5, dtype=f32)
        patterns = [rel]
        if shifted:
            mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3),
                                   device=dev)
            patterns.append((rel + mask[:, None]).contiguous())
        tag = f"stage {C}"

        # K1 with the row scale: proj (+x, f32 res1) and fc2 (+res1, scatter)
        ctx, m, res1 = rnd(M, C), rnd(M, I), rnd(M, C, std=2.0, dtype=f32)
        si = blocks._shift_index(B, res, res, 7, 3, dev) if shifted else None
        for a, w, b, kw, lib in (
                (ctx, wp, bp, dict(residual=x, row_scale=dp1, out_dtype=f32),
                 lambda: F.linear(ctx, wp, bp) * r1 + x),
                (m, w2, b2, dict(residual=res1, row_scale=dp2, store_index=si),
                 lambda: F.linear(m, w2, b2) * r2 + res1)):
            out = torch.empty(M, C, dtype=kw.get("out_dtype", bf), device=dev)
            chk.case("gemm", lambda a=a, w=w, b=b, kw=kw: K.gemm(a, w, b, **kw),
                     lambda a=a, w=w, b=b, kw=kw: K.gemm_plain(a, w, b, **kw),
                     KERNEL_BAR, library_fn=lib,
                     flops=2.0 * M * a.shape[1] * C,
                     nbytes=nbytes(a, w, b, kw["residual"], kw["row_scale"],
                                   kw.get("store_index"), out))

        # K4 in pattern mode and attention_core_bwd, P = 1 and P = nW;
        # library: the autograd backward of the bf16 composition with the
        # patterns gathered per window
        qkv, dctx = rnd(M, 3 * C, std=0.5), rnd(M, C)
        t = qkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4)
        for pat in patterns:
            P = pat.shape[0]
            lib = library_backward(
                lambda q, k, v, pat=pat: torch.matmul(torch.softmax(
                    torch.matmul(q, k.transpose(-1, -2)) * sc + pat.to(bf)[
                        torch.arange(BW, device=dev) % P], dim=-1), v),
                (t[0].contiguous(), t[1].contiguous(), t[2].contiguous()),
                dctx.view(BW, N, nH, Dh).permute(0, 2, 1, 3).contiguous())
            cost = dict(flops=10.0 * BW * nH * N * N * Dh,
                        nbytes=nbytes(qkv, dctx, pat, qkv, pat))
            chk.case("biased_attention_bwd",
                     lambda pat=pat: K.biased_attention_bwd(
                         qkv, dctx, nH, N, sc, pattern=pat),
                     lambda pat=pat: K.biased_attention_bwd_plain(
                         qkv, dctx, nH, N, sc, pattern=pat),
                     KERNEL_BAR, library_fn=lib, floor=1e-6, graph=True,
                     **cost)
            chk.case("attention_core_bwd",
                     lambda pat=pat: blocks.attention_core_bwd(qkv, dctx, pat,
                                                               N, sc, nH),
                     lambda pat=pat: blocks.attention_core_bwd_plain(
                         qkv, dctx, pat, N, sc, nH),
                     KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
            one = K.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat)
            two = K.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat)
            torch.cuda.synchronize()
            if not (torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])):
                raise AssertionError(f"K4 pattern mode ({tag}, P = {P}) is not "
                                     "bitwise reproducible")
        print(f"K4 pattern mode at {tag}: two calls bitwise equal for P = "
              f"{[p.shape[0] for p in patterns]}", flush=True)

        # K5 in pre-LN form: the MLP half's (f32 res1, f32 dh2, the block's
        # bf16 cotangent as the incoming residual, da scaled by dp1) and the
        # qkv tail's (bf16 x, f32 dh1, f32 dres1); the scaled column sum
        gb, dh = rnd(M, C), rnd(M, C, dtype=f32)
        for r_, (gam, beta), gres, rs in ((res1, ln2, gb, dp1),
                                          (x, ln1, res1, None)):
            ln_grads = library_backward(
                lambda a_, s_, b_: F.layer_norm(a_, (C,), s_, b_, 1e-5),
                (r_.float(), gam, beta), dh)

            def lib_k5(ln_grads=ln_grads, gres=gres, rs=rs):
                dr = ln_grads()[0] + gres
                da = dr if rs is None else dr * r1
                return dr, da, da.sum(0)

            lib_k5.stream = ln_grads.stream

            kw = dict(gres=gres, row_scale=rs, out_dtype=bf)
            chk.case("layernorm_bwd",
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd(
                         r_, gam, dh, 1e-5, **kw),
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd_plain(
                         r_, gam, dh, 1e-5, **kw),
                     KERNEL_BAR, library_fn=lib_k5, floor=1e-6,
                     flops=16.0 * M * C,
                     nbytes=nbytes(r_, gam, dh, gres, rs) + 6 * M * C + 12 * C,
                     graph=True)
        chk.case("column_sum", lambda: K.column_sum(gb, row_scale=dp2),
                 lambda: K.column_sum_plain(gb, row_scale=dp2), KERNEL_BAR,
                 floor=1e-6, library_fn=lambda: (gb.float() * r2).sum(0),
                 flops=2.0 * M * C, nbytes=nbytes(gb, dp2, gb) + 4 * C,
                 graph=True)

        # the backward pieces; library: autograd backwards of the bf16
        # F.layer_norm / F.linear / F.gelu compositions they differentiate
        g = rnd(M, C)
        lib_mlp = library_backward(
            lambda r_, a_, b_, c_, d_, s_, e_: r_ + F.linear(F.gelu(F.linear(
                F.layer_norm(r_, (C,), s_, e_, 1e-5), a_, b_)), c_, d_) * r2,
            (res1.to(bf), w1, b1, w2, b2, *bf16_ln(*ln2)), g)
        dp = (dp1, dp2)
        chk.case("swin_mlp_half_bwd",
                 lambda: blocks.swin_mlp_half_bwd(x, ctx, g, wp, bp, *ln2, w1,
                                                  b1, w2, dp),
                 lambda: blocks.swin_mlp_half_bwd_plain(x, ctx, g, wp, bp,
                                                        *ln2, w1, b1, w2, dp),
                 BLOCK_BAR, library_fn=lib_mlp, floor=1e-6,
                 flops=42.0 * M * C * C,
                 nbytes=nbytes(x, ctx, g, wp, bp, *ln2, w1, b1, w2, dp1, dp2)
                 + 6 * M * C + 4 * (2 * C * I + C * C + I + 4 * C))
        dq = rnd(M, 3 * C, std=0.1)
        lib_tail = library_backward(
            lambda a_, w_, b_, s_, e_: F.linear(
                F.layer_norm(a_, (C,), s_, e_, 1e-5), w_, b_),
            (x, wq, bq, *bf16_ln(*ln1)), dq)
        chk.case("swin_qkv_tail_bwd",
                 lambda: blocks.swin_qkv_tail_bwd(x, dq, res1, wq, *ln1),
                 lambda: blocks.swin_qkv_tail_bwd_plain(x, dq, res1, wq,
                                                        *ln1),
                 BLOCK_BAR, library_fn=lib_tail, floor=1e-6,
                 flops=12.0 * M * C * C,
                 nbytes=nbytes(x, dq, res1, wq, *ln1) + 2 * M * C
                 + 4 * (3 * C * C + 5 * C))

        # the block forward (no grad: the training form, from its dp) and the
        # block forward + backward, on kernels vs plain
        xw = x.view(BW, N, C)
        cost = dict(flops=2.0 * M * C * 12 * C + 4.0 * BW * nH * N * N * Dh)
        if C < 768:
            cases = [("swin_full_block_train", patterns[0], None)]
            if shifted:
                cases.append(("swin_full_block_train_shift", patterns[1],
                              (res, res, 7, 3)))
            fn, fn_plain = blocks.swin_full_block, blocks.swin_full_block_plain
        else:
            cases = [("swin_half_block", patterns[0], None)]
            fn, fn_plain = blocks.swin_half_block, blocks.swin_half_block_plain
            chk.case("attention_core",
                     lambda: blocks.attention_core(qkv.view(BW, N, 3 * C),
                                                   rel, sc, nH),
                     lambda: blocks.attention_core_plain(
                         qkv.view(BW, N, 3 * C), rel, sc, nH), KERNEL_BAR,
                     library_fn=lambda: lib_attention(qkv, BW, N, nH,
                                                      rel.to(bf), sc),
                     flops=4.0 * BW * nH * N * N * Dh,
                     nbytes=nbytes(qkv, rel) + 2 * M * C)
        for name, pat, spec in cases:
            gather = scatter = None
            if spec is not None:
                gather = si.long()
                scatter = torch.argsort(gather)
            lmask = pat.to(bf)[torch.arange(BW, device=dev) % pat.shape[0]]
            with torch.no_grad():
                chk.case(name,
                         lambda pat=pat, spec=spec: fn(
                             xw, params, pat, sc, nH, shift_spec=spec, dp=dp),
                         lambda pat=pat, spec=spec: fn_plain(
                             xw, params, pat, sc, nH, shift_spec=spec, dp=dp),
                         BLOCK_BAR,
                         library_fn=lambda lmask=lmask, gather=gather,
                         scatter=scatter: lib_swin_block(
                             xw, lparams, lmask, sc, nH, gather, scatter,
                             dp=(r1.to(bf), r2.to(bf))),
                         nbytes=nbytes(x, *params, pat, dp1, dp2, x), **cost)
            check_block_grads(fn, fn_plain, xw, params, pat, g.view(BW, N, C),
                              f"{name} ({tag})", scale=sc, num_heads=nH,
                              shift_spec=spec, dp=dp)


def norm_kernel_checks(chk: Checker, dev) -> None:
    """K3 and K5 at the shapes at which the Swin-S pretrain step of record
    (b32) and its fusion encoder (B*S = 32*131 rows, C 768, I 3072) call
    them, each also timed as CUDA graphs beside the library call:
    ``column_sum`` over stage 1's da1 (M, 4C) and dqkv (M, 3C), stage 3's
    da1, the fusion's dqkv and da1, and stage 1's g2 scaled by the (B,)
    DropPath multipliers; ``layernorm_bwd`` in the Swin blocks' pre-LN
    forms at stages 1 and 3 (LN2: f32 res1, f32 dh2, the bf16 block
    cotangent as gres, da scaled by dp1; LN1: bf16 x, f32 dh1, f32 dres1 as
    gres, no dres) and in the fusion's hmask form; ``layernorm`` as the
    step calls it (stage 1's LN1 through the shift gather, LN2 from the f32
    res1 at stages 1 and 3, the fusion's LN of its f32 res)."""
    import inspect
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    inp = Inputs(dev, seed=9)
    rnd, ln = inp.rnd, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B = TRAIN_BATCH
    stages = {"stage 1": (B * 56 * 56, 96), "stage 3": (B * 14 * 14, 384)}
    repeated = []

    def repeat(what, fn):
        """Two more calls of a K5 case are bitwise equal."""
        one, two = _tensors(fn()), _tensors(fn())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"K5 ({what}) is not bitwise reproducible")
        repeated.append(what)

    (M1, C1), (M3, C3) = stages["stage 1"], stages["stage 3"]
    MF, CF, IF = B * (1 + 49 + 1 + PRETRAIN_TEXT), 768, 3072
    # K5 of a tree from before ``dres=False`` writes the LN1 form's dres
    ln1_kw = (dict(dres=False) if "dres" in
              inspect.signature(K.layernorm_bwd).parameters else {})

    # column_sum; library: torch.sum in f32 (scaled: (x * s).sum)
    for label, shape in (("stage-1 da1", (M1, 4 * C1)),
                         ("stage-1 dqkv", (M1, 3 * C1)),
                         ("stage-3 da1", (M3, 4 * C3)),
                         ("fusion dqkv", (MF, 3 * CF)),
                         ("fusion da1", (MF, IF))):
        x = rnd(*shape, std=0.1)
        chk.case("column_sum", lambda x=x: K.column_sum(x),
                 lambda x=x: K.column_sum_plain(x), KERNEL_BAR, floor=1e-6,
                 library_fn=lambda x=x: torch.sum(x, 0, dtype=f32),
                 flops=1.0 * x.numel(), nbytes=nbytes(x) + 4 * shape[1],
                 graph=True, label=label)
        repeat(f"column_sum, {label}", lambda x=x: K.column_sum(x))
        del x
    g2, dp2 = rnd(M1, C1), _swin_dp(inp, dev, B)
    r2 = dp2.repeat_interleave(M1 // B)[:, None]
    chk.case("column_sum", lambda: K.column_sum(g2, row_scale=dp2),
             lambda: K.column_sum_plain(g2, row_scale=dp2), KERNEL_BAR,
             floor=1e-6, library_fn=lambda: (g2.float() * r2).sum(0),
             flops=2.0 * M1 * C1, nbytes=nbytes(g2, dp2, g2) + 4 * C1,
             graph=True, label="stage-1 g2 * dp2")
    repeat("column_sum, stage-1 g2 * dp2",
           lambda: K.column_sum(g2, row_scale=dp2))

    # layernorm_bwd; library: autograd's LN backward + gres (· dp1)
    for stage, (M, C) in stages.items():
        dp1 = _swin_dp(inp, dev, B)
        r1 = dp1.repeat_interleave(M // B)[:, None]
        x, res1 = rnd(M, C), rnd(M, C, std=2.0, dtype=f32)
        gb, dh = rnd(M, C), rnd(M, C, dtype=f32)
        dres1 = rnd(M, C, std=0.1, dtype=f32)
        for form, r_, gam, gres, rs, extra in (
                ("LN2", res1, ln(C), gb, dp1, {}),
                ("LN1", x, ln(C), dres1, None, ln1_kw)):
            grads = library_backward(
                lambda a_, s_, b_, C=C: F.layer_norm(a_, (C,), s_, b_, 1e-5),
                (r_.float(), *gam), dh)

            def lib(grads=grads, gres=gres, rs=rs, r1=r1):
                dr = grads()[0] + gres
                da = dr if rs is None else dr * r1
                return da, da.sum(0)

            lib.stream = grads.stream    # graph_ms captures autograd there

            kw = dict(gres=gres, row_scale=rs, out_dtype=bf, **extra)
            writes = 2 * M * C + (4 * M * C if form == "LN2" else 0)
            chk.case("layernorm_bwd",
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd(
                         r_, gam[0], dh, 1e-5, **kw),
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd_plain(
                         r_, gam[0], dh, 1e-5, **kw),
                     KERNEL_BAR, library_fn=lib, floor=1e-6,
                     flops=16.0 * M * C,
                     nbytes=nbytes(r_, gam[0], dh, gres, rs) + writes + 12 * C,
                     graph=True, label=f"{stage} {form}")
            repeat(f"layernorm_bwd, {stage} {form}",
                   lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd(
                       r_, gam[0], dh, 1e-5, **kw))
    res, g = rnd(MF, CF, std=2.0, dtype=f32) + 0.3, rnd(MF, CF)
    lns, lnb = ln(CF)
    hmask = ((torch.rand(MF, CF, generator=inp.gen) < 0.9).to(bf)
             / 0.9).to(dev)
    grads = library_backward(
        lambda r, s_, b_: F.layer_norm(r, (CF,), s_, b_, 1e-12),
        (res, lns, lnb), g.float())

    # the pretrain step's form (hmask) and the VQA step's (no mask)
    for label, hm in (("fusion, hmask", hmask), ("fusion, no mask", None)):
        def lib_fusion(hm=hm):
            dr = grads()[0]
            da = dr if hm is None else dr * hm
            return dr, da, da.sum(0)

        lib_fusion.stream = grads.stream
        chk.case("layernorm_bwd",
                 lambda hm=hm: K.layernorm_bwd(res, lns, g, 1e-12, hmask=hm),
                 lambda hm=hm: K.layernorm_bwd_plain(res, lns, g, 1e-12,
                                                     hmask=hm),
                 KERNEL_BAR, library_fn=lib_fusion, floor=1e-6,
                 flops=(14.0 if hm is not None else 12.0) * MF * CF,
                 nbytes=nbytes(res, lns, g, hm, res, g) + 12 * CF,
                 graph=True, label=label)
        repeat(f"layernorm_bwd, {label}",
               lambda hm=hm: K.layernorm_bwd(res, lns, g, 1e-12, hmask=hm))
    print(f"K5, two calls bitwise equal at each step shape and mode: "
          f"{repeated}", flush=True)

    # layernorm; library: F.layer_norm, without the gather (gamma / beta in
    # x's dtype, which it also writes: f32 from the f32 res)
    si = blocks._shift_index(B, 56, 56, 7, 3, dev)
    for label, x, ri, eps in (
            ("stage-1 LN1, shift gather", rnd(M1, C1, std=2.0) + 0.5, si,
             1e-5),
            ("stage-1 LN2, f32 res1", rnd(M1, C1, std=2.0, dtype=f32) + 0.5,
             None, 1e-5),
            ("stage-3 LN2, f32 res1", rnd(M3, C3, std=2.0, dtype=f32) + 0.5,
             None, 1e-5),
            ("fusion, f32 res", rnd(MF, CF, std=2.0, dtype=f32) + 0.3, None,
             1e-12)):
        M, C = x.shape
        g, b = ln(C)
        lg, lb = (g, b) if x.dtype == f32 else bf16_ln(g, b)
        chk.case("layernorm",
                 lambda x=x, g=g, b=b, ri=ri, eps=eps: K.layernorm(
                     x, g, b, eps, ri, out_dtype=bf),
                 lambda x=x, g=g, b=b, ri=ri, eps=eps: K.layernorm_plain(
                     x, g, b, eps, ri, out_dtype=bf),
                 KERNEL_BAR,
                 library_fn=lambda x=x, g=lg, b=lb, eps=eps: F.layer_norm(
                     x, (x.shape[1],), g, b, eps),
                 flops=8.0 * M * C, nbytes=nbytes(x, g, b, ri) + 2 * M * C,
                 graph=True, label=label)


def lib_dropout_attention(qkv, G, N, nH, mask, scale, rate):
    """SDPA with its own dropout over fused rows: the same function as K2's
    in-kernel dropout, with PyTorch's random stream."""
    C = qkv.shape[1] // 3
    t = qkv.view(G, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=mask,
                                       dropout_p=rate, scale=scale)
    return o.permute(0, 2, 1, 3).reshape(G * N, C)


def optin_kernel_checks(chk: Checker, dev) -> None:
    """The opt-in modes of K2 and K4 and the counterparts that run them, at
    the shapes of the Swin-S step of record: in-kernel dropout at B*S =
    32*131, 12 heads, head dim 64, rate 0.1, key-bias and seq2seq modes;
    the stored softmax at Swin-S stage 3 (b32: 128 windows of 49, C 384,
    12 heads, head dim 32; one pattern, and four: the shifted blocks)."""
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask

    inp = Inputs(dev, seed=4)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, S, C, nH, rate = TRAIN_BATCH, 1 + 49 + 1 + PRETRAIN_TEXT, 768, 12, 0.1
    M, Dh = B * S, C // nH
    sc = Dh ** -0.5
    seed = torch.tensor([40503, 12345], dtype=torch.int32, device=dev)
    adrop = (seed, rate)
    kb = inp.key_bias([S - (11 * i) % 75 for i in range(B)], S)
    qb = mask_to_bias(seq2seq_fusion_mask(B, 50, S, dev)).contiguous()
    qkv, dctx, x = rnd(M, 3 * C, std=0.5), rnd(M, C), rnd(M, C)
    hmask = ((torch.rand(M, C, generator=inp.gen) < 0.9).to(bf) / 0.9).to(dev)
    q4 = qkv.view(B, S, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    d4 = dctx.view(B, S, nH, Dh).permute(0, 2, 1, 3).contiguous()
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    lns, lnb = ln(C)
    lgb = bf16_ln(lns, lnb)
    for kbias, qbias in ((kb, None), (None, qb)):
        tag = "key bias" if qbias is None else "seq2seq"
        bias = (kb.to(bf)[:, None, None, :] if qbias is None
                else qb.to(bf)[:, None])
        kw = dict(key_bias=kbias, qbias=qbias)
        # K2 (a): the drawn mask is the plain Philox mask, bit for bit
        ctx, mask = K.biased_attention(qkv, nH, S, sc, adrop=adrop,
                                       save_mask=True, **kw)
        again = K.biased_attention(qkv, nH, S, sc, adrop=adrop, **kw)
        want = K.adrop_mask_plain(seed, B, nH, S, rate)
        torch.cuda.synchronize()
        if not torch.equal(mask, want):
            raise AssertionError(f"K2's Philox mask ({tag}) differs from "
                                 f"adrop_mask_plain at "
                                 f"{(mask != want).sum().item()} elements")
        if not torch.equal(ctx, again):
            raise AssertionError(f"K2 with in-kernel dropout ({tag}) is not "
                                 "bitwise reproducible")
        kept = (mask > 0).float().mean().item()
        if not abs(kept - 0.9) <= 1e-3:
            raise AssertionError(f"keep fraction {kept} over {mask.numel()} "
                                 "draws is not 0.9 +- 0.001")
        print(f"K2 in-kernel dropout ({tag}): mask bitwise equal to "
              f"adrop_mask_plain, keep fraction {kept:.6f} over "
              f"{mask.numel()} draws, two calls bitwise equal", flush=True)
        # what one fusion layer spends on attention dropout either way: the
        # explicit mask (the step's draw, K2 and K4 reading it) against K2
        # drawing it and K4 regenerating it
        src = DropoutMasks(torch.Generator(device=dev).manual_seed(0))
        amask = src.scaled(0.9, (B, nH, S, S), bf, dev)
        tm = {"draw": cuda_ms(lambda: src.scaled(0.9, (B, nH, S, S), bf,
                                                 dev)),
             "K2 amask": cuda_ms(lambda kw=kw: K.biased_attention(
                 qkv, nH, S, sc, amask=amask, **kw)),
             "K4 amask": cuda_ms(lambda kw=kw: K.biased_attention_bwd(
                 qkv, dctx, nH, S, sc, amask=amask, **kw)),
             "K2 adrop": cuda_ms(lambda kw=kw: K.biased_attention(
                 qkv, nH, S, sc, adrop=adrop, **kw)),
             "K4 adrop": cuda_ms(lambda kw=kw: K.biased_attention_bwd(
                 qkv, dctx, nH, S, sc, adrop=adrop, **kw))}
        print(f"attention dropout per layer ({tag}), ms: "
              f"{json.dumps({k: round(v, 4) for k, v in tm.items()})}; "
              f"explicit mask "
              f"{tm['draw'] + tm['K2 amask'] + tm['K4 amask']:.4f}, "
              f"in-kernel {tm['K2 adrop'] + tm['K4 adrop']:.4f}", flush=True)
        chk.case("biased_attention_adrop",
                 lambda kw=kw: K.biased_attention(qkv, nH, S, sc, adrop=adrop,
                                                  **kw),
                 lambda kw=kw: K.biased_attention_plain(qkv, nH, S, sc,
                                                        adrop=adrop, **kw),
                 KERNEL_BAR,
                 library_fn=lambda bias=bias: lib_dropout_attention(
                     qkv, B, S, nH, bias, sc, rate),
                 flops=4.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(qkv, kbias, qbias, seed, dctx), graph=True)
        # K4 (a) and its counterpart, the mask regenerated
        lib = library_backward(
            lambda q, k, v, bias=bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, dropout_p=rate, scale=sc),
            (q4[0].contiguous(), q4[1].contiguous(), q4[2].contiguous()), d4)
        cost = dict(flops=10.0 * B * nH * S * S * Dh,
                    nbytes=nbytes(qkv, dctx, kbias, qbias, seed, qkv, kb))
        chk.case("biased_attention_bwd_adrop",
                 lambda kw=kw: K.biased_attention_bwd(qkv, dctx, nH, S, sc,
                                                      adrop=adrop, **kw),
                 lambda kw=kw: K.biased_attention_bwd_plain(
                     qkv, dctx, nH, S, sc, adrop=adrop, **kw),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, graph=True, **cost)
        q3, d3 = qkv.view(B, S, 3 * C), dctx.view(B, S, C)
        chk.case("seq_attention_core_bwd_adrop",
                 lambda kbias=kbias, qbias=qbias: blocks.seq_attention_core_bwd(
                     q3, d3, kbias, qbias, None, sc, nH, adrop=adrop),
                 lambda kbias=kbias, qbias=qbias:
                 blocks.seq_attention_core_bwd_plain(q3, d3, kbias, qbias,
                                                     None, sc, nH, adrop=adrop),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
        # the attention half with in-kernel dropout; library: F.linear, SDPA
        # with dropout, F.layer_norm
        args = (x.view(B, S, C), wq, bq, wp, bp, kbias, qbias,
                hmask.view(B, S, C), lns, lnb, seed, sc, nH, rate, 1e-12)

        def lib_attn(bias=bias):
            c = lib_dropout_attention(F.linear(x, wq, bq), B, S, nH, bias, sc,
                                      rate)
            return F.layer_norm(F.linear(c, wp, bp) * hmask + x, (C,), *lgb,
                                1e-12).view(B, S, C)

        chk.case("fused_attn_ln_adrop",
                 lambda args=args: blocks.fused_attn_ln_adrop(*args),
                 lambda args=args: blocks.fused_attn_ln_adrop_plain(*args),
                 BLOCK_BAR, library_fn=lib_attn,
                 flops=2.0 * M * C * 4 * C + 4.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(x, wq, bq, wp, bp, kbias, qbias, hmask, lns,
                               lnb, seed, x))

    # the stored softmax at Swin-S stage 3, b32
    res, C, nH, N = 14, 384, 12, 49
    nW = (res // 7) ** 2
    BW, Dh, I = B * nW, C // nH, 4 * C
    M, sc = BW * N, Dh ** -0.5
    qkv, dctx, x, g = (rnd(M, 3 * C, std=0.5), rnd(M, C), rnd(M, C),
                       rnd(M, C))
    rel = rnd(1, nH, N, N, std=0.5, dtype=f32)
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3), device=dev)
    t = qkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    for pat in (rel, (rel + mask[:, None]).contiguous()):
        P = pat.shape[0]
        lmask = pat.to(bf)[torch.arange(BW, device=dev) % P]
        out_p = torch.empty(BW, nH, N, N, dtype=bf, device=dev)
        # K2 (b): ctx and p within one bf16 step of the plain version's
        chk.case("biased_attention_save_p",
                 lambda pat=pat: K.biased_attention(qkv, nH, N, sc, pat,
                                                    save_p=True),
                 lambda pat=pat: K.biased_attention_plain(qkv, nH, N, sc, pat,
                                                          save_p=True),
                 KERNEL_BAR, flops=4.0 * BW * nH * N * N * Dh,
                 nbytes=nbytes(qkv, pat, x, out_p), graph=True)
        _, p = K.biased_attention(qkv, nH, N, sc, pat, save_p=True)
        # K4 (b) against its plain version on the same p, and against K4's
        # recompute mode; dpattern bitwise equal over two calls
        lib = library_backward(
            lambda q, k, v, lmask=lmask: torch.matmul(torch.softmax(
                torch.matmul(q, k.transpose(-1, -2)) * sc + lmask, dim=-1), v),
            (t[0].contiguous(), t[1].contiguous(), t[2].contiguous()),
            dctx.view(BW, N, nH, Dh).permute(0, 2, 1, 3).contiguous())
        cost = dict(flops=8.0 * BW * nH * N * N * Dh,
                    nbytes=nbytes(p, qkv, dctx, qkv, pat))
        chk.case("biased_attention_bwd_stored_p",
                 lambda pat=pat, p=p: K.biased_attention_bwd(
                     qkv, dctx, nH, N, sc, pattern=pat, p=p),
                 lambda pat=pat, p=p: K.biased_attention_bwd_plain(
                     qkv, dctx, nH, N, sc, pattern=pat, p=p),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, graph=True, **cost)
        chk.case("attention_core_bwd_store_p",
                 lambda pat=pat, p=p: blocks.attention_core_bwd(
                     qkv, dctx, pat, N, sc, nH, p2=p),
                 lambda pat=pat, p=p: blocks.attention_core_bwd_plain(
                     qkv, dctx, pat, N, sc, nH, p2=p),
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
        one = K.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat, p=p)
        two = K.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat, p=p)
        rec = K.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat)
        torch.cuda.synchronize()
        if not (torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])):
            raise AssertionError(f"K4 from the stored p (P = {P}) is not "
                                 "bitwise reproducible")
        diffs = []
        for a, b in ((one[0], rec[0]), (one[2], rec[2])):
            e = (a.float() - b.float()).abs().max().item()
            diffs.append(e / max(b.float().abs().max().item(), 1e-6))
        if not max(diffs) <= BLOCK_BAR:
            raise AssertionError(f"K4 from the stored p (P = {P}) is "
                                 f"{diffs} x max|recompute| from K4's "
                                 f"recompute mode, beyond {BLOCK_BAR}")
        print(f"K4 stored p at stage 3, P = {P}: two calls bitwise equal; "
              f"dqkv / dpattern {diffs[0]:.3g} / {diffs[1]:.3g} x max| | "
              "from K4's recompute mode (bf16 p against f32 p)", flush=True)
        tm = {"K2": cuda_ms(lambda pat=pat: K.biased_attention(
                 qkv, nH, N, sc, pat)),
             "K2 save_p": cuda_ms(lambda pat=pat: K.biased_attention(
                 qkv, nH, N, sc, pat, save_p=True)),
             "K4 recompute": cuda_ms(lambda pat=pat: K.biased_attention_bwd(
                 qkv, dctx, nH, N, sc, pattern=pat)),
             "K4 stored p": cuda_ms(lambda pat=pat, p=p: K.biased_attention_bwd(
                 qkv, dctx, nH, N, sc, pattern=pat, p=p))}
        print(f"stage 3, P = {P}, one block's attention core, ms: "
              f"{json.dumps({k: round(v, 4) for k, v in tm.items()})}",
              flush=True)

    # the stage-3 training blocks storing p: the forward under autograd
    # (timed; p saved for the backward), then forward + backward held to the
    # plain versions
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    (w1, b1), (w2, b2) = dense(C, I), dense(I, C)
    ln1, ln2 = ln(C), ln(C)
    params = (*ln1, wq, bq, wp, bp, *ln2, w1, b1, w2, b2)
    lparams = (*bf16_ln(*ln1), wq, bq, wp, bp, *bf16_ln(*ln2), w1, b1, w2, b2)
    dp = (_swin_dp(inp, dev, B), _swin_dp(inp, dev, B))
    r1, r2 = (d.repeat_interleave(M // B)[:, None].to(bf) for d in dp)
    xw, gw = x.view(BW, N, C), g.view(BW, N, C)
    gather = blocks._shift_index(B, res, res, 7, 3, dev).long()
    scatter = torch.argsort(gather)
    for name, pat, spec in (
            ("swin_full_block_train_store_p", rel, None),
            ("swin_full_block_train_shift_store_p",
             (rel + mask[:, None]).contiguous(), (res, res, 7, 3))):
        lmask = pat.to(bf)[torch.arange(BW, device=dev) % pat.shape[0]]
        leaves = [t_.detach().clone().requires_grad_() for t_ in params]
        xg = xw.detach().clone().requires_grad_()
        kw = dict(shift_spec=spec, dp=dp, store_p=True)
        chk.case(name,
                 lambda pat=pat, kw=kw: blocks.swin_full_block(
                     xg, leaves, pat, sc, nH, **kw),
                 lambda pat=pat, kw=kw: blocks.swin_full_block_plain(
                     xg, leaves, pat, sc, nH, **kw),
                 BLOCK_BAR,
                 library_fn=lambda lmask=lmask, spec=spec: lib_swin_block(
                     xw, lparams, lmask, sc, nH,
                     None if spec is None else gather,
                     None if spec is None else scatter, dp=(r1, r2)),
                 flops=2.0 * M * C * 12 * C + 4.0 * BW * nH * N * N * Dh,
                 nbytes=nbytes(x, *params, pat, *dp, x)
                 + 2 * BW * nH * N * N)
        check_block_grads(blocks.swin_full_block,
                          blocks.swin_full_block_plain, xw, params, pat, gw,
                          f"{name} (stage 384)", scale=sc, num_heads=nH,
                          **kw)


def attn_impl_kernel_checks(chk: Checker, dev) -> None:
    """The last four TPU kernels' counterparts at the shapes of the
    ``attn_impl='pallas'`` route and of their JAX callers: row 8
    (``window_attention``, K2 head-major, and its backward on K4's pattern
    mode) at every Swin-S stage at b32 (N = 49, head dim 32; one pattern and
    one per window), q, k, v as the route makes them (views of the qkv
    product's rows); row 7 (``swin_attn_half``) at b32 with window 12 and C =
    768, 24 heads (N = 144: the one-window stage 4 of a 384 image); row 9
    (``fused_seq_attention``, forward and backward) at BERT-base b32, S = 74
    and 131, with a padded key bias; row 10 (``full_forward_windows``) at
    Swin-S stage 3, b32, shifted (128 windows, C 384, 12 heads, 4
    patterns)."""
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    inp = Inputs(dev, seed=5)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, N = TRAIN_BATCH, 49

    # row 8 at the four stages; library: SDPA with the patterns gathered per
    # window as a bf16 mask, and the autograd backward of the bf16
    # matmul-softmax-matmul composition
    for res, C, nH in SWIN_STAGES:
        nW = (res // 7) ** 2
        BW, Dh = B * nW, C // nH
        sc = Dh ** -0.5
        qkv = rnd(BW, N, 3 * C, std=0.5)
        q, k, v = qkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
        g = rnd(BW, N, C).view(BW, N, nH, Dh).permute(0, 2, 1, 3)
        rel = rnd(1, nH, N, N, std=0.5, dtype=f32)
        patterns = [rel]
        if nW > 1:
            mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3),
                                   device=dev)
            patterns.append((rel + mask[:, None]).contiguous())
        ctx = torch.empty(BW, N, C, dtype=bf, device=dev)
        for pat in patterns:
            P = pat.shape[0]
            lmask = pat.to(bf)[torch.arange(BW, device=dev) % P]
            cost = dict(flops=4.0 * BW * nH * N * N * Dh,
                        nbytes=nbytes(q, k, v, pat, ctx))
            # K2's head-major mode, and the counterpart that runs it
            for name, fn, plain in (
                    ("biased_attention_heads",
                     lambda p_: K.biased_attention_heads(q, k, v, sc, p_),
                     lambda p_: K.biased_attention_heads_plain(q, k, v, sc,
                                                                p_)),
                    ("window_attention",
                     lambda p_: blocks.window_attention(q, k, v, p_, sc),
                     lambda p_: blocks.window_attention_plain(q, k, v, p_,
                                                              sc))):
                chk.case(name, lambda fn=fn, pat=pat: fn(pat),
                         lambda plain=plain, pat=pat: plain(pat), KERNEL_BAR,
                         library_fn=lambda lmask=lmask:
                         F.scaled_dot_product_attention(
                             q, k, v, attn_mask=lmask, scale=sc),
                         graph=name == "biased_attention_heads", **cost)
            lib = library_backward(
                lambda q_, k_, v_, lmask=lmask: torch.matmul(torch.softmax(
                    torch.matmul(q_, k_.transpose(-1, -2)) * sc + lmask,
                    dim=-1), v_),
                (q.contiguous(), k.contiguous(), v.contiguous()),
                g.contiguous())
            chk.case("window_attention_bwd",
                     lambda pat=pat: blocks.window_attention_bwd(
                         q, k, v, pat, g, sc),
                     lambda pat=pat: blocks.window_attention_bwd_plain(
                         q, k, v, pat, g, sc),
                     KERNEL_BAR, library_fn=lib, floor=1e-6,
                     flops=10.0 * BW * nH * N * N * Dh,
                     nbytes=nbytes(q, k, v, g, pat, q, k, v, pat))

    # row 7: one 12 x 12 window per image at C = 768 (b32); library:
    # F.layer_norm, F.linear, SDPA, F.linear, + x in bf16
    C, nH, N7 = 768, 24, 144
    Dh, sc = C // nH, (C // nH) ** -0.5
    x = rnd(B, N7, C)
    ln1 = ln(C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    rel = rnd(1, nH, N7, N7, std=0.5, dtype=f32)
    half = (x, *ln1, wq, bq, wp, bp, rel, sc, nH)

    def lib_half():
        rows = x.view(-1, C)
        h = F.layer_norm(rows, (C,), *bf16_ln(*ln1), 1e-5)
        c = lib_attention(F.linear(h, wq, bq), B, N7, nH, rel.to(bf), sc)
        return (F.linear(c, wp, bp) + rows).view(B, N7, C)

    chk.case("swin_attn_half", lambda: blocks.swin_attn_half(*half),
             lambda: blocks.swin_attn_half_plain(*half), BLOCK_BAR,
             library_fn=lib_half,
             flops=2.0 * B * N7 * C * 4 * C + 4.0 * B * nH * N7 * N7 * Dh,
             nbytes=nbytes(x, *ln1, wq, bq, wp, bp, rel, x))

    # row 9 at BERT-base b32, S = 74 and 131, forward and backward; library:
    # F.linear, SDPA with the key bias, F.linear, and its autograd backward
    C, nH = 768, 12
    Dh, sc = C // nH, (C // nH) ** -0.5
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    for S in (74, 1 + 49 + 1 + PRETRAIN_TEXT):
        M = B * S
        x, g = rnd(B, S, C), rnd(B, S, C)
        kb = inp.key_bias([S - (7 * i) % (S // 2) for i in range(B)], S)
        kmask = kb.to(bf)[:, None, None, :]

        def lib_seq(x_, wq_, bq_, wp_, bp_, S=S, kmask=kmask):
            c = lib_attention(F.linear(x_.reshape(-1, C), wq_, bq_), B, S,
                              nH, kmask, sc)
            return F.linear(c, wp_, bp_).view(B, S, C)

        seq = (x, wq, bq, wp, bp, kb, sc, nH)
        chk.case("fused_seq_attention",
                 lambda seq=seq: blocks.fused_seq_attention(*seq),
                 lambda seq=seq: blocks.fused_seq_attention_plain(*seq),
                 BLOCK_BAR, library_fn=lambda x=x, lib_seq=lib_seq: lib_seq(
                     x, wq, bq, wp, bp),
                 flops=2.0 * M * C * 4 * C + 4.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(x, wq, bq, wp, bp, kb, x))
        x2 = x.view(M, C)
        qkv2 = K.gemm(x2, wq, bq)
        ctx2 = K.biased_attention(qkv2, nH, S, sc, key_bias=kb)
        bwd = (x2, qkv2, ctx2, g.view(M, C), wq, wp, kb, S, sc, nH)
        chk.case("fused_seq_attention_bwd",
                 lambda bwd=bwd: blocks.fused_seq_attention_bwd(*bwd),
                 lambda bwd=bwd: blocks.fused_seq_attention_bwd_plain(*bwd),
                 BLOCK_BAR, floor=1e-6,
                 library_fn=library_backward(lib_seq, (x, wq, bq, wp, bp), g),
                 flops=2 * 2.0 * M * C * 4 * C
                 + 10.0 * B * nH * S * S * Dh,
                 nbytes=nbytes(x2, qkv2, ctx2, g, wq, wp, kb, x2)
                 + 4 * (4 * C * C + 4 * C))

    # row 10 at Swin-S stage 3, b32, shifted: four patterns; library: the
    # bf16 F.layer_norm / F.linear / SDPA / F.gelu block
    res, C, nH = 14, 384, 12
    nW = (res // 7) ** 2
    BW, Dh, sc = B * nW, C // nH, (C // nH) ** -0.5
    x = rnd(BW, N, C)
    params = (*ln(C), *dense(C, 3 * C), *dense(C, C), *ln(C),
              *dense(C, 4 * C), *dense(4 * C, C))
    lparams = (*bf16_ln(*params[0:2]), *params[2:6], *bf16_ln(*params[6:8]),
               *params[8:])
    mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3), device=dev)
    pat = (rnd(1, nH, N, N, std=0.5, dtype=f32) + mask[:, None]).contiguous()
    lmask = pat.to(bf)[torch.arange(BW, device=dev) % nW]
    chk.case("full_forward_windows",
             lambda: blocks.full_forward_windows(x, params, pat, sc, nH),
             lambda: blocks.full_forward_windows_plain(x, params, pat, sc,
                                                       nH), BLOCK_BAR,
             library_fn=lambda: lib_swin_block(x, lparams, lmask, sc, nH),
             flops=2.0 * BW * N * C * 12 * C + 4.0 * BW * nH * N * N * Dh,
             nbytes=nbytes(x, *params, pat, x))


def _same_twice(what: str, fn) -> None:
    """Two calls of ``fn`` give bitwise equal outputs."""
    one, two = _tensors(fn()), _tensors(fn())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError(f"{what}: two calls are not bitwise equal")


def swin_routes_kernel_checks(chk: Checker, dev) -> None:
    """The backward rules of JAX's plain Swin route against their plain
    versions, each also called twice (bitwise equal) and timed beside the
    library's autograd of the same layers (F.linear, SDPA with the patterns
    as a bf16 mask, F.layer_norm, F.gelu: the port never calls it) and its
    bound: row 1's (``window_block_attention_bwd``) at every Swin-S b32
    stage with one pattern and, where the stage shifts, one per window; row
    6's (``fused_mlp_preln_bwd``) at stage 4's 1,568 x 768 rows; row 7's
    (``swin_attn_half_bwd``) at b32 with window 12 and C = 768, 24 heads
    (phase 9's row-7 shape); ``attention_core_op``, forward and backward
    through its autograd Function, at stage 3 with four patterns. Each
    backward counts the work its function must do from its inputs: the
    forward products it recomputes, and the attention once (S, PV, dV, dP,
    dQ, dK: 12 BW nH N^2 Dh)."""
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    from mvlt_tpu_torch.ops import blocks

    inp = Inputs(dev, seed=17)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, N = TRAIN_BATCH, 49

    def patterns_of(res, nH, n=N):
        rel = rnd(1, nH, n, n, std=0.5, dtype=f32)
        if res == 7 or n != N:
            return [rel]
        mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3),
                               device=dev)
        return [rel, (rel + mask[:, None]).contiguous()]

    def lib_block(BW, n, C, nH, sc, lmask, ln_=None):
        """x -> [LN1 ->] qkv -> SDPA -> proj [+ x], in bf16 autograd."""
        def f(x_, wq_, bq_, wp_, bp_, *lnp):
            rows = x_.reshape(BW * n, C)
            h = rows if not lnp else F.layer_norm(rows, (C,), *lnp, 1e-5)
            c = lib_attention(F.linear(h, wq_, bq_), BW, n, nH, lmask, sc)
            y = F.linear(c, wp_, bp_)
            return (y if not lnp else y + rows).view(BW, n, C)
        return f

    # row 1's backward at the four stages
    for res, C, nH in SWIN_STAGES:
        BW, Dh = B * (res // 7) ** 2, C // nH
        M, sc = BW * N, Dh ** -0.5
        x, g = rnd(BW, N, C), rnd(BW, N, C)
        (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
        for pat in patterns_of(res, nH):
            P = pat.shape[0]
            lmask = pat.to(bf)[torch.arange(BW, device=dev) % P]
            args = (x, wq, bq, wp, pat, g, sc, nH)
            out = blocks.window_block_attention_bwd(*args)
            chk.case("window_block_attention_bwd",
                     lambda args=args: blocks.window_block_attention_bwd(
                         *args),
                     lambda args=args: blocks.window_block_attention_bwd_plain(
                         *args), BLOCK_BAR, floor=1e-6, graph=True,
                     library_fn=library_backward(
                         lib_block(BW, N, C, nH, sc, lmask),
                         (x, wq, bq, wp, bp), g),
                     label=f"C = {C}, P = {P}",
                     flops=22.0 * M * C * C + 12.0 * BW * nH * N * N * Dh,
                     nbytes=nbytes(x, wq, bq, wp, bp, pat, g, *out))
            _same_twice(f"window_block_attention_bwd C = {C}, P = {P}",
                        lambda args=args: blocks.window_block_attention_bwd(
                            *args))

    # row 6's backward at stage 4: x + fc2(GELU(fc1(LN2 x))) over 1,568 rows
    C = 768
    x, g = rnd(B, N, C), rnd(B, N, C)
    ln2 = ln(C)
    (w1, b1), (w2, b2) = dense(C, 4 * C), dense(4 * C, C)
    args = (x, *ln2, w1, b1, w2, g)
    out = blocks.fused_mlp_preln_bwd(*args)

    def lib_mlp(x_, s_, b_, w1_, b1_, w2_, b2_):
        h = F.layer_norm(x_, (C,), s_, b_, 1e-5)
        return F.linear(F.gelu(F.linear(h, w1_, b1_)), w2_, b2_) + x_

    M = B * N
    chk.case("fused_mlp_preln_bwd", lambda: blocks.fused_mlp_preln_bwd(*args),
             lambda: blocks.fused_mlp_preln_bwd_plain(*args), BLOCK_BAR,
             floor=1e-6, graph=True,
             library_fn=library_backward(
                 lib_mlp, (x, *bf16_ln(*ln2), w1, b1, w2, b2), g),
             label=f"{M} x {C}", flops=40.0 * M * C * C,
             nbytes=nbytes(x, *ln2, w1, b1, w2, b2, g, *out))
    _same_twice("fused_mlp_preln_bwd", lambda: blocks.fused_mlp_preln_bwd(
        *args))

    # row 7's backward: one 12 x 12 window per image at C = 768 (b32)
    nH, N7 = 24, 144
    Dh, sc = C // nH, (C // nH) ** -0.5
    x, g = rnd(B, N7, C), rnd(B, N7, C)
    ln1 = ln(C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    rel = rnd(1, nH, N7, N7, std=0.5, dtype=f32)
    args = (x, *ln1, wq, bq, wp, rel, g, sc, nH)
    out = blocks.swin_attn_half_bwd(*args)
    M = B * N7
    chk.case("swin_attn_half_bwd", lambda: blocks.swin_attn_half_bwd(*args),
             lambda: blocks.swin_attn_half_bwd_plain(*args), BLOCK_BAR,
             floor=1e-6, graph=True,
             library_fn=library_backward(
                 lib_block(B, N7, C, nH, sc, rel.to(bf)),
                 (x, wq, bq, wp, bp, *bf16_ln(*ln1)), g),
             label=f"window 12, C = {C}",
             flops=22.0 * M * C * C + 12.0 * B * nH * N7 * N7 * Dh,
             nbytes=nbytes(x, *ln1, wq, bq, wp, bp, rel, g, *out))
    _same_twice("swin_attn_half_bwd", lambda: blocks.swin_attn_half_bwd(
        *args))

    # attention_core_op at stage 3 (128 windows, C 384, 12 heads), four
    # patterns: the forward and the backward through its autograd Function;
    # library: SDPA's forward and autograd backward
    res, C, nH = 14, 384, 12
    BW, Dh = B * (res // 7) ** 2, C // nH
    sc = Dh ** -0.5
    qkv, gctx = rnd(BW, N, 3 * C, std=0.5), rnd(BW, N, C)
    pat = patterns_of(res, nH)[1]
    lmask = pat.to(bf)[torch.arange(BW, device=dev) % pat.shape[0]]

    def core_op(fn):
        def run():
            leaves = [t.detach().requires_grad_() for t in (qkv, pat)]
            ctx = fn(*leaves, sc, nH)
            return (ctx.detach(),
                    *torch.autograd.grad(ctx, leaves, gctx))
        return run

    heads = [t.contiguous().requires_grad_() for t in qkv.view(
        BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)]
    gheads = gctx.view(BW, N, nH, Dh).permute(0, 2, 1, 3).contiguous()

    def lib_core():
        o = F.scaled_dot_product_attention(*heads, attn_mask=lmask, scale=sc)
        return torch.autograd.grad(o, heads, gheads)

    out = core_op(blocks.attention_core_op)()
    chk.case("attention_core_op", core_op(blocks.attention_core_op),
             core_op(blocks.attention_core_op_plain), BLOCK_BAR, floor=1e-6,
             graph=True, library_fn=lib_core, label=f"C = {C}, P = 4",
             flops=12.0 * BW * nH * N * N * Dh,
             nbytes=nbytes(qkv, pat, gctx, *out))
    _same_twice("attention_core_op", core_op(blocks.attention_core_op))
    print("swin routes: two calls bitwise equal for row 1's backward at 7 "
          "shapes, rows 6's and 7's and attention_core_op", flush=True)


def _attention_inputs(inp, B: int, S: int, nH: int, C: int, image: int,
                      stride: int):
    """The fused rows and masks of a K2 / K4 check at (B, S, nH, C) after an
    image prefix of ``image`` rows: qkv, ctx (empty), dctx, a padded key
    bias (row i keeps ``S - stride * i`` keys, mod the text), the seq2seq
    qbias, a 0.9 attention-dropout mask, and the head-major q, k, v and
    dctx of the library calls."""
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask
    bf, dev, Dh = torch.bfloat16, inp.dev, C // nH
    qkv = inp.rnd(B * S, 3 * C, std=0.5)
    ctx = torch.empty(B * S, C, dtype=bf, device=dev)
    dctx = inp.rnd(B * S, C)
    kb = inp.key_bias([S - (stride * i) % (S - image - 1) for i in range(B)],
                      S)
    qb = mask_to_bias(seq2seq_fusion_mask(B, image + 1, S, dev)).contiguous()
    amask = ((torch.rand(B, nH, S, S, generator=inp.gen) < 0.9).to(bf)
             / 0.9).to(dev)
    t = qkv.view(B, S, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    qkv3 = (t[0].contiguous(), t[1].contiguous(), t[2].contiguous())
    d4 = dctx.view(B, S, nH, Dh).permute(0, 2, 1, 3).contiguous()
    return qkv, ctx, dctx, kb, qb, amask, qkv3, d4


def long_attention_checks(chk: Checker, dev) -> None:
    """K2 and K4 at the sequence lengths their tilings opened (ROADMAP A9):
    a 196-token image (ViT-B/16 or the linear patch) with BERT text of 23
    and 80 tokens, S = 221 and 278, b32, 12 heads, head dim 64: a padded key
    bias, the seq2seq qbias with a dropout mask, and in-kernel (K4:
    regenerated) dropout, each against its plain version, SDPA (or the bf16
    composition that takes a probability mask; K4: the autograd backward of
    each) and its bound, eagerly and as CUDA graphs. The ViT-B/16 and
    linear-patch paths run these shapes (the VQA forward and step at S =
    221, the pretrain step at 278: ``other_backbone_phases``), whose K2 /
    K4 launches at N >= 221 these rows of their own count
    (``biased_attention_long_n``, ``biased_attention_bwd_long_n``); past N =
    288 the long form has its own (:func:`long_form_kernel_checks`)."""
    from mvlt_tpu_torch.ops import kernels as K
    inp = Inputs(dev, seed=6)
    bf = torch.bfloat16
    B, C, nH, rate = TRAIN_BATCH, 768, 12, 0.1
    Dh = C // nH
    sc = Dh ** -0.5
    seed = torch.tensor([40503, 4242], dtype=torch.int32, device=dev)
    for S in (1 + 196 + 1 + 23, 1 + 196 + 1 + PRETRAIN_TEXT):
        qkv, ctx, dctx, kb, qb, amask, qkv3, d4 = _attention_inputs(
            inp, B, S, nH, C, 197, 11)
        flops = 4.0 * B * nH * S * S * Dh
        print(f"K2 at S = {S} (b{B}, {nH} heads, head dim {Dh}): "
              f"{K.attention_plan(S, Dh)}", flush=True)
        chk.case("biased_attention_long_n",
                 lambda: K.biased_attention(qkv, nH, S, sc, key_bias=kb),
                 lambda: K.biased_attention_plain(qkv, nH, S, sc, key_bias=kb),
                 KERNEL_BAR,
                 library_fn=lambda: lib_attention(
                     qkv, B, S, nH, kb.to(bf)[:, None, None, :], sc),
                 flops=flops, nbytes=nbytes(qkv, kb, ctx), graph=True)
        chk.case("biased_attention_long_n",
                 lambda: K.biased_attention(qkv, nH, S, sc, qbias=qb,
                                            amask=amask),
                 lambda: K.biased_attention_plain(qkv, nH, S, sc, qbias=qb,
                                                  amask=amask),
                 KERNEL_BAR,
                 library_fn=lambda: lib_masked_attention(
                     qkv, B, S, nH, qb.to(bf)[:, None], amask, sc),
                 flops=flops, nbytes=nbytes(qkv, qb, amask, ctx), graph=True)
        chk.case("biased_attention_long_n",
                 lambda: K.biased_attention(qkv, nH, S, sc, key_bias=kb,
                                            adrop=(seed, rate)),
                 lambda: K.biased_attention_plain(qkv, nH, S, sc, key_bias=kb,
                                                  adrop=(seed, rate)),
                 KERNEL_BAR,
                 library_fn=lambda: lib_dropout_attention(
                     qkv, B, S, nH, kb.to(bf)[:, None, None, :], sc, rate),
                 flops=flops, nbytes=nbytes(qkv, kb, seed, ctx), graph=True)
        _, mask = K.biased_attention(qkv, nH, S, sc, key_bias=kb,
                                     adrop=(seed, rate), save_mask=True)
        if not torch.equal(mask, K.adrop_mask_plain(seed, B, nH, S, rate)):
            raise AssertionError(f"K2's Philox mask at S = {S} differs from "
                                 "adrop_mask_plain")
        del mask
        # K4: the same three modes; library: the autograd backward of each
        # library forward above
        kbm, qbm = kb.to(bf)[:, None, None, :], qb.to(bf)[:, None]
        print(f"K4 at S = {S}: {K.attention_bwd_plan(S, Dh)}", flush=True)
        for kw, fwd, extra in (
                (dict(key_bias=kb),
                 lambda q, k, v: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=kbm, scale=sc), (kb, kb)),
                (dict(qbias=qb, amask=amask), lambda q, k, v: torch.matmul(
                    torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * sc
                                  + qbm, dim=-1) * amask, v),
                 (qb, amask, kb)),
                (dict(key_bias=kb, adrop=(seed, rate)),
                 lambda q, k, v: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=kbm, dropout_p=rate, scale=sc),
                 (kb, seed, kb))):
            chk.case("biased_attention_bwd_long_n",
                     lambda kw=kw: K.biased_attention_bwd(qkv, dctx, nH, S, sc,
                                                          **kw),
                     lambda kw=kw: K.biased_attention_bwd_plain(
                         qkv, dctx, nH, S, sc, **kw),
                     KERNEL_BAR, floor=1e-6, graph=True,
                     library_fn=library_backward(fwd, qkv3, d4),
                     flops=10.0 * B * nH * S * S * Dh,
                     nbytes=nbytes(qkv, dctx, *extra, qkv))
        del amask


def long_form_kernel_checks(chk: Checker, dev) -> None:
    """K2 and K4's long form (N > 288) against their plain versions at the
    fusion lengths of ``LONG_FORM_N`` (b32, 12 heads, head dim 64): a padded
    key bias; the key bias with an attention-dropout mask; the seq2seq qbias
    with one; in-kernel (K4: regenerated) dropout with the key bias and with
    the qbias. Each case is held to ``KERNEL_BAR`` (the N = 221 / 278 rows'
    bar), timed eagerly over ``LONG_FORM_ITERS`` calls and as CUDA graphs
    beside SDPA or the bf16 composition (K4: the autograd backward of each)
    and its bound, under the rows ``biased_attention_long_form`` /
    ``biased_attention_bwd_long_form``. Then, at each N, two calls of each
    mode bitwise equal and K2's drawn keep mask bitwise equal to
    ``adrop_mask_plain``; every mode at an odd N with head dims 32 and 48
    (b4) against plain; last, the window modes (pattern, stored p,
    head-major) refuse N = 289 before a launch."""
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask
    inp = Inputs(dev, seed=21)
    bf = torch.bfloat16
    B, C, nH, rate = TRAIN_BATCH, 768, 12, 0.1
    Dh = C // nH
    sc = Dh ** -0.5
    seed = torch.tensor([40503, 777], dtype=torch.int32, device=dev)
    for S in LONG_FORM_N:
        views = 2 if S > 1 + 196 + 1 + CAPTION_TEXT else 1
        qkv, ctx, dctx, kb, qb, amask, qkv3, d4 = _attention_inputs(
            inp, B, S, nH, C, 1 + views * 196, 13)
        kbm, qbm = kb.to(bf)[:, None, None, :], qb.to(bf)[:, None]
        fp, bp = K.attention_plan(S, Dh), K.attention_bwd_plan(S, Dh)
        print(f"K2 long form at S = {S} (b{B}, {nH} heads, head dim {Dh}): "
              f"{fp}: {fp.rows} rows a block, {fp.stages} stages, "
              f"{fp.smem} bytes of shared memory, {fp.sm_blocks} block an "
              f"SM, {B * nH * fp.tiles} blocks; K4: {bp}: {bp.rows} rows a "
              f"block, {bp.stages} stages, {bp.dq_smem} / {bp.dkv_smem} "
              f"bytes (pass 1 / 2), {bp.sm_blocks} block an SM, pass 1 in "
              f"{bp.sweeps} sweeps", flush=True)

        def composed(bias, mask):
            return lambda q, k, v: torch.matmul(torch.softmax(
                torch.matmul(q, k.transpose(-1, -2)) * sc + bias, dim=-1)
                * mask, v)

        def sdpa(bias, p=0.0):
            return lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, dropout_p=p, scale=sc)

        modes = {   # name: (keywords, library forward, inputs read)
            "key bias": (dict(key_bias=kb), sdpa(kbm), (kb,)),
            "key bias + amask": (dict(key_bias=kb, amask=amask),
                                 composed(kbm, amask), (kb, amask)),
            "qbias + amask": (dict(qbias=qb, amask=amask),
                              composed(qbm, amask), (qb, amask)),
            "in-kernel dropout, key bias": (
                dict(key_bias=kb, adrop=(seed, rate)), sdpa(kbm, rate),
                (kb, seed)),
            "in-kernel dropout, qbias": (
                dict(qbias=qb, adrop=(seed, rate)), sdpa(qbm, rate),
                (qb, seed)),
        }
        for mode, (kw, fwd, extra) in modes.items():
            label = f"S = {S}, {mode}"
            chk.case("biased_attention_long_form",
                     lambda kw=kw: K.biased_attention(qkv, nH, S, sc, **kw),
                     lambda kw=kw: K.biased_attention_plain(qkv, nH, S, sc,
                                                            **kw),
                     KERNEL_BAR, library_fn=lambda fwd=fwd: fwd(*qkv3),
                     flops=4.0 * B * nH * S * S * Dh,
                     nbytes=nbytes(qkv, *extra, ctx), graph=True,
                     label=label, iters=LONG_FORM_ITERS)
            chk.case("biased_attention_bwd_long_form",
                     lambda kw=kw: K.biased_attention_bwd(qkv, dctx, nH, S,
                                                          sc, **kw),
                     lambda kw=kw: K.biased_attention_bwd_plain(
                         qkv, dctx, nH, S, sc, **kw),
                     KERNEL_BAR, floor=1e-6, graph=True, label=label,
                     library_fn=library_backward(fwd, qkv3, d4),
                     flops=10.0 * B * nH * S * S * Dh,
                     nbytes=nbytes(qkv, dctx, *extra, kb, qkv),
                     iters=LONG_FORM_ITERS)
        for mode, (kw, _, _) in modes.items():
            for what, fn in (
                    ("K2", lambda: K.biased_attention(qkv, nH, S, sc, **kw)),
                    ("K4", lambda: K.biased_attention_bwd(qkv, dctx, nH, S,
                                                          sc, **kw))):
                one, two = _tensors(fn()), _tensors(fn())
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(one, two)):
                    raise AssertionError(f"{what}'s long form ({mode}, S = "
                                         f"{S}) is not bitwise reproducible")
        _, mask = K.biased_attention(qkv, nH, S, sc, qbias=qb,
                                     adrop=(seed, rate), save_mask=True)
        if not torch.equal(mask, K.adrop_mask_plain(seed, B, nH, S, rate)):
            raise AssertionError(f"K2's long-form Philox mask at S = {S} "
                                 "differs from adrop_mask_plain")
        print(f"K2 / K4 long form at S = {S}: two calls bitwise equal in "
              f"every mode ({list(modes)}); the keep mask bitwise equal to "
              f"adrop_mask_plain (keep fraction "
              f"{(mask > 0).float().mean().item():.5f})", flush=True)
        del amask, mask, qkv3, d4
    # odd N (rows of N f32 start 4 bytes off 8, an amask's 2 bytes off 4:
    # the plain-copy staging) and the narrow heads (head dims 32 and 48, 48
    # padded to a 128-byte row): every mode of K2 and K4 against plain
    for S, h, Dh in ((301, 4, 32), (299, 4, 48)):
        B, C = 4, 4 * Dh
        qkv = inp.rnd(B * S, 3 * C, std=0.5)
        dctx = inp.rnd(B * S, C)
        kb = inp.key_bias([S - 17 * i for i in range(B)], S)
        qb = mask_to_bias(seq2seq_fusion_mask(B, 100, S, dev)).contiguous()
        amask = ((torch.rand(B, h, S, S, generator=inp.gen) < 0.9).to(bf)
                 / 0.9).to(dev)
        worst = 0.0
        for kw in (dict(key_bias=kb), dict(key_bias=kb, amask=amask),
                   dict(qbias=qb, amask=amask),
                   dict(key_bias=kb, adrop=(seed, rate)),
                   dict(qbias=qb, adrop=(seed, rate))):
            sc = Dh ** -0.5
            for fn, ref, floor in (
                    (lambda: K.biased_attention(qkv, h, S, sc, **kw),
                     lambda: K.biased_attention_plain(qkv, h, S, sc, **kw),
                     1.0),
                    (lambda: K.biased_attention_bwd(qkv, dctx, h, S, sc, **kw),
                     lambda: K.biased_attention_bwd_plain(qkv, dctx, h, S,
                                                          sc, **kw), 1e-6)):
                for got, want in zip(_tensors(fn()), _tensors(ref())):
                    err = (got.float() - want.float()).abs().max().item()
                    top = max(want.float().abs().max().item(), floor)
                    worst = max(worst, err / top)
                    if not err <= KERNEL_BAR * top:
                        raise AssertionError(
                            f"long form at S = {S}, head dim {Dh}, "
                            f"{list(kw)}: max abs err {err} > {KERNEL_BAR}"
                            f" x {top}")
        print(f"K2 / K4 long form at S = {S} (b{B}, {h} heads, head dim "
              f"{Dh}): every mode within {KERNEL_BAR} x max|plain| (worst "
              f"{worst:.2e})", flush=True)
    # the window modes keep the register form: N = 289 refused, no launch
    before = (K.biased_attention.launches, K.biased_attention_bwd.launches)
    N, Cs, h = 289, 64, 2
    q289 = inp.rnd(2 * N, 3 * Cs)
    pat = inp.rnd(1, h, N, N, dtype=torch.float32)
    heads = q289.view(2, N, 3, h, Cs // h).permute(2, 0, 3, 1, 4)
    refused = []
    for what, fn in (
            ("K2 pattern", lambda: K.biased_attention(q289, h, N, 0.17, pat)),
            ("K2 stored p", lambda: K.biased_attention(q289, h, N, 0.17,
                                                       save_p=True)),
            ("K2 head-major", lambda: K.biased_attention_heads(
                heads[0], heads[1], heads[2], 0.17)),
            ("K4 pattern", lambda: K.biased_attention_bwd(
                q289, q289[:, :Cs], h, N, 0.17, pattern=pat)),
            ("K4 stored p", lambda: K.biased_attention_bwd(
                q289, q289[:, :Cs].contiguous(), h, N, 0.17,
                p=torch.zeros(2, h, N, N, dtype=bf, device=dev)))):
        try:
            fn()
        except ValueError as e:
            refused.append(f"{what}: {e}")
        else:
            raise AssertionError(f"{what} took N = 289")
    torch.cuda.synchronize()
    if (K.biased_attention.launches,
            K.biased_attention_bwd.launches) != before:
        raise AssertionError("a window mode launched past N = 288")
    print(f"the window modes refuse N = 289 before launching: {refused}",
          flush=True)


def paired_step_phase(dev, card: str, what: str, build, loss_fn, bars,
                      expected: dict, timed_steps: int, n: int = None,
                      extra_checks=None) -> dict:
    """A train step built twice from one seed by ``build(plain)`` (kernels,
    plain): the initial gradients (``loss_fn(model, batch, plain, masks)``)
    held to ``bars``, the launch counts of one step against ``expected``
    (with ``n``, every K2 and K4 launch at N = ``n``: the long form's rows;
    ``extra_checks(counts)`` for more), 3 losses against the plain run
    replaying the masks, then ms/step in turns (plain, kernels, kernels,
    plain) over ``timed_steps`` steps each and the peak memory of a kernel
    step. The caption and retrieval steps and the long-form steps run it.
    Returns its launch counts."""
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_k, batch = build(False)
    step_p, batch_p = build(True)
    labels = batch.get("mlm_labels", batch.get("label"))
    print(f"{what} built twice in {time.perf_counter() - t0:.1f} s: image "
          f"{tuple(batch['image'].shape)}, caption "
          f"{tuple(batch['caption'].shape)}, padded tokens "
          f"{(batch['caption'] == 0).sum().item()}, labels other than -100 "
          f"{(labels != -100).sum().item()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    masks = DropoutMasks(gen, record=True)
    for model, plain, src in ((step_k.model, False, masks),
                              (step_p.model, True, None)):
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch, plain,
                src or DropoutMasks.replay(masks.recorded)).backward()
    torch.cuda.synchronize()
    compare_grads(step_k.model, step_p.model, f"{what} initial gradients",
                  bars)
    del masks
    losses, counts, acc = {"kernels": [], "plain": []}, None, []
    for i in range(TRAIN_STEPS):
        step_k.masks = DropoutMasks(gen, record=True)
        if i == 0:
            reset_counts()
            with attention_lengths() as seen:
                out_k = step_k(batch)
                torch.cuda.synchronize()
            counts = launch_counts()
            print(f"launches in one {what}: {json.dumps(counts)}", flush=True)
            _expect_counts(counts, expected, f"one {what}",
                           [k.__name__ for k in kernels.KERNELS])
            if n is not None:
                long_n_counts(counts, seen, n, what, "long_form",
                              LONG_FORM_FIRST, k4=True)
            if extra_checks is not None:
                extra_checks(counts)
        else:
            out_k = step_k(batch)
        step_p.masks = DropoutMasks.replay(step_k.masks.recorded)
        out_p = step_p(batch_p)
        losses["kernels"].append(out_k["loss"].item())
        losses["plain"].append(out_p["loss"].item())
        if "accuracy" in out_k:
            acc.append((out_k["accuracy"].item(), out_p["accuracy"].item()))
    print(f"{what} losses of {TRAIN_STEPS} steps: {json.dumps(losses)}"
          + (f"; accuracy (kernels, plain) {acc}" if acc else ""), flush=True)
    for i, (a, b) in enumerate(zip(losses["kernels"], losses["plain"])):
        if not (abs(a - b) <= LOSS_BAR * abs(b) and a == a):
            raise AssertionError(f"{what} {i + 1} loss {a} vs plain {b} "
                                 f"beyond {LOSS_BAR} relative")
    times, peak, resident = {"kernels": [], "plain": []}, None, None
    for which in ("plain", "kernels", "kernels", "plain"):
        step, b = (step_k, batch) if which == "kernels" else (step_p, batch_p)
        step.masks = DropoutMasks(torch.Generator(device=dev).manual_seed(2))
        step(b)
        torch.cuda.synchronize()
        measure = which == "kernels" and peak is None
        if measure:
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step(b)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3 / timed_steps)
        if measure:
            peak = torch.cuda.max_memory_allocated()
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    rows = batch["image"].shape[0]
    S = n or 1 + 49 + 1 + batch["caption"].shape[1]
    print(f"{what} ({rows} rows, S = {S}) on {card}: kernels "
          f"{ms['kernels']:.3f} ms/step ({rows * 1e3 / ms['kernels']:.1f} "
          f"samples/s), plain {ms['plain']:.3f} ms/step "
          f"({rows * 1e3 / ms['plain']:.1f} samples/s); runs "
          f"{json.dumps(times)}; peak memory in a kernel step "
          f"{peak / 2 ** 30:.3f} GiB (with {resident / 2 ** 30:.3f} GiB "
          "resident, both models)", flush=True)
    del step_k, step_p, batch, batch_p
    return counts


def _caption_loss(model, batch, plain, masks):
    return model.loss(batch["image"], batch["caption"], batch["mlm_labels"],
                      "unilm", plain=plain, masks=masks)[0]


def _retrieval_loss(model, batch, plain, masks):
    return model.loss(batch["image"], batch["caption"], batch["label"],
                      plain=plain, masks=masks)[0]


def long_grid_phase(dev, card: str) -> dict:
    """The two-view retrieval grid on ViT-B/16 (``LONG_GRID_N`` studies in
    one chunk, captions of 80: S = 474): the launch counts of one grid
    (every K2 launch at N = 474; no K4), P(match) against the plain route,
    two grids bitwise equal, pairs/s of each route. Returns its counts."""
    import numpy as np

    from mvlt_tpu_torch import flagship
    n = LONG_GRID_N
    gc.collect()
    torch.cuda.empty_cache()
    grid, (images, captions, cap_ids) = flagship.build_retrieval_grid(
        n=n, text_len=RETRIEVAL_TEXT, batch_size=n, device=dev,
        config=flagship.flagship_vit_retrieval_config(), views=2)
    S = 1 + 2 * 196 + 1 + captions.shape[1]
    reset_counts()
    with attention_lengths() as seen:
        out_k = grid(images, captions, cap_ids)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one two-view ViT-B/16 grid ({n} x {n}): "
          f"{json.dumps(counts)}", flush=True)
    _expect_counts(counts, EXPECTED_LONG_GRID, "one two-view ViT grid",
                   ("gemm", "biased_attention", "layernorm"))
    long_n_counts(counts, seen, S, "two-view ViT grid", "long_form",
                  LONG_FORM_FIRST)
    if counts["biased_attention_bwd"]:
        raise AssertionError("the grid launched K4")
    again = grid(images, captions, cap_ids)
    if not np.array_equal(out_k["similarities"], again["similarities"]):
        raise AssertionError("two grids differ")
    out_p = grid(images, captions, cap_ids, plain=True)
    _check_close("two-view ViT grid P(match), kernels vs plain",
                 torch.from_numpy(out_k["similarities"]),
                 torch.from_numpy(out_p["similarities"]))
    ms = {}
    for which in ("plain", "kernels"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid(images, captions, cap_ids, plain=which == "plain")
        torch.cuda.synchronize()
        ms[which] = (time.perf_counter() - t0) * 1e3
    print(f"two-view ViT-B/16 grid {n} x {n} (S = {S}) on {card}: kernels "
          f"{ms['kernels']:.1f} ms ({n * n * 1e3 / ms['kernels']:.1f} "
          f"pairs/s), plain {ms['plain']:.1f} ms", flush=True)
    return counts


def long_generate_phase(dev, card: str) -> dict:
    """One generate call on ViT-B/16 with two views (b16, beam 5, IU
    X-Ray's length 80): the launch counts (no K2: the prefill's attention
    and the decode run plain, as JAX's need_kv gate sends them), the
    features, the prefill's logits and the first decode step's against the
    plain route, two calls bitwise equal, and the beam sequences equal to
    the plain route's (printed: random weights leave near-ties). Returns
    its counts."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models import generation as G
    from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
    gc.collect()
    torch.cuda.empty_cache()
    gen, image = flagship.build_caption_generate(
        batch=LONG_GEN_BATCH, num_beams=CAPTION_BEAMS,
        max_length=IU_XRAY_TEXT, device=dev,
        config=flagship.flagship_vit_caption_config(IU_XRAY_TEXT), views=2)
    model, spec = gen.model, gen.spec
    reset_counts()
    with attention_lengths() as seen:
        out_k = gen(image)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one two-view ViT-B/16 generate call (b"
          f"{LONG_GEN_BATCH}, beam {CAPTION_BEAMS}): {json.dumps(counts)}; "
          f"K2 / K4 sequence lengths {json.dumps(seen)}", flush=True)
    _expect_counts(counts, EXPECTED_LONG_GENERATE,
                   "one two-view ViT generate call", ("gemm", "layernorm"))
    if counts["biased_attention"] or counts["biased_attention_bwd"]:
        raise AssertionError("the generate call launched K2 / K4")
    t0 = time.perf_counter()           # the second call: warm
    again = gen(image)
    torch.cuda.synchronize()
    ms_k = (time.perf_counter() - t0) * 1e3
    if not _same(out_k, again):
        raise AssertionError("two generate calls differ")
    t0 = time.perf_counter()
    out_p = gen(image, plain=True)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        feats = [model.encode_image(image, plain) for plain in (False, True)]
        _check_close(f"two-view ViT-B/16 features ({feats[0].shape[1]} "
                     "tokens), kernels vs plain", *feats)
        pre = [G._prefill(model, f, spec, ops)
               for f, ops in zip(feats, (KERNEL_OPS, PLAIN_OPS))]
        _check_close(f"ViT caption prefill logits (prefix {pre[0][2]}), "
                     "kernels vs plain", pre[0][0], pre[1][0])
        first = pre[1][0].argmax(-1)
        step_logits = []
        for (_, kv, P), ops in zip(pre, (KERNEL_OPS, PLAIN_OPS)):
            cache = G._make_cache(model, kv, P, image.shape[0], spec)
            step_logits.append(G._decode_logits(model, cache, first, P, spec,
                                                ops))
        _check_close("ViT caption first decode step logits, kernels vs "
                     "plain", *step_logits)
    same = sum(torch.equal(a, b) for a, b in zip(out_k[0], out_p[0]))
    print(f"two-view ViT-B/16 generate (b{LONG_GEN_BATCH}, beam "
          f"{CAPTION_BEAMS}, length {IU_XRAY_TEXT}) on {card}: kernels "
          f"{ms_k:.1f} ms, plain {ms_p:.1f} ms; {same} of {LONG_GEN_BATCH} "
          "beam sequences equal to the plain route's", flush=True)
    return counts


def long_driver_run() -> None:
    """``python -m mvlt_tpu_torch.run_report_generation --conv vit`` on the
    synthetic IU X-Ray tree (two views: S = 474), one epoch of 3 steps and
    the test, in a process of its own under ``LONG_DRIVER_TIMEOUT``: it
    must exit 0 and print the test's scores."""
    import shutil
    import signal
    trees = iu_xray_trees()
    out_dir = REPO / "build" / "long_form_driver"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [sys.executable, "-m", "mvlt_tpu_torch.run_report_generation",
            "--conv", "vit", "--dataset", "iu_xray", "--data_root",
            str(pathlib.Path(trees["data"]).parent), "--epochs", "1",
            "--batch_size", str(CAPTION_DRIVER_BATCH), "--num_beams",
            str(CAPTION_BEAMS), "--num_workers",
            str(CAPTION_DRIVER_WORKERS), "--do_train", "--do_test",
            "--model_name", str(out_dir)]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LONG_DRIVER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out, flush=True)
        raise AssertionError("run_report_generation --conv vit passed its "
                             f"limit of {LONG_DRIVER_TIMEOUT} s")
    tail = out.strip().splitlines()[-3:]
    print(f"run_report_generation --conv vit --dataset iu_xray (two views, "
          f"S = {LONG_FORM_N[2]}): exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; last lines {tail}", flush=True)
    if proc.returncode != 0 or "CIDEr" not in out:
        print(out, flush=True)
        raise AssertionError("run_report_generation --conv vit failed")


def long_form_phases(dev, card: str) -> dict:
    """The paths of K2 / K4's long form, each against its plain version and
    printing its seconds: the caption step on ViT-B/16 (MIMIC-CXR's text
    150: S = 348), the two-view caption step on the linear patch (IU
    X-Ray's 80: S = 474), the two-view retrieval step on ViT-B/16 (32 pairs
    = 64 rows, attention dropout 0.1: S = 474), the two-view grid, one
    two-view generate call, then a short report generation driver run on
    ViT-B/16. Returns their launch counts by path."""
    from mvlt_tpu_torch import flagship
    B = TRAIN_BATCH
    phases = {
        "vit_caption_step": lambda: paired_step_phase(
            dev, card, "ViT-B/16 caption step",
            lambda plain: flagship.build_caption_train_step(
                batch=B, text_len=CAPTION_TEXT, device=dev, plain=plain,
                config=flagship.flagship_vit_caption_config()),
            _caption_loss, vit_bars, EXPECTED_LONG_CAPTION_STEP,
            LONG_STEP_TIMED, LONG_FORM_N[1]),
        "linear_two_view_caption_step": lambda: paired_step_phase(
            dev, card, "two-view linear-patch caption step",
            lambda plain: flagship.build_caption_train_step(
                batch=B, text_len=IU_XRAY_TEXT, device=dev, plain=plain,
                config=flagship.flagship_linear_caption_config(), views=2),
            _caption_loss, linear_bars, EXPECTED_LONG_CAPTION_STEP,
            LONG_STEP_TIMED, LONG_FORM_N[2]),
        "vit_two_view_retrieval_step": lambda: paired_step_phase(
            dev, card, "two-view ViT-B/16 retrieval step",
            lambda plain: flagship.build_retrieval_train_step(
                pairs=RETRIEVAL_PAIRS, text_len=RETRIEVAL_TEXT, device=dev,
                plain=plain, config=flagship.flagship_vit_retrieval_config(),
                views=2),
            _retrieval_loss, vit_bars, EXPECTED_LONG_RETRIEVAL_STEP,
            LONG_STEP_TIMED, LONG_FORM_N[2]),
        "vit_two_view_retrieval_grid": lambda: long_grid_phase(dev, card),
        "vit_two_view_caption_generate": lambda: long_generate_phase(dev,
                                                                     card),
    }
    out = {}
    for path, phase in phases.items():
        t0 = time.perf_counter()
        out[path] = phase()
        print(f"{path} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    long_driver_run()
    print(f"long-form driver run: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def caption_kernel_checks(chk: Checker, dev) -> None:
    """K2 and K4 at the caption step's fusion shapes: b32, S = 1 + 49 + 1 +
    150 = 201 (Swin-S tokens and a MIMIC-CXR report), 12 heads, head dim
    64, the seq2seq qbias with an attention-dropout mask (what rows 15 and
    16 give them in the step), each against its plain version, the library
    composition (K4: its autograd backward) and its bound, eagerly and as
    CUDA graphs, as rows of their own (``biased_attention_n201``,
    ``biased_attention_bwd_n201``)."""
    seq2seq_attention_checks(chk, dev, 49, CAPTION_TEXT, "n201", seed=9)


def iu_xray_kernel_checks(chk: Checker, dev) -> None:
    """K2 and K4 at the two-view caption step's fusion shapes: b32, S = 1 +
    2 x 49 + 1 + 80 = 180 (two Swin-S views and an IU X-Ray report; three
    64-row query tiles, the last with 52 rows live), the seq2seq qbias over
    a 100-column prefix with an attention-dropout mask, as
    :func:`caption_kernel_checks` holds them at S = 201, as rows of their
    own (``biased_attention_n180``, ``biased_attention_bwd_n180``)."""
    seq2seq_attention_checks(chk, dev, 2 * 49, IU_XRAY_TEXT, "n180", seed=13)


def seq2seq_attention_checks(chk: Checker, dev, image_tokens: int,
                             text: int, tag: str, seed: int) -> None:
    """K2 and K4 at b32, S = 1 + ``image_tokens`` + 1 + ``text``, 12 heads,
    head dim 64, with the seq2seq qbias (the image prefix and [SEP]
    visible to every row, the text causal) and an attention-dropout mask,
    against their plain versions, the library and the bound, eagerly and as
    CUDA graphs, under ``biased_attention_<tag>`` / ``biased_attention_bwd_
    <tag>``."""
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask
    inp = Inputs(dev, seed=seed)
    bf = torch.bfloat16
    B, C, nH, S = TRAIN_BATCH, 768, 12, 1 + image_tokens + 1 + text
    Dh = C // nH
    sc = Dh ** -0.5
    qkv = inp.rnd(B * S, 3 * C, std=0.5)
    ctx = torch.empty(B * S, C, dtype=bf, device=dev)
    qb = mask_to_bias(seq2seq_fusion_mask(B, image_tokens + 1, S,
                                          dev)).contiguous()
    amask = ((torch.rand(B, nH, S, S, generator=inp.gen) < 0.9).to(bf)
             / 0.9).to(dev)
    print(f"K2 at S = {S} (b{B}, {nH} heads, head dim {Dh}): "
          f"{K.attention_plan(S, Dh)}; K4: {K.attention_bwd_plan(S, Dh)}",
          flush=True)
    chk.case(f"biased_attention_{tag}",
             lambda: K.biased_attention(qkv, nH, S, sc, qbias=qb,
                                        amask=amask),
             lambda: K.biased_attention_plain(qkv, nH, S, sc, qbias=qb,
                                              amask=amask),
             KERNEL_BAR,
             library_fn=lambda: lib_masked_attention(
                 qkv, B, S, nH, qb.to(bf)[:, None], amask, sc),
             flops=4.0 * B * nH * S * S * Dh,
             nbytes=nbytes(qkv, qb, amask, ctx), graph=True)
    dctx = inp.rnd(B * S, C)
    t = qkv.view(B, S, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    qkv3 = (t[0].contiguous(), t[1].contiguous(), t[2].contiguous())
    d4 = dctx.view(B, S, nH, Dh).permute(0, 2, 1, 3).contiguous()
    qbm = qb.to(bf)[:, None]
    chk.case(f"biased_attention_bwd_{tag}",
             lambda: K.biased_attention_bwd(qkv, dctx, nH, S, sc, qbias=qb,
                                            amask=amask),
             lambda: K.biased_attention_bwd_plain(qkv, dctx, nH, S, sc,
                                                  qbias=qb, amask=amask),
             KERNEL_BAR, floor=1e-6, graph=True,
             library_fn=library_backward(
                 lambda q, k, v: torch.matmul(torch.softmax(
                     torch.matmul(q, k.transpose(-1, -2)) * sc + qbm, dim=-1)
                     * amask, v), qkv3, d4),
             flops=10.0 * B * nH * S * S * Dh,
             nbytes=nbytes(qkv, dctx, qb, amask, qkv))
    del amask


def retrieval_kernel_checks(chk: Checker, dev) -> None:
    """K2 at the retrieval grid's score-call shape: b64, S = 1 + 49 + 1 + 80
    = 131, 12 heads, head dim 64, the key bias of padded captions (what row
    4 gives it there: 64 x 12 x 131^2 = 13.2 M scores a call), against its
    plain version, SDPA and its bound, eagerly and as CUDA graphs, as a row
    of its own (``biased_attention_b64``)."""
    from mvlt_tpu_torch.ops import kernels as K
    inp = Inputs(dev, seed=11)
    bf = torch.bfloat16
    B, C, nH, S = RETRIEVAL_CHUNK, 768, 12, 1 + 49 + 1 + RETRIEVAL_TEXT
    Dh = C // nH
    sc = Dh ** -0.5
    qkv = inp.rnd(B * S, 3 * C, std=0.5)
    ctx = torch.empty(B * S, C, dtype=bf, device=dev)
    lengths = (torch.randint(5, RETRIEVAL_TEXT + 1, (B,), generator=inp.gen)
               + 51).tolist()
    kb = inp.key_bias(lengths, S)
    print(f"K2 at the retrieval score call (b{B}, S = {S}, {nH} heads, head "
          f"dim {Dh}): {K.attention_plan(S, Dh)}", flush=True)
    chk.case("biased_attention_b64",
             lambda: K.biased_attention(qkv, nH, S, sc, None, kb),
             lambda: K.biased_attention_plain(qkv, nH, S, sc, None, kb),
             KERNEL_BAR,
             library_fn=lambda: lib_attention(qkv, B, S, nH,
                                              kb.to(bf)[:, None, None, :], sc),
             flops=4.0 * B * nH * S * S * Dh,
             nbytes=nbytes(qkv, kb, ctx), graph=True)


def attention_repeat_checks(dev) -> None:
    """Two calls of K2 on the same inputs are bitwise equal in every mode
    (no atomics, one fixed order of sums), at the pretrain step's fusion
    shapes (b32, S = 131, 12 heads) and Swin-S stage 3 (b32, 128 windows
    of 49, 12 heads); then K2 refuses what its plan or its 16-byte loader
    cannot take (N = 46,341, past the long form's cap; N = 289 in pattern
    mode; head dim 24; a misaligned view) with a ``ValueError`` before any
    launch."""
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask
    inp = Inputs(dev, seed=7)
    bf = torch.bfloat16
    B, S, C, nH = TRAIN_BATCH, 1 + 49 + 1 + PRETRAIN_TEXT, 768, 12
    qkv = inp.rnd(B * S, 3 * C, std=0.5)
    kb = inp.key_bias([S - (11 * i) % 75 for i in range(B)], S)
    qb = mask_to_bias(seq2seq_fusion_mask(B, 50, S, dev)).contiguous()
    am = ((torch.rand(B, nH, S, S, generator=inp.gen) < 0.9).to(bf)
          / 0.9).to(dev)
    seed = torch.tensor([40503, 99], dtype=torch.int32, device=dev)
    sc = (C // nH) ** -0.5
    BW, N, Cs = B * 4, 49, 384
    wq = inp.rnd(BW * N, 3 * Cs, std=0.5)
    pats = {1: inp.rnd(1, nH, N, N, std=0.5, dtype=torch.float32),
            4: inp.rnd(4, nH, N, N, std=0.5, dtype=torch.float32)}
    q, k, v = wq.view(BW, N, 3, nH, Cs // nH).permute(2, 0, 3, 1, 4).unbind(0)
    ss = (Cs // nH) ** -0.5
    modes = {
        "key bias": lambda: K.biased_attention(qkv, nH, S, sc, key_bias=kb),
        "qbias + amask": lambda: K.biased_attention(qkv, nH, S, sc, qbias=qb,
                                                    amask=am),
        "key bias + amask": lambda: K.biased_attention(qkv, nH, S, sc,
                                                       key_bias=kb, amask=am),
        "in-kernel dropout, seq2seq": lambda: K.biased_attention(
            qkv, nH, S, sc, qbias=qb, adrop=(seed, 0.1), save_mask=True),
        "stored p, key bias": lambda: K.biased_attention(
            qkv, nH, S, sc, key_bias=kb, save_p=True),
        "pattern P = 1": lambda: K.biased_attention(wq, nH, N, ss, pats[1]),
        "pattern P = 4, stored p": lambda: K.biased_attention(
            wq, nH, N, ss, pats[4], save_p=True),
        "head-major P = 4": lambda: K.biased_attention_heads(q, k, v, ss,
                                                             pats[4]),
    }
    for name, fn in modes.items():
        one, two = _tensors(fn()), _tensors(fn())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"K2 ({name}) is not bitwise reproducible")
    print(f"K2, two calls bitwise equal in every mode: {list(modes)}",
          flush=True)
    before = K.biased_attention.launches
    refused = []
    for what, fn in (
            ("N = 46,341", lambda: K.biased_attention(
                torch.empty(2 * 46341, 3 * 128, dtype=bf, device=dev), 2,
                46341, 0.125)),
            ("N = 289 with a pattern", lambda: K.biased_attention(
                inp.rnd(2 * 289, 3 * 128), 2, 289, 0.125,
                inp.rnd(1, 2, 289, 289, dtype=torch.float32))),
            ("head dim 24", lambda: K.biased_attention(
                inp.rnd(2 * 49, 3 * 72), 3, 49, 0.2)),
            ("a view 2 bytes off 16", lambda: K.biased_attention_heads(
                *inp.rnd(3, 2, 2, 49, 33)[..., 1:].unbind(0), 0.17))):
        try:
            fn()
        except ValueError as e:
            refused.append(f"{what}: {e}")
        else:
            raise AssertionError(f"K2 took {what}")
    torch.cuda.synchronize()
    if K.biased_attention.launches != before:
        raise AssertionError("K2 launched for a call it refused")
    print(f"K2 refuses before launching: {refused}", flush=True)


def attention_bwd_repeat_checks(dev) -> None:
    """Two calls of K4 on the same inputs are bitwise equal in every mode
    (no atomics; the sums over heads, query tiles and groups in one fixed
    order), at the pretrain step's fusion shapes (b32, S = 131, 12 heads)
    and Swin-S stage 3 (b32: 128 windows of 49, 12 heads); then K4 refuses
    what its plan or its 16-byte loader cannot take (N = 46,341; N = 289 in
    pattern mode; head dim 24; a misaligned view) with a ``ValueError``
    before any launch."""
    from mvlt_tpu_torch.ops import kernels as K
    from mvlt_tpu_torch.ops.masks import mask_to_bias, seq2seq_fusion_mask
    inp = Inputs(dev, seed=8)
    bf = torch.bfloat16
    B, S, C, nH = TRAIN_BATCH, 1 + 49 + 1 + PRETRAIN_TEXT, 768, 12
    qkv, dctx = inp.rnd(B * S, 3 * C, std=0.5), inp.rnd(B * S, C)
    kb = inp.key_bias([S - (11 * i) % 75 for i in range(B)], S)
    qb = mask_to_bias(seq2seq_fusion_mask(B, 50, S, dev)).contiguous()
    am = ((torch.rand(B, nH, S, S, generator=inp.gen) < 0.9).to(bf)
          / 0.9).to(dev)
    seed = torch.tensor([40503, 99], dtype=torch.int32, device=dev)
    sc = (C // nH) ** -0.5
    _, p = K.biased_attention(qkv, nH, S, sc, key_bias=kb, save_p=True)
    BW, N, Cs = B * 4, 49, 384
    wq, wd = inp.rnd(BW * N, 3 * Cs, std=0.5), inp.rnd(BW * N, Cs)
    pats = {1: inp.rnd(1, nH, N, N, std=0.5, dtype=torch.float32),
            4: inp.rnd(4, nH, N, N, std=0.5, dtype=torch.float32)}
    ss = (Cs // nH) ** -0.5
    _, p4 = K.biased_attention(wq, nH, N, ss, pats[4], save_p=True)
    wkb = inp.key_bias([N - i % 9 for i in range(BW)], N)

    def k4(*args, **kw):
        return lambda: K.biased_attention_bwd(*args, **kw)

    modes = {
        "key bias": k4(qkv, dctx, nH, S, sc, kb),
        "qbias + amask": k4(qkv, dctx, nH, S, sc, qbias=qb, amask=am),
        "key bias + amask": k4(qkv, dctx, nH, S, sc, kb, amask=am),
        "regenerated dropout, key bias": k4(qkv, dctx, nH, S, sc, kb,
                                            adrop=(seed, 0.1)),
        "regenerated dropout, seq2seq": k4(qkv, dctx, nH, S, sc, qbias=qb,
                                           adrop=(seed, 0.1)),
        "stored p, key bias": k4(qkv, dctx, nH, S, sc, kb, p=p),
        "pattern P = 1": k4(wq, wd, nH, N, ss, pattern=pats[1]),
        "pattern P = 4 + key bias": k4(wq, wd, nH, N, ss, wkb,
                                       pattern=pats[4]),
        "pattern P = 4, stored p": k4(wq, wd, nH, N, ss, pattern=pats[4],
                                      p=p4),
    }
    for name, fn in modes.items():
        one, two = _tensors(fn()), _tensors(fn())
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"K4 ({name}) is not bitwise reproducible")
    print(f"K4, two calls bitwise equal in every mode: {list(modes)}",
          flush=True)
    before = K.biased_attention_bwd.launches
    refused = []
    for what, fn in (
            ("N = 46,341", k4(torch.empty(2 * 46341, 3 * 128, dtype=bf,
                                          device=dev),
                              torch.empty(2 * 46341, 128, dtype=bf,
                                          device=dev), 2, 46341, 0.125)),
            ("N = 289 with a pattern", k4(
                inp.rnd(2 * 289, 3 * 128), inp.rnd(2 * 289, 128), 2, 289,
                0.125, pattern=inp.rnd(1, 2, 289, 289,
                                       dtype=torch.float32))),
            ("head dim 24", k4(inp.rnd(2 * 49, 3 * 72), inp.rnd(2 * 49, 72),
                               3, 49, 0.2)),
            ("a view 2 bytes off 16", k4(
                inp.rnd(2 * 49 * 3 * 64 + 1)[1:].view(2 * 49, 3 * 64),
                inp.rnd(2 * 49, 64), 2, 49, 0.17))):
        try:
            fn()
        except ValueError as e:
            refused.append(f"{what}: {e}")
        else:
            raise AssertionError(f"K4 took {what}")
    torch.cuda.synchronize()
    if K.biased_attention_bwd.launches != before:
        raise AssertionError("K4 launched for a call it refused")
    print(f"K4 refuses before launching: {refused}", flush=True)


def k2_report(dev) -> None:
    """Print what K2's library was compiled to (its SASS instruction counts:
    HGMMA is ``wgmma`` (S = Q K^T and P V), LDGSTS a cp.async copy, UTMALDG
    a TMA load (the long form's), HMMA an ``mma.sync``; and per template
    instance, (key chunks, head columns), its registers and stack bytes a
    thread, where spills go; ``long x<cols>`` the long form's instances,
    whose ptxas report (registers, spills) follows) and the K2 wrapper's
    host time per call at a small shape beside one SDPA call's, and at a
    long-form shape (N = 298: three tensor maps encoded a call)."""
    import re
    from mvlt_tpu_torch.ops import kernels as K
    path = K.build()["attention"]._name
    tool = pathlib.Path(K._nvcc()).with_name("cuobjdump")
    try:
        sass = cuobjdump("-sass", path)
        ops = {op: len(re.findall(rf"\b{op}\b", sass))
               for op in ("HGMMA", "LDGSTS", "UTMALDG", "HMMA")}
        usage = cuobjdump("-res-usage", path)
        regs = {f"{nc}x{cols}": (int(r), int(st)) for nc, cols, r, st in
                re.findall(r"attention_wgmma_kernelILi(\d+)ELi(\d+)E\S*"
                           r"\s+REG:(\d+) STACK:(\d+)", usage)}
        regs.update({f"long x{cols}": (int(r), int(st)) for cols, r, st in
                     re.findall(r"attention_long_kernelILi(\d+)E\S*"
                                r"\s+REG:(\d+) STACK:(\d+)", usage)})
    except (OSError, subprocess.SubprocessError) as e:
        ops = regs = f"not read ({e})"
    print(f"K2 SASS ({tool.name} -sass {pathlib.Path(path).name}): {ops}",
          flush=True)
    print(f"K2 registers, stack bytes per (key chunks x head columns) "
          f"({tool.name} -res-usage): {regs}", flush=True)
    for kernel, lines in K.ptxas_report("attention", "long_kernel").items():
        print(f"ptxas -v, {kernel}: {' | '.join(lines)}", flush=True)
    if isinstance(ops, dict) and ops["HGMMA"] <= 0:
        raise AssertionError("K2 was compiled without wgmma")
    G, N, C, nH = 2, 64, 128, 2
    qkv = torch.randn(G * N, 3 * C, device=dev).to(torch.bfloat16)
    t = qkv.view(G, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4)
    long_qkv = torch.randn(G * 298, 3 * C, device=dev).to(torch.bfloat16)
    us = {}
    for name, fn in (("K2 biased_attention",
                      lambda: K.biased_attention(qkv, nH, N, 0.125)),
                     ("SDPA", lambda: F.scaled_dot_product_attention(
                         t[0], t[1], t[2], scale=0.125)),
                     ("K2's long form at N = 298",
                      lambda: K.biased_attention(long_qkv, nH, 298, 0.125))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print(f"host time per call at G = {G}, N = {N}, C = {C}, 2000 enqueues: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()), flush=True)


def k4_report(dev) -> None:
    """Print what K4's library was compiled to: its SASS instruction counts
    (HGMMA is ``wgmma``: every product of both passes; HMMA an
    ``mma.sync``, LDGSTS a cp.async copy, ATOM / RED an atomic, which K4
    must not use) and, per template instance (pass 1: key chunks x head
    columns; pass 2: head columns; the long form's passes by head
    columns), its registers and stack bytes a thread, and the long form's
    ptxas report (registers, spills); then the K4 wrapper's host time per
    call at a small shape and at a long-form shape (N = 298: two tensor
    maps encoded a call)."""
    import re
    from mvlt_tpu_torch.ops import kernels as K
    path = K.build()["attention_bwd"]._name
    tool = pathlib.Path(K._nvcc()).with_name("cuobjdump")
    try:
        sass = cuobjdump("-sass", path)
        ops = {op: len(re.findall(rf"\b{op}\b", sass))
               for op in ("HGMMA", "HMMA", "LDGSTS")}
        ops["ATOM/RED"] = len(re.findall(r"\b(?:ATOM\w*|RED)\b", sass))
        usage = cuobjdump("-res-usage", path)
        regs = {f"dq {nc}x{cols}": (int(r), int(st)) for nc, cols, r, st in
                re.findall(r"attention_bwd_dq_kernelILi(\d+)ELi(\d+)E\S*"
                           r"\s+REG:(\d+) STACK:(\d+)", usage)}
        regs.update({f"dkv {cols}": (int(r), int(st)) for cols, r, st in
                     re.findall(r"attention_bwd_dkv_kernelILi(\d+)E\S*"
                                r"\s+REG:(\d+) STACK:(\d+)", usage)})
        regs.update({f"{what} long {cols}": (int(r), int(st))
                     for what, cols, r, st in re.findall(
                         r"attention_bwd_(dq|dkv)_long_kernelILi(\d+)E\S*"
                         r"\s+REG:(\d+) STACK:(\d+)", usage)})
    except (OSError, subprocess.SubprocessError) as e:
        ops = regs = f"not read ({e})"
    print(f"K4 SASS ({tool.name} -sass {pathlib.Path(path).name}): {ops}",
          flush=True)
    print(f"K4 registers, stack bytes per instance ({tool.name} -res-usage):"
          f" {regs}", flush=True)
    if isinstance(ops, dict) and not (ops["HGMMA"] > 0 and ops["HMMA"] == 0
                                      and ops["ATOM/RED"] == 0):
        raise AssertionError(f"K4 was not compiled to wgmma alone: {ops}")
    for kernel, lines in K.ptxas_report("attention_bwd",
                                        "long_kernel").items():
        print(f"ptxas -v, {kernel}: {' | '.join(lines)}", flush=True)
    G, C, nH = 2, 128, 2
    us = {}
    for N in (64, 298):
        qkv = torch.randn(G * N, 3 * C, device=dev).to(torch.bfloat16)
        dctx = torch.randn(G * N, C, device=dev).to(torch.bfloat16)
        for _ in range(200):
            K.biased_attention_bwd(qkv, dctx, nH, N, 0.125)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            K.biased_attention_bwd(qkv, dctx, nH, N, 0.125)
        us[N] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print(f"host time per call at G = {G}, C = {C}, 2000 enqueues: K4 "
          f"biased_attention_bwd {us[64]:.2f} us at N = 64, its long form "
          f"{us[298]:.2f} us at N = 298", flush=True)


def k5_report(dev) -> None:
    """Print what K3's and K5's libraries were compiled to: per template
    instance (``<lanes, chunks>``) and kernel, its registers, stack and
    local (spill) bytes a thread (``cuobjdump -res-usage``); K5's SASS count
    of atomics (ATOM / RED, f32 or not), which it must not use (its sums run
    in a fixed order); then the wrappers' host time per call at a small
    shape beside ``torch.sum``'s and ``F.layer_norm``'s."""
    import re
    from mvlt_tpu_torch.ops import kernels as K
    tool = pathlib.Path(K._nvcc()).with_name("cuobjdump")
    libs = K.build()
    for name, kern in (("K3", "layernorm"), ("K5", "layernorm_bwd")):
        path = libs[kern]._name
        try:
            usage = cuobjdump("-res-usage", path)
            found = re.findall(r"((?:ln_bwd|colsum|fold|layernorm)_kernel)"
                               r"(?:ILi(\d+)ELi(\d+)E)?\S*\s+"
                               r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
                               usage)
            regs = {(f"{k}<{g}, {j}>" if g else k): tuple(map(int, rest))
                    for k, g, j, *rest in found}
            sass = cuobjdump("-sass", path)
            atoms = len(re.findall(r"\b(?:ATOM|ATOMG|ATOMS|RED)\.\S*", sass))
            f32 = len(re.findall(r"\b(?:ATOM|ATOMG|ATOMS|RED)\.\S*F32", sass))
        except (OSError, subprocess.SubprocessError) as e:
            regs, atoms, f32 = f"not read ({e})", None, None
        print(f"{name} registers, stack, local bytes a thread per instance "
              f"({tool.name} -res-usage {pathlib.Path(path).name}): {regs}",
              flush=True)
        print(f"{name} SASS atomics: {atoms} (f32: {f32})", flush=True)
        if atoms:
            raise AssertionError(f"{name} was compiled with {atoms} atomics")
    bf = torch.bfloat16
    x = torch.randn(64, 96, device=dev)
    g = torch.randn(64, 96, device=dev).to(bf)
    gam, beta = torch.ones(96, device=dev), torch.zeros(96, device=dev)
    us = {}
    for name, fn in (
            ("K5 layernorm_bwd", lambda: K.layernorm_bwd(x, gam, g, 1e-5)),
            ("K5 column_sum", lambda: K.column_sum(g)),
            ("torch.sum", lambda: torch.sum(g, 0, dtype=torch.float32)),
            ("K3 layernorm", lambda: K.layernorm(x, gam, beta, 1e-5,
                                                 out_dtype=bf)),
            ("F.layer_norm", lambda: F.layer_norm(x, (96,), gam, beta))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print("host time per call at (64, 96), 2000 enqueues: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()), flush=True)


# cuobjdump's outputs the reports read, started in the background after the
# build (``start_dumps``): (flag, library path) -> future
_DUMPS = {}


def _cuobjdump(flag: str, path: str) -> str:
    from mvlt_tpu_torch.ops import kernels as K
    tool = pathlib.Path(K._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), flag, path], capture_output=True,
                          text=True, timeout=120).stdout


def cuobjdump(flag: str, path: str) -> str:
    """``cuobjdump <flag> <path>``'s output: the background run's, if
    :func:`start_dumps` started one, else a run now. Raises what the run
    raised."""
    future = _DUMPS.get((flag, path))
    return future.result() if future is not None else _cuobjdump(flag, path)


def start_dumps() -> None:
    """Start the reports' cuobjdump runs (each library's SASS and resource
    usage; seconds each for K2's and K4's many template instances) in
    background threads, so that they run beside the kernel checks."""
    from concurrent.futures import ThreadPoolExecutor
    from mvlt_tpu_torch.ops import kernels as K
    libs = K.build()
    pool = ThreadPoolExecutor(max_workers=4)
    for name in ("attention_bwd", "attention", "layernorm_bwd", "layernorm",
                 "gemm"):
        for flag in ("-sass", "-res-usage"):
            path = libs[name]._name
            _DUMPS[(flag, path)] = pool.submit(_cuobjdump, flag, path)
    pool.shutdown(wait=False)


def norm_plan_checks() -> None:
    """K3's and K5's plans in C (``mvlt_layernorm_plan``,
    ``mvlt_layernorm_bwd_plan``, ``mvlt_column_sum_plan``) equal the Python
    ones the wrappers allocate from, over a sweep of rows and widths (every
    C up to one past each cap, every N up to 4100 at a stride) at 132 SMs
    and at this card's count; both refuse the same shapes."""
    import ctypes
    from mvlt_tpu_torch.ops import kernels as K
    libs = K.build()
    out = (ctypes.c_int * 8)()
    sms_list = sorted({K.H100_SMS, K._sm_count(0)})

    def c_plan(fn, *args, n):
        rc = fn(*args, out)
        return None if rc != 0 else tuple(out[:n])

    def py_plan(fn, *args, n):
        try:
            return tuple(int(v) for v in fn(*args)[:n])
        except ValueError:
            return None

    rows = (1, 2, 7, 31, 32, 33, 49, 127, 128, 129, 1000, 2368, 4192, 6272,
            25088, 100352, 131072)
    count = 0
    for M in rows:
        for C in range(0, K.LAYERNORM_MAX_C + 2):
            want = py_plan(K.layernorm_plan, M, C, n=5)
            got = c_plan(libs["layernorm"].mvlt_layernorm_plan, M, C, n=5)
            assert got == want, ("layernorm", M, C, got, want)
            count += 1
            if C > K.LAYERNORM_BWD_MAX_C + 1:
                continue
            for sms in sms_list:
                want = py_plan(K.layernorm_bwd_plan, M, C, sms, n=6)
                got = c_plan(libs["layernorm_bwd"].mvlt_layernorm_bwd_plan,
                             M, C, sms, n=6)
                assert got == want, ("layernorm_bwd", M, C, sms, got, want)
                count += 1
        for N in (*range(0, 300), *range(300, 4101, 7), 4608):
            for sms in sms_list:
                want = py_plan(K.column_sum_plan, M, N, sms, n=5)
                got = c_plan(libs["layernorm_bwd"].mvlt_column_sum_plan, M, N,
                             sms, n=5)
                assert got == want, ("column_sum", M, N, sms, got, want)
                count += 1
    print(f"K3 / K5 plans in C and Python agree on {count} shapes (M in "
          f"{rows[0]} .. {rows[-1]}, SMs {sms_list}), refusals included",
          flush=True)


def k1_report(dev) -> None:
    """Print what K1's library was compiled to (its SASS instruction counts:
    HGMMA is ``wgmma``, UTMALDG a TMA load; HMMA / LDSM would be the
    ``mma.sync`` / ``ldmatrix`` path) and the K1 wrapper's host time per
    call at a small shape beside one ``F.linear`` call's."""
    import re
    from mvlt_tpu_torch.ops import kernels as K
    path = K.build()["gemm"]._name
    tool = pathlib.Path(K._nvcc()).with_name("cuobjdump")
    try:
        sass = cuobjdump("-sass", path)
        ops = {op: len(re.findall(rf"\b{op}\b", sass))
               for op in ("HGMMA", "UTMALDG", "HMMA", "LDSM")}
    except (OSError, subprocess.SubprocessError) as e:
        ops = f"not read ({e})"
    print(f"K1 SASS ({tool.name} -sass {pathlib.Path(path).name}): {ops}",
          flush=True)
    a = torch.randn(64, 64, device=dev).to(torch.bfloat16)
    w = torch.randn(64, 64, device=dev).to(torch.bfloat16)
    us = {}
    for name, fn in (("K1 gemm", lambda: K.gemm(a, w)),
                     ("F.linear", lambda: F.linear(a, w))):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print("host time per call at (64, 64) x (64, 64), 2000 enqueues: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in us.items()), flush=True)


def swin_gemm_checks(chk: Checker, dev) -> None:
    """K1 at the Swin-S b32 shapes of the step of record, stage by stage
    (M = 32 * H * W rows): the NT forwards (qkv; fc1 with GELU and the
    saved pre-activation), the NN data gradients (da1 with GELU'; dh2 and
    dh1 in f32) and the four TN weight gradients (f32), each beside its
    one-call yardstick (``F.linear`` / ``torch.matmul`` of the same
    product). Kept per layout (``gemm_swin_nt`` / ``_nn`` / ``_tn``, not in
    the kernels line); the TN products that the plan splits also make the
    ``gemm_splitk`` row, and each is held bitwise over two calls."""
    from mvlt_tpu_torch.ops import kernels as K
    inp = Inputs(dev, seed=5)
    rnd, dense = inp.rnd, inp.dense
    f32 = torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = []
    for res, C, _ in SWIN_STAGES:
        M, I = TRAIN_BATCH * res * res, 4 * C
        h, dmlp = rnd(M, C), rnd(M, C, std=0.1)
        (wq, bq), (w1, b1), (w2, _) = dense(C, 3 * C), dense(C, I), dense(I, C)
        m, a1, dqkv = rnd(M, I), rnd(M, I, dtype=f32), rnd(M, 3 * C, std=0.1)
        da1 = rnd(M, I, std=0.1)
        cases = [
            ("nt", "qkv", h, wq, bq, {}, lambda: F.linear(h, wq, bq)),
            ("nt", "fc1 + GELU, saving the pre-activation", h, w1, b1,
             dict(gelu=True, save_preact=True), lambda: F.linear(h, w1, b1)),
            ("nn", "da1 = dmlp W2 * GELU'(a1)", dmlp, w2, None,
             dict(gelu_grad=a1), lambda: torch.matmul(dmlp, w2)),
            ("nn", "dh2 = da1 W1 (f32)", da1, w1, None, dict(out_dtype=f32),
             lambda: torch.matmul(da1, w1)),
            ("nn", "dh1 = dqkv Wqkv (f32)", dqkv, wq, None,
             dict(out_dtype=f32), lambda: torch.matmul(dqkv, wq)),
            ("tn", "dW2 = dmlp^T m", dmlp, m, None, dict(out_dtype=f32),
             lambda: torch.matmul(dmlp.t(), m)),
            ("tn", "dW1 = da1^T h", da1, h, None, dict(out_dtype=f32),
             lambda: torch.matmul(da1.t(), h)),
            ("tn", "dWqkv = dqkv^T h", dqkv, h, None, dict(out_dtype=f32),
             lambda: torch.matmul(dqkv.t(), h)),
            ("tn", "dWproj = dmlp^T h", dmlp, h, None, dict(out_dtype=f32),
             lambda: torch.matmul(dmlp.t(), h)),
        ]
        for layout, what, a, w, b, kw, lib in cases:
            kw = dict(kw, layout=layout)
            if layout == "tn":
                (kk, mm), nn_ = a.shape, w.shape[1]
            else:
                (mm, kk), nn_ = a.shape, (w.shape[0] if layout == "nt"
                                          else w.shape[1])
            before = K.gemm.splitk_launches      # did the wrapper split it?
            K.gemm(a, w, b, **kw)
            splits = (K.gemm_plan(mm, nn_, kk, sms).splits
                      if K.gemm.splitk_launches > before else 1)
            outs = [torch.empty(mm, nn_, dtype=kw.get("out_dtype", a.dtype),
                                device=dev)]
            if kw.get("save_preact"):
                outs.append(torch.empty(mm, nn_, dtype=f32, device=dev))
            also = ("gemm_splitk",) if splits > 1 else ()
            print(f"K1 at Swin-S stage C = {C}, {layout} {what}: "
                  f"({mm}, {kk}) x ({kk}, {nn_}), {splits} slice(s)",
                  flush=True)
            chk.case(f"gemm_swin_{layout}",
                     lambda a=a, w=w, b=b, kw=kw: K.gemm(a, w, b, **kw),
                     lambda a=a, w=w, b=b, kw=kw: K.gemm_plain(a, w, b, **kw),
                     KERNEL_BAR, library_fn=lib, flops=2.0 * mm * kk * nn_,
                     nbytes=nbytes(a, w, b, kw.get("gelu_grad"), *outs),
                     also=also)
            if splits > 1:
                one, two = K.gemm(a, w, **kw), K.gemm(a, w, **kw)
                torch.cuda.synchronize()
                if not torch.equal(one, two):
                    raise AssertionError(f"K1 split-K ({what}, C = {C}) is "
                                         "not bitwise reproducible")
                split.append(f"C = {C} {what.split(' = ')[0]} "
                             f"({splits} slices)")
    print(f"K1 split-K, two calls bitwise equal: {split}", flush=True)
    for layout in ("nt", "nn", "tn"):
        r = chk.row(f"gemm_swin_{layout}")
        print(f"K1 at the Swin-S b32 shapes, {layout} over 4 stages: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max abs err {r['max_abs_err']:.3g}",
              flush=True)


@contextlib.contextmanager
def attention_lengths():
    """Records the sequence length N of every K2 / K4 call of the
    counterparts inside (their ``KERNEL_OPS`` entries wrapped): yields
    ``{"biased_attention": {N: calls}, "biased_attention_bwd": {N:
    calls}}``."""
    from mvlt_tpu_torch.ops import blocks
    seen = {"biased_attention": {}, "biased_attention_bwd": {}}
    ops = blocks.KERNEL_OPS
    saved = ops.attention, ops.attention_bwd

    def record(fn, name, at):
        def call(*a, **kw):
            seen[name][a[at]] = seen[name].get(a[at], 0) + 1
            return fn(*a, **kw)
        return call

    ops.attention = record(saved[0], "biased_attention", 2)
    ops.attention_bwd = record(saved[1], "biased_attention_bwd", 3)
    try:
        yield seen
    finally:
        ops.attention, ops.attention_bwd = saved


def long_n_counts(counts: dict, seen: dict, n: int, what: str,
                  row: str = "long_n", first: int = VIT_VQA_N,
                  k4: bool = False) -> None:
    """Adds to ``counts`` the K2 / K4 launches at N >= ``first`` (the
    ``*_<row>`` rows: ``long_n`` from 221, ``long_form`` past 288) from
    ``seen`` (:func:`attention_lengths`), after checking that every K2 (and
    K4) launch of the path ran at N = ``n`` and that K2 (with ``k4`` K4
    too) launched there."""
    print(f"{what}: K2 / K4 sequence lengths {json.dumps(seen)}",
          flush=True)
    for name in seen:
        if seen[name] and set(seen[name]) != {n}:
            raise AssertionError(f"{what}: {name} ran at N = "
                                 f"{sorted(seen[name])}, expected {n}")
        if seen[name].get(n, 0) != counts[name]:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times, {seen[name].get(n, 0)} at N = {n}")
        counts[f"{name}_{row}"] = sum(c for k, c in seen[name].items()
                                      if k >= first)
    for name in ("biased_attention", "biased_attention_bwd")[:1 + k4]:
        if not counts[f"{name}_{row}"]:
            raise AssertionError(f"{what}: {name} never launched at N = "
                                 f"{n}")


def launch_counts() -> dict:
    from mvlt_tpu_torch.ops import blocks, kernels
    counts = {k.__name__: k.launches for k in kernels.KERNELS}
    for k, modes in kernels.MODE_COUNTS.items():
        for attr in modes:
            counts[f"{k.__name__}_{MODE_ROWS[attr]}"] = getattr(k, attr)
    for fn in blocks.COUNTERPARTS:
        counts[fn.__name__] = fn.launches
        for attr, suffix in COUNTERPART_MODES.get(fn.__name__, {}).items():
            counts[f"{fn.__name__}_{suffix}"] = getattr(fn, attr)
    return counts


def reset_counts() -> None:
    from mvlt_tpu_torch.ops import blocks, kernels
    for fn in kernels.KERNELS:
        fn.launches = 0
    for fn, modes in kernels.MODE_COUNTS.items():
        for attr in modes:
            setattr(fn, attr, 0)
    for fn in blocks.COUNTERPARTS:
        for c in blocks.COUNTS:
            setattr(fn, c, 0)


@contextlib.contextmanager
def switches(on: bool):
    """``MVLT_KERNEL_DROPOUT`` and ``MVLT_STOREP`` set to 1 (``on``) or
    removed, for the calls inside; the model reads them at call time."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if on:
            os.environ[k] = "1"
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def backbone_route(attn_impl: str):
    """A context in which models are built with their Swin backbone on
    ``attn_impl``, set as the JAX package's tests set it: the adapter's
    ``SwinTransformer`` patched with ``functools.partial(...,
    attn_impl=...)`` (the adapter passes no option, as in JAX)."""
    from mvlt_tpu_torch.models.backbones import adapter, swin
    return mock.patch.object(adapter, "SwinTransformer", functools.partial(
        swin.SwinTransformer, attn_impl=attn_impl))


# (seed, parameter layout) pairs whose seeded values a run keeps on the host
INIT_CACHE = 3


def memoize_init(keep: int = INIT_CACHE) -> None:
    """Keep the values ``flagship.init_seeded_`` gives the last ``keep``
    (seed, parameter layout) pairs on the host: a model built again from
    the same seed with the same parameter names, shapes, dtypes and norm
    layers gets the same values copied in, bitwise what the numpy draws
    give it (about 200 M normals and seconds for a Swin-S pretrain model,
    which most phases build twice). Installed for the whole process, in
    the builders and in ``TaskRunner``."""
    import collections
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
    from mvlt_tpu_torch.ops.layers import LayerNorm
    from mvlt_tpu_torch.tasks import common
    draw = getattr(flagship.init_seeded_, "draw", flagship.init_seeded_)
    cache = collections.OrderedDict()

    @torch.no_grad()
    def init_seeded_(model, seed: int = 0):
        params = list(model.named_parameters())
        norms = {id(p) for m in model.modules()
                 if isinstance(m, (LayerNorm, BatchNorm))
                 for p in m.parameters()}
        key = (seed, tuple((n, tuple(p.shape), p.dtype, id(p) in norms)
                           for n, p in params))
        if key in cache:
            cache.move_to_end(key)
            for (_, p), value in zip(params, cache[key]):
                p.copy_(value)
            return model
        draw(model, seed)
        cache[key] = [p.detach().to("cpu", copy=True) for _, p in params]
        while len(cache) > keep:
            cache.popitem(last=False)
        return model

    init_seeded_.draw = draw
    flagship.init_seeded_ = common.init_seeded_ = init_seeded_


def start():
    """Phases 1-2: ``(device, card line)`` after the kernels are built, or
    None (printed why) without a card or beside no port package. Installs
    :func:`memoize_init`."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return None
    if not (REPO / "mvlt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mvlt_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from mvlt_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    memoize_init()
    return dev, card


def norm_main() -> int:
    """``python3 chip_smoke.py --norm``: only K3 / K5 at the step's shapes
    (``norm_kernel_checks``), to time one tree's K3 / K5 against
    another's in turns (``scripts/norm_turns.sh``)."""
    started = start()
    if started is None:
        return 1
    norm_kernel_checks(Checker(), started[0])
    return 0


def caption_main() -> int:
    """``python3 chip_smoke.py --caption``: phases 1-2 and the caption
    phase only (its kernel checks, report generation and its train step),
    without the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    caption_kernel_checks(Checker(), dev)
    with switches(False):
        caption_generate_phase(dev, card)
        caption_step_phase(dev, card)
    return 0


def retrieval_main() -> int:
    """``python3 chip_smoke.py --retrieval``: phases 1-2 and the retrieval
    phase only (K2 at the grid's score-call shape, the grid and the train
    step), without the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    retrieval_kernel_checks(Checker(), dev)
    with switches(False):
        retrieval_grid_phase(dev, card)
        retrieval_step_phase(dev, card)
    return 0


def backbones_main() -> int:
    """``python3 chip_smoke.py --backbones``: phases 1-2 and the other
    backbones' phases only (ViT-B/16 and the linear patch at S = 221 / 278,
    Swin-B's serving route), without the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    with switches(False):
        other_backbone_phases(dev, card)
    return 0


def loader_pace_main() -> int:
    """``python3 chip_smoke.py --loader-pace``: phases 1-2 and the four
    driver phases, each in its own process with its loader-pace loops (the
    drivers' train loops timed over long epochs per loader setting, the
    loader alone), without the kernels line."""
    started = start()
    if started is None:
        return 1
    for flag, what, limit, tag in (
            ("--vqa-driver", "vqa driver", VQA_DRIVER_TIMEOUT,
             VQA_DRIVER_TAG),
            ("--pretrain-driver", "pretrain driver", PRETRAIN_DRIVER_TIMEOUT,
             PRETRAIN_DRIVER_TAG),
            ("--caption-driver", "caption driver", CAPTION_DRIVER_TIMEOUT,
             CAPTION_DRIVER_TAG),
            ("--retrieval-driver", "retrieval driver",
             RETRIEVAL_DRIVER_TIMEOUT, RETRIEVAL_DRIVER_TAG)):
        driver_subprocess(flag, what, limit, tag)
    return 0


def other_backbone_phases(dev, card: str) -> dict:
    """The four phases of the other backbones, each with kernels against
    plain, each printing its seconds. Returns their launch counts by
    path."""
    from mvlt_tpu_torch import flagship
    phases = {
        "vit_vqa_forward": lambda: forward_phase(
            dev, card, config=flagship.flagship_vit_vqa_config(),
            label="ViT-B/16 VQA", expected=EXPECTED_VIT_FORWARD,
            seq_n=VIT_VQA_N),
        "vit_pretrain_train_step": lambda: pretrain_phase(
            dev, card, config=flagship.flagship_vit_pretrain_config(),
            label="ViT-B/16 pretrain step", expected=EXPECTED_VIT_PRETRAIN,
            bars=vit_bars, seq_n=VIT_PRETRAIN_N),
        "linear_vqa_train_step": lambda: train_phase(
            dev, card, config=flagship.flagship_linear_vqa_train_config(),
            label="linear-patch VQA train step",
            expected=EXPECTED_LINEAR_TRAIN, bars=linear_bars,
            seq_n=VIT_VQA_N, bn_bar=LOSS_BAR),
        "swin_base_vqa_forward": lambda: forward_phase(
            dev, card, config=flagship.flagship_swin_base_vqa_config(),
            label="Swin-B VQA", expected=EXPECTED_SWIN_BASE_FORWARD)}
    out = {}
    for path, phase in phases.items():
        t0 = time.perf_counter()
        out[path] = phase()
        print(f"{path} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def long_form_main() -> int:
    """``python3 chip_smoke.py --long-n``: phases 1-2, ptxas's report of the
    long-form kernels and the long-form phase only (K2 / K4's long form
    against plain at ``LONG_FORM_N``, the paths that run it, the ViT-B/16
    report generation driver), ending with its two kernel rows as JSON
    instead of the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    from mvlt_tpu_torch.ops import kernels as K
    for lib in ("attention", "attention_bwd"):
        for kernel, lines in K.ptxas_report(lib, "long_kernel").items():
            print(f"ptxas -v, {kernel}: {' | '.join(lines)}", flush=True)
    chk = Checker()
    t0 = time.perf_counter()
    long_form_kernel_checks(chk, dev)
    print(f"long-form kernel checks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    with switches(False):
        by_path = long_form_phases(dev, card)
    rows = {}
    for name in ("biased_attention_long_form",
                 "biased_attention_bwd_long_form"):
        per_path = {p: c.get(name, 0) for p, c in by_path.items()}
        rows[name] = dict(chk.row(name), launches=sum(per_path.values()),
                          launches_by_path=per_path)
    print("long-form rows: " + json.dumps(rows), flush=True)
    return 0


def swin_routes_main() -> int:
    """``python3 chip_smoke.py --swin-routes``: phases 1-2 and the swin
    routes phase only (the backward rules of rows 1, 6 and 7 and
    ``attention_core_op`` against their plain versions, the Swin-S step
    with ``drop_rate`` 0.1, the 'pallas_block' forward and step, the 'xla'
    and ``attn_drop_rate`` steps), without the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    swin_routes_kernel_checks(Checker(), dev)
    with switches(False):
        swin_route_phases(dev, card)
    return 0


def int8w_remat_phases(dev, card: str) -> dict:
    """Phase 19's two paths, each printing its seconds. Returns their launch
    counts by path."""
    phases = {"caption_generate_int8w": caption_generate_int8w_phase,
              "swin_pretrain_remat_train_step": swin_pretrain_remat_phase}
    out = {}
    for path, phase in phases.items():
        t0 = time.perf_counter()
        out[path] = phase(dev, card)
        print(f"{path} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def swin_route_phases(dev, card: str) -> dict:
    """The five phases of JAX's plain Swin route, each printing its
    seconds. Returns their launch counts by path."""
    from mvlt_tpu_torch import flagship
    phases = {
        "swin_dropout_train_step": lambda: pretrain_phase(
            dev, card, timed_steps=4, swin=True,
            config=flagship.flagship_swin_dropout_pretrain_config(),
            label="Swin-S pretrain step with swin.drop_rate 0.1",
            expected=EXPECTED_SWIN_DROPOUT, versus_record=True),
        "vqa_forward_pallas_block": lambda: forward_phase(
            dev, card, attn_impl="pallas_block"),
        "swin_pretrain_pallas_block_train_step": lambda: pretrain_phase(
            dev, card, timed_steps=4, swin=True, attn_impl="pallas_block"),
        "swin_pretrain_xla_train_step": lambda: pretrain_phase(
            dev, card, timed_steps=0, swin=True, attn_impl="xla"),
        "swin_attn_dropout_train_step": lambda: pretrain_phase(
            dev, card, timed_steps=0, swin=True,
            config=flagship.flagship_swin_attn_dropout_pretrain_config(),
            label="Swin-S pretrain step with swin.drop_rate and "
                  "attn_drop_rate 0.1", expected=EXPECTED_SWIN_XLA)}
    out = {}
    for path, phase in phases.items():
        t0 = time.perf_counter()
        out[path] = phase()
        print(f"{path} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def single_card_kernel_checks(chk: Checker, dev) -> None:
    """Phase 20's kernel cases, each against its plain version: the bias
    patterns of a shifted wide stage that no earlier path gives its
    kernels. At Swin-S @448's stage 4 (b8: 32 windows of 49, C = 768, 24
    heads, the map rolled, P = 4: the relative-position bias plus the shift
    mask per window): row 1 (``window_block_attention`` with the residual,
    its serving route), row 18 with the shift gather
    (``swin_half_block_shift``, the step's route; forward, and forward +
    backward through its autograd Function with DropPath multipliers), and
    rows 19 / 21 (``attention_core`` / ``attention_core_bwd``) at those
    patterns; then row 7's own kernel on a shifted map: window 8 on 16 x 16
    at C = 768 (b8: 32 windows of 64, P = 4), where JAX's ``swin_attn_half``
    admits a group."""
    from mvlt_tpu_torch.models.backbones.swin import (attn_half_admits,
                                                      shifted_window_mask)
    from mvlt_tpu_torch.ops import blocks

    inp = Inputs(dev, seed=23)
    rnd, dense, ln = inp.rnd, inp.dense, inp.ln
    bf, f32 = torch.bfloat16, torch.float32
    B, C, nH, res, win, shift = SINGLE_CARD_BATCH, 768, 24, 14, 7, 3
    nW, N, Dh = (res // win) ** 2, win * win, C // nH
    BW, sc = B * nW, Dh ** -0.5
    M = BW * N
    ln1, ln2 = ln(C), ln(C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    (w1, b1), (w2, b2) = dense(C, 4 * C), dense(4 * C, C)
    params = (*ln1, wq, bq, wp, bp, *ln2, w1, b1, w2, b2)
    lparams = (*bf16_ln(*ln1), wq, bq, wp, bp, *bf16_ln(*ln2), w1, b1, w2,
               b2)
    rel = rnd(1, nH, N, N, std=0.5, dtype=f32)
    mask = torch.as_tensor(shifted_window_mask(res, res, win, shift),
                           device=dev)
    pat = (rel + mask[:, None]).contiguous()                 # (4, nH, N, N)
    lmask = pat.to(bf)[torch.arange(BW, device=dev) % nW]
    tag = "Swin-S @448 stage 4, P = 4"

    # row 1 on the rolled windows (LN1's output and the residual x)
    x, h = rnd(BW, N, C), rnd(BW, N, C)

    def lib_block():
        rows = x.view(-1, C)
        c = lib_attention(F.linear(h.view(-1, C), wq, bq), BW, N, nH, lmask,
                          sc)
        return (F.linear(c, wp, bp) + rows).view(BW, N, C)

    chk.case("window_block_attention",
             lambda: blocks.window_block_attention(h, wq, bq, wp, bp, pat, sc,
                                                   nH, residual=x),
             lambda: blocks.window_block_attention_plain(
                 h, wq, bq, wp, bp, pat, sc, nH, residual=x),
             BLOCK_BAR, library_fn=lib_block, label=tag,
             flops=2.0 * M * C * 4 * C + 4.0 * BW * nH * N * N * Dh,
             nbytes=nbytes(h, wq, bq, wp, bp, pat, x, x))

    # row 18 with the shift gather, DropPath multipliers zeroing image 0
    spec = (res, res, win, shift)
    dp = (_swin_dp(inp, dev, B), _swin_dp(inp, dev, B))
    r1, r2 = (d.repeat_interleave(M // B)[:, None].to(bf) for d in dp)
    gather = blocks._shift_index(B, res, res, win, shift, dev).long()
    scatter = torch.argsort(gather)
    with torch.no_grad():
        chk.case("swin_half_block_shift",
                 lambda: blocks.swin_half_block(x, params, pat, sc, nH,
                                                shift_spec=spec, dp=dp),
                 lambda: blocks.swin_half_block_plain(x, params, pat, sc, nH,
                                                      shift_spec=spec, dp=dp),
                 BLOCK_BAR, label=tag,
                 library_fn=lambda: lib_swin_block(x, lparams, lmask, sc, nH,
                                                   gather, scatter,
                                                   dp=(r1, r2)),
                 flops=2.0 * M * C * 12 * C + 4.0 * BW * nH * N * N * Dh,
                 nbytes=nbytes(x, *params, pat, *dp, x))
    check_block_grads(blocks.swin_half_block, blocks.swin_half_block_plain,
                      x, params, pat, rnd(BW, N, C),
                      f"swin_half_block_shift ({tag})", scale=sc,
                      num_heads=nH, shift_spec=spec, dp=dp)

    # rows 19 / 21 at these patterns; library: SDPA and the autograd of the
    # bf16 composition with the patterns gathered per window
    qkv, dctx = rnd(M, 3 * C, std=0.5), rnd(M, C)
    chk.case("attention_core",
             lambda: blocks.attention_core(qkv.view(BW, N, 3 * C), pat, sc,
                                           nH),
             lambda: blocks.attention_core_plain(qkv.view(BW, N, 3 * C), pat,
                                                 sc, nH),
             KERNEL_BAR, label=tag,
             library_fn=lambda: lib_attention(qkv, BW, N, nH, lmask, sc),
             flops=4.0 * BW * nH * N * N * Dh,
             nbytes=nbytes(qkv, pat) + 2 * M * C)
    t = qkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4)
    lib = library_backward(
        lambda q, k, v: torch.matmul(torch.softmax(
            torch.matmul(q, k.transpose(-1, -2)) * sc + lmask, dim=-1), v),
        (t[0].contiguous(), t[1].contiguous(), t[2].contiguous()),
        dctx.view(BW, N, nH, Dh).permute(0, 2, 1, 3).contiguous())
    chk.case("attention_core_bwd",
             lambda: blocks.attention_core_bwd(qkv, dctx, pat, N, sc, nH),
             lambda: blocks.attention_core_bwd_plain(qkv, dctx, pat, N, sc,
                                                     nH),
             KERNEL_BAR, library_fn=lib, floor=1e-6, label=tag, graph=True,
             flops=10.0 * BW * nH * N * N * Dh,
             nbytes=nbytes(qkv, dctx, pat, qkv, pat))

    # row 7's own kernel, shifted: window 8 on a 16 x 16 map
    res8, win8 = 16, 8
    N8, BW8 = win8 * win8, B * (res8 // win8) ** 2
    assert attn_half_admits(BW8, N8, C, 4)
    x8 = rnd(BW8, N8, C)
    mask8 = torch.as_tensor(shifted_window_mask(res8, res8, win8, win8 // 2),
                            device=dev)
    pat8 = (rnd(1, nH, N8, N8, std=0.5, dtype=f32)
            + mask8[:, None]).contiguous()
    lmask8 = pat8.to(bf)[torch.arange(BW8, device=dev) % 4]
    half = (x8, *ln1, wq, bq, wp, bp, pat8, sc, nH)

    def lib_half():
        rows = x8.view(-1, C)
        hh = F.layer_norm(rows, (C,), *bf16_ln(*ln1), 1e-5)
        c = lib_attention(F.linear(hh, wq, bq), BW8, N8, nH, lmask8, sc)
        return (F.linear(c, wp, bp) + rows).view(BW8, N8, C)

    chk.case("swin_attn_half", lambda: blocks.swin_attn_half(*half),
             lambda: blocks.swin_attn_half_plain(*half), BLOCK_BAR,
             library_fn=lib_half, label="shifted, window 8, C = 768, P = 4",
             flops=2.0 * BW8 * N8 * C * 4 * C
             + 4.0 * BW8 * nH * N8 * N8 * Dh,
             nbytes=nbytes(x8, *ln1, wq, bq, wp, bp, pat8, x8))


def _moment_bytes(optimizer, keys) -> int:
    """Bytes of the moments ``keys`` in ``optimizer``'s state."""
    return sum(st[k].numel() * st[k].element_size()
               for st in optimizer.state.values() for k in keys if k in st)


def trace_step(step, batch, dev) -> dict:
    """One Swin-S step (bidirectional) traced through
    ``mvlt_tpu_torch.utils.profiling.trace`` inside ``annotate("mvlt swin
    step")`` into ``build/trace_swin_step``: the trace file must name the
    annotation and a kernel of each of K1-K5 (``TRACE_NAMES``); prints its
    size and the device time the profiler saw. Returns the step's launch
    counts."""
    import shutil
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.utils import profiling
    out = REPO / "build" / "trace_swin_step"
    shutil.rmtree(out, ignore_errors=True)
    step.masks = DropoutMasks(torch.Generator(device=dev).manual_seed(5))
    step(batch, False)                        # warm, outside the trace
    torch.cuda.synchronize()
    reset_counts()
    timer = profiling.StepTimer()
    with profiling.trace(str(out)) as prof:
        timer.start()
        with profiling.annotate(TRACE_NAMES["annotation"]):
            loss = step(batch, False)["loss"]
        took = timer.stop(loss)
    counts = launch_counts()
    path = out / profiling.TRACE_FILE
    text = path.read_text()
    missing = [k for k, name in TRACE_NAMES.items() if name not in text]
    from torch.autograd import DeviceType
    from mvlt_tpu_torch.profile_step import ANNOTATIONS
    device_us = sum(       # the device's kernels, each once (profile_step's)
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith(ANNOTATIONS + (TRACE_NAMES["annotation"],)))
    print(f"trace of one Swin-S step: {path.relative_to(REPO)}, "
          f"{path.stat().st_size} bytes; {took * 1e3:.3f} ms under the "
          f"profiler, device time {device_us / 1e3:.3f} ms; names "
          f"{sorted(k for k in TRACE_NAMES if k not in missing)}",
          flush=True)
    if missing or os.listdir(out) != [profiling.TRACE_FILE]:
        raise AssertionError(f"the trace misses {missing}")
    return counts


def bf16_moments_phase(dev, card: str) -> dict:
    """The Swin-S step of record with ``adam_mu_dtype='bfloat16'`` (b32)
    driven as phase 7 drives the step (gradients in both mask modes, 3
    losses against the plain route on replayed masks, launch counts), then
    timed in turns with the step of record (f32 moments; ms/step and peak
    memory); the moment's dtype and the moments' bytes against the f32
    optimizer's (2 B less a trained element); then one of its steps traced
    (:func:`trace_step`). Returns the launch counts by path."""
    from mvlt_tpu_torch import flagship
    traced = {}

    def report(step, batch, record):
        mine = _moment_bytes(step.optimizer, ("mu", "nu"))
        f32 = _moment_bytes(record.optimizer, ("exp_avg", "exp_avg_sq"))
        elems = sum(p.numel() for p in step.model.parameters())
        dtypes = sorted({str(st["mu"].dtype)
                         for st in step.optimizer.state.values()})
        print(f"bf16 moments on {card}: mu {dtypes}, moments {mine} bytes "
              f"against the f32 optimizer's {f32} ({f32 - mine} fewer for "
              f"{elems} trained elements)", flush=True)
        if dtypes != ["torch.bfloat16"] or f32 - mine != 2 * elems:
            raise AssertionError(f"moments {dtypes}, {f32 - mine} bytes "
                                 f"saved for {elems} elements")
        traced["counts"] = trace_step(step, batch, dev)

    counts = pretrain_phase(
        dev, card, timed_steps=4, swin=True,
        config=flagship.flagship_swin_bf16_moments_pretrain_config(),
        label="Swin-S pretrain step with bf16 AdamW moments",
        expected=EXPECTED_BF16_MOMENTS, versus_record=True, report=report)
    traced = traced["counts"]
    for name, (want, _) in EXPECTED_BF16_MOMENTS.items():
        if traced[name] != want:
            raise AssertionError(f"{name} ran {traced[name]} times in the "
                                 f"traced step, expected {want}")
    return {"swin_bf16_moments_train_step": counts,
            "swin_pretrain_trace": traced}


def single_card_phases(dev, card: str) -> dict:
    """Phase 20's paths, each with kernels against plain at full width and
    each printing its seconds. Returns their launch counts by path."""
    from mvlt_tpu_torch import flagship
    B = SINGLE_CARD_BATCH
    phases = {
        "swin448_vqa_forward": lambda: {"swin448_vqa_forward": forward_phase(
            dev, card, config=flagship.flagship_swin448_vqa_config(),
            label="Swin-S @448 VQA", expected=EXPECTED_SWIN448_FORWARD)},
        "swin448_pretrain_train_step": lambda: {
            "swin448_pretrain_train_step": pretrain_phase(
                dev, card, timed_steps=2, swin=True, batch=B,
                config=flagship.flagship_swin448_pretrain_config(),
                label="Swin-S @448 pretrain step",
                expected=EXPECTED_SWIN448_STEP)},
        "swin_ape_vqa_forward": lambda: {
            "swin_ape_vqa_forward": forward_phase(
                dev, card, config=flagship.flagship_swin_ape_vqa_config(),
                label="Swin-S ape VQA", expected=EXPECTED_APE_FORWARD)},
        "swin_ape_train_step": lambda: {
            "swin_ape_train_step": pretrain_phase(
                dev, card, timed_steps=0, swin=True, batch=B,
                config=flagship.flagship_swin_ape_pretrain_config(),
                label="Swin-S ape pretrain step",
                expected=EXPECTED_APE_STEP)},
        "vit_dropout_pretrain_train_step": lambda: {
            "vit_dropout_pretrain_train_step": pretrain_phase(
                dev, card, timed_steps=4,
                config=flagship.flagship_vit_dropout_pretrain_config(),
                label="ViT-B/16 pretrain step with ViT dropout 0.1",
                expected=EXPECTED_VIT_DROPOUT, bars=vit_bars,
                seq_n=VIT_PRETRAIN_N)},
        "swin_bf16_moments_train_step": lambda: bf16_moments_phase(dev,
                                                                   card)}
    out = {}
    for path, phase in phases.items():
        t0 = time.perf_counter()
        out.update(phase())
        print(f"{path} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# report sentences beside the synthetic corpora's captions: punctuation,
# brackets, numbers, special tokens, long words
NATIVE_SENTENCES = (
    "The heart is normal in size. The mediastinum is unremarkable.",
    "No acute cardiopulmonary abnormality (stable since 2019-03-04).",
    "There's a 2.5 cm nodule... it isn't calcified; see e.g. prior [1].",
    "is there a nodule in the right lung ? [END]",
    "findings: 1. clear lungs [SEP] impression: normal [END]",
    "pneumonoultramicroscopicsilicovolcanoconiosis w/ 5% change -- mild")


def native_tokenizer_checks() -> None:
    """The native tokenizers' host library (``mvlt_tpu_torch/csrc/host``,
    ``text/native.py``) builds on this machine from the checkout's sources
    with the host compiler (into the build directory, or into a fresh one
    where the build directory already holds it), encodes the repo's
    captions (the synthetic corpora's: ``SyntheticSource``,
    ``synthetic_pretrain_frames``, and ``NATIVE_SENTENCES``) to the Python
    path's ids, and tokenizes them for the metrics byte-equal to the Python
    PTB tokenizer."""
    import tempfile
    from mvlt_tpu_torch.data import datasets
    from mvlt_tpu_torch.metrics import ptb
    from mvlt_tpu_torch.text import native
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as fresh:
        t0 = time.perf_counter()
        path = native.build(fresh if native.library_path().exists()
                            else None)
        built = time.perf_counter() - t0
        if path.read_bytes()[:4] != b"\x7fELF":
            raise AssertionError(f"{path} is not a shared library")
    tok = WordPieceTokenizer()
    captions = (datasets.SyntheticSource(n=256).captions
                + datasets.synthetic_pretrain_frames(256, image_size=4)[1]
                + list(NATIVE_SENTENCES))
    ids = 0
    for c in captions:
        got = tok._native.encode(c)
        if got != tok.convert_tokens_to_ids(tok.tokenize(c)):
            raise AssertionError(f"native ids of {c!r} differ from Python's")
        if native.ptb_tokenize_native(c) != ptb.ptb_tokenize_py(c):
            raise AssertionError(f"native PTB tokens of {c!r} differ")
        ids += len(got)
    print(f"native tokenizers: {path.name} compiled here in {built:.1f} s; "
          f"{len(captions)} captions, {ids} ids equal the Python path's, "
          "PTB output byte-equal", flush=True)


def single_card_main() -> int:
    """``python3 chip_smoke.py --single-card``: phases 1-2 and phase 20
    only (its kernel cases and its paths), ending with the rows it touched
    as JSON instead of the kernels line."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    chk = Checker()
    t0 = time.perf_counter()
    single_card_kernel_checks(chk, dev)
    print(f"phase 20 kernel checks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    with switches(False):
        by_path = single_card_phases(dev, card)
    rows = {}
    for name in chk.rows:
        per_path = {p: c.get(name, 0) for p, c in by_path.items()}
        rows[name] = dict(chk.row(name), launches=sum(per_path.values()),
                          launches_by_path=per_path)
    print("phase 20 rows: " + json.dumps(rows), flush=True)
    return 0


def main() -> int:
    started = start()
    if started is None:
        return 1
    dev, card = started
    began = time.perf_counter()

    def lap(what: str) -> None:
        print(f"[{time.perf_counter() - began:.1f} s after the build] {what} "
              "done", flush=True)

    start_dumps()           # the reports read them after the checks
    native_tokenizer_checks()
    lap("native_tokenizer_checks")

    chk = Checker()
    for checks in (kernel_checks, train_kernel_checks, pretrain_kernel_checks,
                   long_attention_checks):
        checks(chk, dev)
        lap(checks.__name__)
    attention_repeat_checks(dev)
    attention_bwd_repeat_checks(dev)
    lap("repeat checks")
    for checks in (swin_kernel_checks, norm_kernel_checks, swin_gemm_checks,
                   optin_kernel_checks, attn_impl_kernel_checks,
                   swin_routes_kernel_checks, caption_kernel_checks,
                   iu_xray_kernel_checks, retrieval_kernel_checks,
                   long_form_kernel_checks, single_card_kernel_checks):
        checks(chk, dev)
        lap(checks.__name__)
    for report in (k1_report, k2_report, k4_report, k5_report):
        report(dev)
        lap(report.__name__)
    norm_plan_checks()
    lap("norm_plan_checks")
    with switches(False):
        by_path = {"vqa_forward": forward_phase(dev, card),
                   "vqa_train_step": train_phase(dev, card),
                   "pretrain_train_step": pretrain_phase(dev, card),
                   "swin_pretrain_train_step": pretrain_phase(dev, card,
                                                              swin=True)}
    lap("phases 4-7")
    by_path["swin_pretrain_switches_train_step"] = pretrain_phase(
        dev, card, timed_steps=10, swin=True, with_switches=True)
    lap("phase 8")
    with switches(False):
        by_path["vqa_forward_pallas"] = forward_phase(dev, card,
                                                      attn_impl="pallas")
        by_path["swin_pretrain_pallas_train_step"] = pretrain_phase(
            dev, card, timed_steps=4, swin=True, attn_impl="pallas")
        lap("phase 9")
        by_path["caption_generate"] = caption_generate_phase(dev, card)
        lap("caption generate")
        by_path.update(int8w_remat_phases(dev, card))
        lap("phase 19")
        by_path["caption_step"] = caption_step_phase(dev, card)
        lap("caption step")
        by_path["retrieval_grid"] = retrieval_grid_phase(dev, card)
        by_path["retrieval_step"] = retrieval_step_phase(dev, card)
        lap("phase 11")
        by_path.update(other_backbone_phases(dev, card))
        lap("phase 12")
        by_path.update(long_form_phases(dev, card))
        lap("phase 18")
        by_path.update(swin_route_phases(dev, card))
        lap("phase 17")
        by_path.update(single_card_phases(dev, card))
        lap("phase 20")
        by_path["vqa_driver"] = vqa_driver_subprocess()
        lap("phase 13")
        by_path["pretrain_driver"] = pretrain_driver_subprocess(
            by_path["swin_pretrain_train_step"])
        lap("phase 14")
        by_path["caption_driver"] = two_view_subprocess(
            "--caption-driver", "caption driver", CAPTION_DRIVER_TIMEOUT,
            CAPTION_DRIVER_TAG, by_path["caption_step"],
            EXPECTED_CAPTION_STEP)
        lap("phase 15")
        by_path["retrieval_driver"] = two_view_subprocess(
            "--retrieval-driver", "retrieval driver",
            RETRIEVAL_DRIVER_TIMEOUT, RETRIEVAL_DRIVER_TAG,
            by_path["retrieval_step"], EXPECTED_RETRIEVAL_STEP)
        lap("phase 16")
        by_path.update(multi_device_subprocess())
        lap("phase 21")

    def launches(name):
        return {path: c.get(name, 0) for path, c in by_path.items()}

    rows = []
    counterparts = {**EXPECTED, **EXPECTED_TRAIN, **EXPECTED_PRETRAIN,
                    **EXPECTED_SWITCHES, **EXPECTED_PALLAS,
                    **EXPECTED_SWIN_PALLAS, **EXPECTED_CAPTION_GENERATE,
                    **EXPECTED_CAPTION_STEP, **EXPECTED_RETRIEVAL_GRID,
                    **EXPECTED_RETRIEVAL_STEP, **EXPECTED_VIT_FORWARD,
                    **EXPECTED_VIT_PRETRAIN, **EXPECTED_LINEAR_TRAIN,
                    **EXPECTED_SWIN_BASE_FORWARD, **EXPECTED_PALLAS_BLOCK,
                    **EXPECTED_SWIN_XLA, **EXPECTED_SWIN_DROPOUT,
                    **EXPECTED_SWIN448_STEP}
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces})
    for name, (_, replaces) in counterparts.items():
        if name in KERNEL_SOURCES:
            continue
        rows.append({"name": name, "route": "cuda",
                     "source": "mvlt_tpu_torch/ops/blocks.py",
                     "replaces": replaces})
    for row in rows:
        per_path = launches(row["name"])
        row.update(launches=sum(per_path.values()),
                   launches_by_path=per_path, **chk.row(row["name"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def resnet_bars(name: str):
    """(group, norm, bar) of a parameter of the ResNet-101 models."""
    if name.startswith("conv.backbone."):
        return "ResNet backbone", "frob", BACKBONE_GRAD_BAR
    return "fusion / heads / resnet_fc", "max", GRAD_BAR


def swin_bars(name: str):
    """(group, norm, bar) of a parameter of the Swin-S pretrain model."""
    if name.endswith(".relative_position_bias_table"):
        return "Swin relative-position tables", "max", SWIN_GRAD_BAR
    if name.endswith(".absolute_pos_embed"):
        return "Swin absolute position table (ape)", "max", SWIN_GRAD_BAR
    if name.startswith("conv.backbone."):
        return "Swin backbone", "max", SWIN_GRAD_BAR
    return "fusion / heads", "max", GRAD_BAR


def vit_bars(name: str):
    """(group, norm, bar) of a parameter of the ViT-B/16 models: the ViT
    runs the same PyTorch layers (F.linear, F.layer_norm, SDPA) on both
    routes, so its gradients differ only by what the fusion encoder's
    kernels send back; held to the encoder's max-abs bar."""
    if name.startswith("conv.backbone."):
        return "ViT backbone", "max", GRAD_BAR
    return "fusion / heads", "max", GRAD_BAR


def linear_bars(name: str):
    """(group, norm, bar) of a parameter of the linear-patch models: the
    conv and its BatchNorm in relative Frobenius norm, as the ResNet's (a
    BN gradient is a sum over B x 14 x 14 positions); the rest max-abs."""
    if name.startswith("conv.backbone."):
        return "linear patch (conv + BN)", "frob", BACKBONE_GRAD_BAR
    return "fusion / heads", "max", GRAD_BAR


def compare_grads(model_k, model_p, what: str, bars=resnet_bars) -> None:
    """Every parameter's gradient, kernels vs plain, held to the bar that
    ``bars(name)`` gives its group (:func:`compare_grad_dicts`). A parameter
    the loss does not reach has no gradient on either side."""
    grads_k = {n: p.grad for n, p in model_k.named_parameters()}
    grads_p = {n: p.grad for n, p in model_p.named_parameters()}
    if bars is linear_bars:
        # the conv bias before a BatchNorm on batch statistics has a
        # gradient of 0 in exact arithmetic: each side's is the rounding of
        # the bf16 BN backward summed over B x 14 x 14 positions (0.013 /
        # 0.009 x max|conv weight grad|, kernels / plain, on an NVIDIA H100
        # 80GB HBM3 at 700 W), held to GRAD_BAR x the largest conv weight
        # gradient
        name, top = "conv.backbone.proj.bias", grads_p[
            "conv.backbone.proj.weight"].abs().max().item()
        noise = [g.pop(name).abs().max().item() for g in (grads_k, grads_p)]
        print(f"{what}: {name} (0 in exact arithmetic) max |grad| kernels "
              f"{noise[0]:.3g}, plain {noise[1]:.3g}; {GRAD_BAR} x max|conv "
              f"weight grad| {GRAD_BAR * top:.3g}", flush=True)
        if not max(noise) <= GRAD_BAR * top:
            raise AssertionError(f"{what}: {name} gradient {noise}")
    compare_grad_dicts(grads_k, grads_p, what, bars)


def compare_grad_dicts(grads_k: dict, grads_p: dict, what: str,
                       bars=resnet_bars) -> None:
    """Gradients by parameter name, kernels vs plain, each held to the bar
    that ``bars(name)`` gives its group: ``"max"`` the max abs err over
    max|plain grad|, ``"frob"`` the relative Frobenius norm of the
    difference; None on both sides is no gradient."""
    stats, failures, worst = [], [], {}
    for name, gk in grads_k.items():
        gp = grads_p[name]
        if gk is None and gp is None:
            continue
        if gk is None or gp is None or not torch.isfinite(gk).all():
            raise AssertionError(f"gradient of {name} missing or non-finite")
        diff = (gk - gp).float()
        scale = gp.abs().max().item()
        rel = diff.abs().max().item() / scale if scale > 0 else 0.0
        norm = gp.float().norm().item()
        frob = diff.norm().item() / norm if norm > 0 else 0.0
        group, kind, bar = bars(name)
        value = frob if kind == "frob" else rel
        stats.append((rel, frob, name))
        if value > worst.get(group, (-1.0,))[0]:
            worst[group] = (value, name, kind, bar)
        if value > bar:
            failures.append((name, rel, frob))
    groups = "; ".join(
        f"{group} worst {name} {'relative Frobenius' if kind == 'frob' else 'max abs err / max|plain grad|'} "
        f"{value:.4g} (bar {bar})"
        for group, (value, name, kind, bar) in worst.items())
    print(f"{what}, kernels vs plain, {len(stats)} tensors: {groups}; largest "
          f"max-abs ratios {[(n, round(r, 4)) for r, _, n in sorted(stats)[-4:]]}",
          flush=True)
    if failures:
        raise AssertionError(f"{len(failures)} gradients beyond the bar: "
                             f"{failures[:5]}")


def bn_buffers_check(model_k, model_p, what: str, bar: float) -> None:
    """Each BatchNorm's running buffers, kernels vs plain: the mean's max
    abs err over the square root of the plain running variance's max (the
    spread of the BN's input), the variance's over its own max; the worst
    held to ``bar``. Models without a BatchNorm pass."""
    from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
    plain = dict(model_p.named_modules())
    worst = (-1.0, None)
    for name, m in model_k.named_modules():
        if isinstance(m, BatchNorm):
            p = plain[name]
            var = p.running_var.abs().max().item()
            errs = ((m.running_mean - p.running_mean).abs().max().item()
                    / max(var, 1e-12) ** 0.5,
                    (m.running_var - p.running_var).abs().max().item()
                    / max(var, 1e-12))
            worst = max(worst, (max(errs), name), key=lambda w: w[0])
    if worst[1] is None:
        return
    print(f"{what}: BatchNorm running buffers, kernels vs plain: worst "
          f"{worst[0]:.4g} ({worst[1]}; the mean's max abs err over the "
          f"running std, the variance's over its max), bar {bar}",
          flush=True)
    if not worst[0] <= bar:
        raise AssertionError(f"{what}: BatchNorm {worst[1]}'s running "
                             f"buffers differ from plain by {worst[0]}")


def forward_phase(dev, card: str, attn_impl: str = "auto", config=None,
                  label: str = "flagship", expected: dict = None,
                  seq_n: int = None) -> dict:
    """The flagship b8 VQA forward (or the VQA forward of ``config``,
    ``label`` in the lines, held to ``expected`` launch counts) with the
    backbone on ``attn_impl``: launch counts, logits vs plain, times (in
    turns with the plain versions, or, on 'pallas' / 'pallas_block', with
    the forward on 'auto'). With ``seq_n`` every K2 launch must run at N =
    ``seq_n``, and the counts gain the ``*_long_n`` rows' launches. Returns
    the launch counts of one forward."""
    from mvlt_tpu_torch.flagship import build_vqa_forward
    from mvlt_tpu_torch.ops import kernels
    routed = attn_impl != "auto"
    expected = expected or EXPECTED_FORWARD_ROUTES[attn_impl]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with backbone_route(attn_impl):
        forward, (image, question) = build_vqa_forward(batch=8, device=dev,
                                                       config=config)
    print(f"{label} model (attn_impl={attn_impl!r}) built in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in forward.model.parameters())} parameters; "
          f"padded question tokens {(question == 0).sum().item()}",
          flush=True)
    reset_counts()
    with attention_lengths() as seen:
        logits = forward(image, question)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one {label} forward (attn_impl={attn_impl!r}): "
          f"{json.dumps(counts)}", flush=True)
    if seq_n is not None:
        long_n_counts(counts, seen, seq_n, f"one {label} forward")
    for name, (want, _) in expected.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in one "
                                 f"forward, expected {want}")
    for k in kernels.FORWARD_KERNELS:
        if counts[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} never launched")

    plain = forward(image, question, plain=True)
    torch.cuda.synchronize()
    assert logits.shape == (8, 224) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits).all() and torch.isfinite(plain).all()
    err = (logits.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    agree = (logits.float().argmax(-1) == plain.float().argmax(-1)).sum().item()
    print(f"{label} forward logits vs plain: max_abs_err {err:.4g}, max|plain| "
          f"{scale:.4g}, bar {LOGITS_BAR} x max|plain|; argmax agrees on "
          f"{agree}/8", flush=True)
    if not err <= LOGITS_BAR * scale:
        raise AssertionError(f"forward logits differ from plain: {err} > "
                             f"{LOGITS_BAR * scale}")

    if routed:            # the same weights on 'auto', timed in turns
        auto, _ = build_vqa_forward(batch=8, device=dev)
        calls = {"auto": lambda: auto(image, question),
                 attn_impl: lambda: forward(image, question)}
        turns = ("auto", attn_impl, attn_impl, "auto")
    else:
        calls = {"plain": lambda: forward(image, question, plain=True),
                 "kernels": lambda: forward(image, question)}
        turns = ("plain", "kernels", "kernels", "plain")
    times = {t: [] for t in calls}
    for which in turns:
        times[which].append(cuda_ms(calls[which], iters=10, warmup=2))
    ms = {t: sum(v) / 2 for t, v in times.items()}
    print(f"{label} b8 forward on {card}: " + ", ".join(
        f"{t} {v:.3f} ms ({8e3 / v:.1f} samples/s)" for t, v in ms.items())
        + f"; runs {json.dumps(times)}", flush=True)
    del forward, calls
    return counts


def train_phase(dev, card: str, timed_steps: int = 8, config=None,
                label: str = "VQA train step", expected: dict = None,
                bars=resnet_bars, seq_n: int = None,
                bn_bar: float = None) -> dict:
    """The VQA finetune train step (ResNet-101 + BERT-base, b32; or that of
    ``config``, ``label`` in the lines, held to ``expected`` launch counts
    and its gradients to ``bars``) on the kernels and on the plain versions
    from one seed: launch counts of one step, step-1 gradients, the losses
    of TRAIN_STEPS steps and the BatchNorm running buffers after step 1
    (which both routes computed from the same weights; with ``bn_bar``
    also after the TRAIN_STEPS, within it) against the plain run
    (:func:`bn_buffers_check`), then step times in turns. After step 1
    each route's AdamW moves its weights by its own gradients, and a
    ResNet-101's 104 BatchNorms carry that apart (layer 4's by 0.038 of
    their input's spread after 3 steps on an NVIDIA H100 80GB HBM3 at 700
    W): only the linear
    patch's one BN, on the conv of the images, is held after them. With
    ``seq_n`` every
    K2 / K4 launch must run at N = ``seq_n``. Returns the launch counts of
    one step."""
    from mvlt_tpu_torch.flagship import build_vqa_train_step
    from mvlt_tpu_torch.ops import kernels
    B = TRAIN_BATCH
    expected = expected or EXPECTED_TRAIN
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_k, batch = build_vqa_train_step(batch=B, device=dev, config=config)
    step_p, batch_p = build_vqa_train_step(batch=B, device=dev, plain=True,
                                           config=config)
    n_params = sum(p.numel() for p in step_k.model.parameters())
    print(f"{label} built twice in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} parameters, image {tuple(batch['image'].shape)}, "
          f"question {tuple(batch['question'].shape)}", flush=True)

    reset_counts()
    with attention_lengths() as seen:
        out_k = step_k(batch)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one {label}: {json.dumps(counts)}", flush=True)
    if seq_n is not None:
        long_n_counts(counts, seen, seq_n, f"one {label}")
    for name, (want, _) in expected.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in one "
                                 f"train step, expected {want}")
    for k in kernels.KERNELS:
        if counts[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} never launched in the "
                                 "train step")
    if counts["gemm_splitk"] <= 0:
        raise AssertionError("K1's split-K never ran in the train step")
    out_p = step_p(batch_p)
    torch.cuda.synchronize()
    compare_grads(step_k.model, step_p.model, f"{label} step-1 gradients",
                  bars)
    # step 1's BatchNorms saw the same weights and images on both routes
    bn_buffers_check(step_k.model, step_p.model, f"{label}, after step 1",
                     1e-4)

    losses = {"kernels": [out_k["loss"].item()],
              "plain": [out_p["loss"].item()]}
    acc = [out_k["accuracy"].item()]
    for _ in range(TRAIN_STEPS - 1):
        losses["kernels"].append(step_k(batch)["loss"].item())
        losses["plain"].append(step_p(batch_p)["loss"].item())
    print(f"{label} losses of {TRAIN_STEPS} steps: {json.dumps(losses)}; "
          f"step-1 accuracy {acc[0]:.4f}", flush=True)
    for i, (lk, lp) in enumerate(zip(losses["kernels"], losses["plain"])):
        if not (abs(lk - lp) <= LOSS_BAR * abs(lp) and lk == lk):
            raise AssertionError(f"step {i + 1} loss {lk} vs plain {lp} "
                                 f"beyond {LOSS_BAR} relative")
    if bn_bar is not None:
        bn_buffers_check(step_k.model, step_p.model,
                         f"{label}, after {TRAIN_STEPS} steps", bn_bar)
    times, peak, resident = {"kernels": [], "plain": []}, None, None
    for which in ("plain", "kernels", "kernels", "plain"):
        step, b = (step_k, batch) if which == "kernels" else (step_p, batch_p)
        step(b)
        torch.cuda.synchronize()
        measure = which == "kernels" and peak is None
        if measure:
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step(b)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3 / timed_steps)
        if measure:
            peak = torch.cuda.max_memory_allocated()
    ms_k = sum(times["kernels"]) / 2
    ms_p = sum(times["plain"]) / 2
    print(f"{label} b{B} on {card}: kernels {ms_k:.3f} ms/step "
          f"({B * 1e3 / ms_k:.1f} samples/s), plain {ms_p:.3f} ms/step "
          f"({B * 1e3 / ms_p:.1f} samples/s); runs {json.dumps(times)}; "
          f"peak memory in a kernel step {peak / 2 ** 30:.3f} GiB "
          f"(with {resident / 2 ** 30:.3f} GiB resident, both models)",
          flush=True)
    return counts


def pretrain_phase(dev, card: str, timed_steps: int = 6,
                   swin: bool = False, with_switches: bool = False,
                   attn_impl: str = "auto", config=None, label: str = None,
                   expected: dict = None, bars=None,
                   seq_n: int = None, versus_record: bool = False,
                   batch: int = None, report=None) -> dict:
    """The MLM+ITM pretrain train step (ResNet-101, or with ``swin`` the
    step of record on Swin-S with DropPath 0.3, + BERT-base, S = 131, b32,
    dropout 0.1) on the kernels and on the plain versions from one seed;
    the plain run replays the DropPath and dropout masks the kernel run
    drew. Gradients from the initial parameters in both mask modes, the
    launch counts of one step, the losses of 3 steps, then step times in
    turns. With ``with_switches`` (Swin-S), all of that runs with
    ``MVLT_KERNEL_DROPOUT`` and ``MVLT_STOREP`` set (the plain run replays
    the kernel run's seeds as well), and the turns are the kernel step with
    the switches off and on (off, on, on, off), each with its peak memory.
    With ``attn_impl='pallas'`` (Swin-S) the backbone is on that route in
    both runs, and the turns are the kernel step on 'auto' and on 'pallas'
    (auto, pallas, pallas, auto), each with its peak memory. ``config``
    (with ``label``, ``expected`` launch counts and gradient ``bars``)
    builds the step of another model; with ``seq_n`` every K2 / K4 launch
    must run at N = ``seq_n``. On 'pallas_block' / 'xla' the backbone is on
    that route as on 'pallas'; with ``versus_record`` (Swin-S) the turns are
    the step of record and this one (record, this, this, record);
    ``timed_steps=0`` leaves the timing out. ``batch`` replaces
    ``TRAIN_BATCH``; ``report(step, batch, versus_step)`` runs last, on
    the kernel step (and the step it was timed beside, or None). Returns
    the launch counts of one step."""
    import functools
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models.backbones.adapter import image_tokens
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.train.steps import seq2seq_coin_flip
    B = batch or TRAIN_BATCH
    build = functools.partial(flagship.build_swin_pretrain_train_step if swin
                              else flagship.build_pretrain_train_step,
                              config=config)
    routed = attn_impl != "auto"
    expected = expected or (EXPECTED_SWITCHES if with_switches
                            else EXPECTED_SWIN_ROUTES[attn_impl] if routed
                            else EXPECTED_SWIN_PRETRAIN if swin
                            else EXPECTED_PRETRAIN)
    bars = bars or (swin_bars if swin else resnet_bars)
    label = label or ("Swin-S pretrain step" if swin else "pretrain step")
    if with_switches:
        label += " with MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1"
    if routed:
        label += f" with attn_impl={attn_impl!r}"
    gc.collect()          # a step refers to itself: free the last phase's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with backbone_route(attn_impl):
        step_k, batch = build(batch=B, text_len=PRETRAIN_TEXT, device=dev)
        step_p, batch_p = build(batch=B, text_len=PRETRAIN_TEXT, device=dev,
                                plain=True)
    n_params = sum(p.numel() for p in step_k.model.parameters())
    labels = (batch["caption_label"] != -100).sum().item()
    S = 2 + image_tokens(step_k.model.config) + PRETRAIN_TEXT
    assert batch["image"].shape[0] == B
    f = step_k.model.config.fusion
    amask = B * f.num_attention_heads * S * S * 2
    print(f"{label} built twice in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} parameters, image {tuple(batch['image'].shape)}, "
          f"caption {tuple(batch['caption_masked'].shape)}, S = {S}, "
          f"{labels} MLM labels, padded caption tokens "
          f"{(batch['caption_masked'] == 0).sum().item()}; an attention "
          f"dropout mask {amask / 1e6:.1f} MB a layer", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)

    def recording():
        return DropoutMasks(gen, record=True)

    keys = ("image", "caption_masked", "caption_label", "itm_label")
    losses, counts = {"kernels": [], "plain": []}, None
    with switches(with_switches):
        for seq2seq in (False, True):
            masks = recording()
            for model, b, plain, src in (
                    (step_k.model, batch, False, masks),
                    (step_p.model, batch_p, True, None)):
                model.zero_grad(set_to_none=True)
                src = src or DropoutMasks.replay(masks.recorded)
                loss, _ = model.loss(*(b[k] for k in keys), seq2seq=seq2seq,
                                     plain=plain, masks=src)
                loss.backward()
            torch.cuda.synchronize()
            compare_grads(step_k.model, step_p.model,
                          f"{label} initial gradients "
                          f"({'seq2seq' if seq2seq else 'bidirectional'})",
                          bars)
            del masks

        for i, seq2seq in enumerate(PRETRAIN_MODES):
            step_k.masks = recording()
            if i == 0:
                reset_counts()
            with attention_lengths() as seen:
                out_k = step_k(batch, seq2seq)
                torch.cuda.synchronize()
            if i == 0:
                counts = launch_counts()
                print(f"launches in one {label}: {json.dumps(counts)}",
                      flush=True)
                if seq_n is not None:
                    long_n_counts(counts, seen, seq_n, f"one {label}")
                for name, (want, _) in expected.items():
                    if counts[name] != want:
                        raise AssertionError(
                            f"{name} ran {counts[name]} times in one "
                            f"{label}, expected {want}")
                for k in kernels.KERNELS:
                    if counts[k.__name__] <= 0:
                        raise AssertionError(f"kernel {k.__name__} never "
                                             f"launched in the {label}")
                if counts["gemm_splitk"] <= 0:
                    raise AssertionError(f"K1's split-K never ran in the "
                                         f"{label}")
            step_p.masks = DropoutMasks.replay(step_k.masks.recorded)
            out_p = step_p(batch_p, seq2seq)
            losses["kernels"].append({k: v.item() for k, v in out_k.items()})
            losses["plain"].append({k: v.item() for k, v in out_p.items()})
    print(f"losses of {len(PRETRAIN_MODES)} steps (seq2seq "
          f"{list(PRETRAIN_MODES)}): {json.dumps(losses)}", flush=True)
    for i, (lk, lp) in enumerate(zip(losses["kernels"], losses["plain"])):
        for name in ("loss", "mlm_loss", "itm_loss"):
            a, b = lk[name], lp[name]
            if not (abs(a - b) <= LOSS_BAR * abs(b) and a == a):
                raise AssertionError(f"step {i + 1} {name} {a} vs plain {b} "
                                     f"beyond {LOSS_BAR} relative")

    if not timed_steps:
        print(f"{label}: checked and counted, not timed", flush=True)
        if report is not None:
            report(step_k, batch, None)
        return counts
    # turns: plain vs kernels, the kernel step with the switches off / on,
    # the kernel step on 'auto' / another route, or the step of record /
    # this one
    versus = "auto" if routed else "record" if versus_record else None
    mine = attn_impl if routed else "this"
    turns = (("off", "on", "on", "off") if with_switches
             else (versus, mine, mine, versus) if versus
             else ("plain", "kernels", "kernels", "plain"))
    steps = {"plain": (step_p, batch_p)}
    if versus:
        del step_p, steps["plain"]
        gc.collect()
        steps[versus] = flagship.build_swin_pretrain_train_step(
            batch=B, text_len=PRETRAIN_TEXT, device=dev)
    times = {t: [] for t in turns}
    peak, resident = {}, {}
    for which in turns:
        step, b = steps.get(which, (step_k, batch))
        with switches(which == "on"):
            step.masks = DropoutMasks(torch.Generator(device=dev).manual_seed(2))
            flips = torch.Generator().manual_seed(0)
            step(b, seq2seq_coin_flip(flips))
            torch.cuda.synchronize()
            measure = which != "plain" and which not in peak
            if measure:
                resident[which] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                step(b, seq2seq_coin_flip(flips))
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) * 1e3 / timed_steps)
            if measure:
                peak[which] = torch.cuda.max_memory_allocated()
    ms = {t: sum(v) / len(v) for t, v in times.items()}
    gib = {t: f"{v / 2 ** 30:.3f} GiB (with {resident[t] / 2 ** 30:.3f} GiB "
              "resident, both models)" for t, v in peak.items()}
    if with_switches or versus:
        a, b = turns[:2]
        what = ("switches" if with_switches else "attn_impl" if routed
                else f"the step of record vs {label}:")
        print(f"MLM+ITM {label} b{B} (S = {S}) on {card}, "
              f"kernels: {what} {a} {ms[a]:.3f} ms/step "
              f"({B * 1e3 / ms[a]:.1f} samples/s), {b} {ms[b]:.3f} "
              f"ms/step ({B * 1e3 / ms[b]:.1f} samples/s); runs "
              f"{json.dumps(times)}; peak memory {a} {gib[a]}, {b} "
              f"{gib[b]}", flush=True)
    else:
        ms_k, ms_p = ms["kernels"], ms["plain"]
        print(f"MLM+ITM {label} b{B} (S = {S}) on {card}: kernels "
              f"{ms_k:.3f} ms/step ({B * 1e3 / ms_k:.1f} samples/s), plain "
              f"{ms_p:.3f} ms/step ({B * 1e3 / ms_p:.1f} samples/s); runs "
              f"{json.dumps(times)}; peak memory in a kernel step "
              f"{gib['kernels']}", flush=True)
    if report is not None:
        report(step_k, batch, steps[versus][0] if versus else None)
    return counts


def _max_err(got, want):
    """(max abs err, max|want|) of two tensors, in float32."""
    return ((got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


def _check_close(what: str, got, want, bar: float = LOGITS_BAR) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    err, scale = _max_err(got, want)
    print(f"{what}: max_abs_err {err:.4g}, max|plain| {scale:.4g}, bar {bar} "
          f"x max|plain|", flush=True)
    if not err <= bar * scale:
        raise AssertionError(f"{what}: {err} > {bar * scale}")


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _beam_steps_check(model, feat, spec, dev) -> None:
    """The first ``CAPTION_BEAM_STEPS`` decode steps at the beam search's
    shapes (B * K rows, T = 2 for unilm: K1 at M = 2 * B * K, K3 on
    (2 * B * K, H)), kernels against plain, each route on its own copy of one
    K-fold repeated prefill cache and both fed the same tokens: row r takes
    the (r % K)-th best token of the plain logits, so a sample's beams part
    after step 0 as a beam search's do. Holds the logits and, per layer, the
    (k, v) rows each step writes, within ``LOGITS_BAR`` x max|plain|."""
    from mvlt_tpu_torch.models import generation as G
    from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
    B, K = feat.shape[0], spec.num_beams
    with torch.no_grad():
        logits, kv, P = G._prefill(model, feat, spec, PLAIN_OPS)
        kv = [(k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
              for k, v in kv]
        cache_k = G._make_cache(model, kv, P, B * K, spec)
        del kv
        cache_p = {n: c.clone() for n, c in cache_k.items()}
        logits = logits.repeat_interleave(K, dim=0)
        rank = (torch.arange(B * K, device=dev) % K)[:, None]
        worst = {"logits": 0.0, "k": 0.0, "v": 0.0}
        for t in range(1, CAPTION_BEAM_STEPS + 1):
            tok = logits.float().topk(K, dim=-1).indices.gather(1, rank)[:, 0]
            got = G._decode_logits(model, cache_k, tok, P + t - 1, spec,
                                   KERNEL_OPS)
            logits = G._decode_logits(model, cache_p, tok, P + t - 1, spec,
                                      PLAIN_OPS)
            rows = slice(P + t - 1, P + t + 1)
            pairs = [("logits", got, logits)] + [
                (n, cache_k[n][i, :, :, rows], cache_p[n][i, :, :, rows])
                for n in ("k", "v") for i in range(cache_k[n].shape[0])]
            for what, a, b in pairs:
                err, scale = _max_err(a, b)
                if not (torch.isfinite(a).all() and err <= LOGITS_BAR * scale):
                    raise AssertionError(
                        f"beam decode step {t} ({B * K} rows): {what} differ "
                        f"from plain: {err} > {LOGITS_BAR * scale}")
                worst[what] = max(worst[what], err / scale)
        del cache_k, cache_p
    print(f"beam-shaped decode steps ({B * K} rows, {CAPTION_BEAM_STEPS} "
          f"steps), kernels vs plain from one prefill cache: worst max_abs_err"
          f" / max|plain| {json.dumps({k: round(v, 5) for k, v in worst.items()})}"
          f" (logits; the (k, v) rows written, per layer; bar {LOGITS_BAR})",
          flush=True)


def caption_generate_phase(dev, card: str) -> dict:
    """Report generation (Swin-S + BERT-base, bf16, b32, beam 5, length 150,
    unilm) on the kernels: the Swin features and the prefill's logits
    against the plain versions, the first ``CAPTION_CACHED_STEPS`` cached
    greedy decode steps against the uncached seq2seq forward (rows 15 and 5
    on the card), the first ``CAPTION_BEAM_STEPS`` beam-shaped decode steps
    against plain, the launch counts of one generate call, determinism, the
    ``unroll`` / ``suffix_reorder`` forms, sampling under one seed, then
    tokens/s of the kernel route (loop and unrolled) and the plain route,
    and peak memory. Returns the launch counts of one generate call."""
    from mvlt_tpu_torch.flagship import build_caption_generate
    from mvlt_tpu_torch.models import generation as G
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
    B, L = TRAIN_BATCH, CAPTION_TEXT
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen, image = build_caption_generate(batch=B, num_beams=CAPTION_BEAMS,
                                        max_length=L, device=dev)
    model, spec = gen.model, gen.spec
    print(f"caption model built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters; {spec}",
          flush=True)
    with torch.no_grad():
        feat = model.encode_image(image)
        _check_close("caption Swin-S features, kernels vs plain", feat,
                     model.encode_image(image, plain=True))
        logits_k = G._prefill(model, feat, spec, KERNEL_OPS)[0]
        logits_p = G._prefill(model, feat, spec, PLAIN_OPS)[0]
        _check_close("caption prefill logits, kernels vs plain", logits_k,
                     logits_p)
        del logits_k, logits_p
        # cached steps against the full seq2seq forward over the committed
        # tokens + [MASK] (fused_attn_ln_masked / fused_mlp_ln: rows 15, 5)
        greedy = dataclasses.replace(spec, num_beams=1)
        reset_counts()
        logits, kv, P = G._prefill(model, feat, greedy, KERNEL_OPS)
        cache = G._make_cache(model, kv, P, B, greedy)
        del kv
        image_mask = torch.ones(feat.shape[:2], dtype=torch.bool, device=dev)
        text = torch.full((B, 1), spec.mask_token_id, dtype=torch.long,
                          device=dev)
        errs = []
        for t in range(CAPTION_CACHED_STEPS):
            if t:
                logits = G._decode_logits(model, cache, tok, P + t - 1,
                                          greedy, KERNEL_OPS)
            hidden, _ = model.fusion(text, None, feat, image_mask,
                                     KERNEL_OPS, seq2seq=True, pool=False)
            ref = model.mlm_head_seq2seq(hidden[:, -1], KERNEL_OPS)
            err, scale = _max_err(logits, ref)
            errs.append(round(err / scale, 5))
            if not (torch.isfinite(logits).all() and err <= LOGITS_BAR * scale):
                raise AssertionError(f"cached decode step {t}: logits differ "
                                     f"from the uncached forward: {err} > "
                                     f"{LOGITS_BAR * scale}")
            tok = logits.argmax(-1)
            text = torch.cat([text[:, :-1], tok[:, None], text[:, -1:]], 1)
        torch.cuda.synchronize()
        counts = launch_counts()
        del cache
    print(f"cached vs uncached logits, {CAPTION_CACHED_STEPS} greedy steps: "
          f"max_abs_err / max|uncached| per step {errs} (bar {LOGITS_BAR}); "
          f"uncached forwards ran fused_attn_ln_masked "
          f"{counts['fused_attn_ln_masked']} and fused_mlp_ln "
          f"{counts['fused_mlp_ln']} times", flush=True)
    if counts["fused_attn_ln_masked"] != 12 * CAPTION_CACHED_STEPS:
        raise AssertionError("the uncached forwards did not run row 15 on "
                             "the card")
    _beam_steps_check(model, feat, spec, dev)

    reset_counts()
    out = gen(image)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one caption generate call: {json.dumps(counts)}",
          flush=True)
    for name, (want, _) in EXPECTED_CAPTION_GENERATE.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in one "
                                 f"generate call, expected {want}")
    for k in kernels.FORWARD_KERNELS:
        if counts[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} never launched")
    seqs, lens, scores = out
    assert seqs.shape == (B, L) and lens.shape == scores.shape == (B,)
    if not (torch.isfinite(scores).all() and ((lens >= 1) & (lens <= L)).all()
            and ((seqs >= 0) & (seqs < model.config.fusion.vocab_size)).all()):
        raise AssertionError("generate returned out-of-range values")
    print(f"beam output: lengths {lens.tolist()}; scores "
          f"{[round(v, 4) for v in scores.tolist()[:8]]}...", flush=True)
    checks = {"two calls": gen(image),
              "unroll=True": gen(image, unroll=True),
              "suffix_reorder=True": gen(image, suffix_reorder=True)}
    for what, other in checks.items():
        if not _same(out, other):
            raise AssertionError(f"generate: {what} differs from the first "
                                 "call")
    sample = gen(image, num_beams=1, sample=True)
    if not _same(sample, gen(image, num_beams=1, sample=True)):
        raise AssertionError("sampling under one seed is not reproducible")
    print(f"generate: two calls, unroll=True and suffix_reorder=True bitwise "
          f"equal; sampling reproducible ({len(set(map(tuple, sample[0].tolist())))} "
          f"distinct sampled reports of {B})", flush=True)

    # the loop (reads the done flags a step), the unrolled form (never
    # synchronises; JAX's bench times this one, bench.py:92), plain versions
    calls = {"kernels": {}, "kernels unroll": dict(unroll=True),
             "plain": dict(plain=True)}
    times, peak, warm = {}, None, {}
    for which, kw in calls.items():
        warm[which] = gen(image, **kw)
        torch.cuda.synchronize()
        runs = []
        for i in range(3):
            if which == "kernels" and i == 0:
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            gen(image, **kw)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            if which == "kernels" and i == 0:
                peak = torch.cuda.max_memory_allocated()
        times[which] = runs
    med = {k: sorted(v)[1] for k, v in times.items()}
    print(f"caption generate b{B} beam {CAPTION_BEAMS} length {L} on {card}: "
          + ", ".join(f"{k} {B * L / v:.1f} tokens/s ({v * 1e3:.1f} ms a "
                      f"call)" for k, v in med.items())
          + f"; runs (s) {json.dumps(times)}; peak memory in a kernel call "
          f"{peak / 2 ** 30:.3f} GiB (with {resident / 2 ** 30:.3f} GiB "
          "resident)", flush=True)
    same = (warm["plain"][0] == out[0]).all(dim=1)
    print(f"beam sequences of the plain route equal to the kernel route's: "
          f"{int(same.sum())} of {B} (bf16 rounding differs between the "
          f"routes; the steps are held above)", flush=True)
    del gen, out, checks, sample, warm
    return counts


def caption_step_phase(dev, card: str, timed_steps: int = 4) -> dict:
    """The caption train step (Swin-S + BERT-base, b32, text 150, unilm,
    DropPath 0.3, dropout 0.1) on the kernels and on the plain versions from
    one seed, the plain run replaying the kernel run's masks
    (:func:`paired_step_phase`): gradients from the initial parameters, the
    launch counts of one step, the losses of 3 steps, then step times in
    turns and peak memory. Returns the launch counts of one step."""
    from mvlt_tpu_torch.flagship import build_caption_train_step
    return paired_step_phase(
        dev, card, "caption step",
        lambda plain: build_caption_train_step(
            batch=TRAIN_BATCH, text_len=CAPTION_TEXT, device=dev,
            plain=plain),
        _caption_loss, swin_bars, EXPECTED_CAPTION_STEP, timed_steps)


def retrieval_grid_phase(dev, card: str) -> dict:
    """The retrieval grid at ``run_retrieval.py``'s settings (Swin-S +
    BERT-base, bf16, n = 128 samples, S = 131, chunks of 64) on the
    kernels: the b64 Swin features and the 2-way logits of a
    ``RETRIEVAL_SUB`` sub-grid against the plain versions (end to end, and
    from the same features: the fusion sweep alone), the launch counts
    of one grid, two grids bitwise equal, grid rows against the full model's
    ``score`` per pair (backbone per pair), the labels and R@k, then pairs/s
    (n^2 / time, the median of 3 grids after a warm-up) beside the bound,
    and peak memory. Returns the launch counts of one grid."""
    from mvlt_tpu_torch.flagship import build_retrieval_grid
    from mvlt_tpu_torch.metrics.retrieval import evaluate_retrieval
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.tasks import retrieval as R
    n, chunk = RETRIEVAL_N, RETRIEVAL_CHUNK
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid, (images, captions, cap_ids) = build_retrieval_grid(
        n=n, text_len=RETRIEVAL_TEXT, batch_size=chunk, device=dev)
    model = grid.model
    print(f"retrieval model built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters; images "
          f"{tuple(images.shape)}, captions {tuple(captions.shape)}, padded "
          f"tokens {(captions == 0).sum().item()}, "
          f"{n - len(set(cap_ids.tolist()))} duplicate reports", flush=True)
    ni, nc = RETRIEVAL_SUB
    with torch.no_grad():
        feat_k = R.encode_images(model, images[:chunk], chunk)
        feat_p = R.encode_images(model, images[:chunk], chunk, plain=True)
        _check_close(f"retrieval Swin-S features (b{chunk}), kernels vs "
                     "plain", feat_k, feat_p)
        caps = captions[:nc]
        sub_k = torch.stack([model.logits_from_features(
            feat_k[i:i + 1].expand(nc, -1, -1), caps) for i in range(ni)])
        sub_p = torch.stack([model.logits_from_features(
            feat_p[i:i + 1].expand(nc, -1, -1), caps, plain=True)
            for i in range(ni)])
        _check_close(f"retrieval 2-way logits of a {ni} x {nc} sub-grid, "
                     "kernels vs plain", sub_k, sub_p)
        # the fusion sweep alone: both routes from the plain features
        sub_f = torch.stack([model.logits_from_features(
            feat_p[i:i + 1].expand(nc, -1, -1), caps) for i in range(ni)])
        _check_close(f"retrieval 2-way logits of the {ni} x {nc} sub-grid "
                     "from the plain features (the fusion sweep alone), "
                     "kernels vs plain", sub_f, sub_p)
        _check_close(f"retrieval P(match) of the {ni} x {nc} sub-grid, "
                     "kernels vs plain", torch.softmax(sub_k.float(), -1),
                     torch.softmax(sub_p.float(), -1))
        del feat_k, feat_p, sub_k, sub_p, sub_f

    reset_counts()
    out = grid(images, captions, cap_ids)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one retrieval grid (n = {n}, chunks of {chunk}): "
          f"{json.dumps(counts)}", flush=True)
    for name, (want, _) in EXPECTED_RETRIEVAL_GRID.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in one "
                                 f"retrieval grid, expected {want}")
    for k in kernels.FORWARD_KERNELS:
        if counts[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} never launched")
    sims, labels = out["similarities"], out["labels"]
    if not (sims.shape == labels.shape == (n, n) and (sims > 0).all()
            and (sims < 1).all() and (labels.diagonal() == 1).all()):
        raise AssertionError("retrieval grid: wrong shape, a score outside "
                             "(0, 1) or a missing diagonal label")
    again = grid(images, captions, cap_ids)["similarities"]
    if not (again == sims).all():
        raise AssertionError("two retrieval grids differ")
    with torch.no_grad():
        full = torch.stack([torch.cat([model.score(
            images[i:i + 1].expand(min(chunk, n - s), -1, -1, -1),
            captions[s:s + chunk]) for s in range(0, n, chunk)])
            for i in RETRIEVAL_FULL_ROWS])
    _check_close(f"retrieval grid rows {list(RETRIEVAL_FULL_ROWS)} vs the "
                 "full model's score per pair (backbone per pair)",
                 torch.from_numpy(sims[list(RETRIEVAL_FULL_ROWS)]),
                 full.cpu())
    print(f"retrieval grid: two calls bitwise equal; labels "
          f"{int(labels.sum())} matches ({n} diagonal); "
          f"{json.dumps(evaluate_retrieval(sims, labels))}", flush=True)

    times = []
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        grid(images, captions, cap_ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = sorted(times)[1]
    calls = n * -(-n // chunk)
    cfg = model.config.fusion
    S, H = 1 + 49 + 1 + RETRIEVAL_TEXT, cfg.hidden_size
    weights = cfg.num_hidden_layers * (4 * H * H + 2 * H * cfg.intermediate_size)
    pair_flops = 2.0 * weights * S + 4.0 * cfg.num_hidden_layers * S * S * H
    print(f"retrieval grid n = {n} (S = {S}, chunks of {chunk}) on {card}: "
          f"{n * n / med:.1f} pairs/s ({med * 1e3:.1f} ms a grid of "
          f"{n * n} pairs, {calls} score calls); runs (s) "
          f"{json.dumps(times)}; bound {PEAK_FLOPS / pair_flops:.1f} pairs/s "
          f"({pair_flops / 1e9:.2f} GFLOP a pair in the fusion encoder); "
          f"peak memory in a grid {peak / 2 ** 30:.3f} GiB (with "
          f"{resident / 2 ** 30:.3f} GiB resident)", flush=True)
    del grid, model, images, captions, out
    return counts


def retrieval_step_phase(dev, card: str, timed_steps: int = 4) -> dict:
    """The retrieval train step (Swin-S + BERT-base, 32 pairs = 64 rows,
    text 80, DropPath 0.3, attention dropout 0.1, hidden dropout 0.0) on the
    kernels and on the plain versions from one seed, the plain run
    replaying the kernel run's masks (:func:`paired_step_phase`): gradients
    from the initial parameters, the launch counts of one step (K1's split-K
    among them), the losses of 3 steps, then step times in turns and peak
    memory. Returns the launch counts of one step."""
    from mvlt_tpu_torch.flagship import build_retrieval_train_step

    def splitk(counts):
        if counts["gemm_splitk"] <= 0:
            raise AssertionError("K1's split-K never ran in the retrieval "
                                 "step")

    return paired_step_phase(
        dev, card, "retrieval step",
        lambda plain: build_retrieval_train_step(
            pairs=RETRIEVAL_PAIRS, text_len=RETRIEVAL_TEXT, device=dev,
            plain=plain),
        _retrieval_loss, swin_bars, EXPECTED_RETRIEVAL_STEP, timed_steps,
        extra_checks=splitk)


# ---------------------------------------------------------------------------
# the VQA task driver (python -m mvlt_tpu_torch.run_vqa)
# ---------------------------------------------------------------------------

def reference_caption_state_dict(cfg, seed: int = 0) -> dict:
    """A seeded checkpoint of the reference's ``MVLBertForImageCaption`` on
    a Swin backbone, in its names and layouts (numpy): the MSFT Swin under
    ``conv.conv.0.`` (fused ``qkv``, and the ``relative_position_index``
    buffers a real file carries), ``conv.resnet_fc`` where the widths
    differ, ``MVLBert.*`` (the embeddings, HF ``BertEncoder`` names, the
    pooler) and ``MLM_head_seq2seq.predictions.*``. Weights normal(0,
    0.02) in float32, LayerNorms 1 / 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def ln(prefix, dim):
        sd[prefix + ".weight"] = np.ones(dim, np.float32)
        sd[prefix + ".bias"] = np.zeros(dim, np.float32)

    def dense(prefix, d_out, d_in, bias=True):
        sd[prefix + ".weight"] = w(d_out, d_in)
        if bias:
            sd[prefix + ".bias"] = w(d_out)

    sw, f, p = cfg.swin, cfg.fusion, "conv.conv.0."
    sd[p + "patch_embed.proj.weight"] = w(sw.embed_dim, sw.in_chans,
                                          sw.patch_size, sw.patch_size)
    sd[p + "patch_embed.proj.bias"] = w(sw.embed_dim)
    ln(p + "patch_embed.norm", sw.embed_dim)
    for i, depth in enumerate(sw.depths):
        C, nH = sw.embed_dim * 2 ** i, sw.num_heads[i]
        win = min(sw.window_size, sw.patches_resolution[0] // 2 ** i)
        hidden = int(C * sw.mlp_ratio)
        for j in range(depth):
            b = f"{p}layers.{i}.blocks.{j}."
            ln(b + "norm1", C)
            ln(b + "norm2", C)
            dense(b + "attn.qkv", 3 * C, C)
            dense(b + "attn.proj", C, C)
            sd[b + "attn.relative_position_bias_table"] = w(
                (2 * win - 1) ** 2, nH)
            sd[b + "attn.relative_position_index"] = np.zeros(
                (win * win, win * win), np.int64)
            dense(b + "mlp.fc1", hidden, C)
            dense(b + "mlp.fc2", C, hidden)
        if i < len(sw.depths) - 1:
            ln(f"{p}layers.{i}.downsample.norm", 4 * C)
            dense(f"{p}layers.{i}.downsample.reduction", 2 * C, 4 * C,
                  bias=False)
    ln(p + "norm", sw.num_features)
    H, m = f.hidden_size, "MVLBert."
    if sw.num_features != H:
        dense("conv.resnet_fc", H, sw.num_features)
    sd[m + "word_embeddings.weight"] = w(f.embedding_rows, H)
    sd[m + "position_embeddings.weight"] = w(f.max_position_embeddings, H)
    sd[m + "token_type_embeddings.weight"] = w(f.type_vocab_size, H)
    for i in range(f.num_hidden_layers):
        e = f"{m}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(e + "attention.self." + n, H, H)
        dense(e + "attention.output.dense", H, H)
        ln(e + "attention.output.LayerNorm", H)
        dense(e + "intermediate.dense", f.intermediate_size, H)
        dense(e + "output.dense", H, f.intermediate_size)
        ln(e + "output.LayerNorm", H)
    dense(m + "pooler.dense", H, H)
    h = "MLM_head_seq2seq.predictions."
    dense(h + "transform.dense", H, H)
    ln(h + "transform.LayerNorm", H)
    sd[h + "decoder.weight"] = w(f.vocab_size, H)
    sd[h + "bias"] = w(f.vocab_size)
    return sd


def _leaves_passing(tree) -> int:
    """How many leaves of a flax-layout tree JAX's ``default_predicate``
    takes (``ops.quant.default_predicate`` on each leaf's shape)."""
    import numpy as np
    from mvlt_tpu_torch.ops.quant import default_predicate
    return sum(_leaves_passing(v) if isinstance(v, dict)
               else int(default_predicate(np.shape(v)))
               for v in tree.values())


class _Studies:
    """A caption test split as ``decode_reports`` reads it: ``images`` (n,
    3, H, W) f32, each with a placeholder report."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i, epoch=0):
        return {"image": self.images[i], "raw_caption": f"study {i}"}


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def caption_generate_int8w_phase(dev, card: str) -> dict:
    """Report generation on weight-only int8 through the port's entry,
    ``tasks.caption.decode_reports(..., quant="int8w")`` (Swin-S +
    BERT-base, b32, beam 5, length 150, unilm; f32 masters, bf16 compute,
    as ``run_report_generation`` serves): a seeded checkpoint in the
    reference's layout through ``caption_state_dict_from_torch``, loaded
    strictly into a ``TaskRunner``'s model. Held: the launches of one
    int8w decode of ``TRAIN_BATCH`` studies (one generate call), two int8w
    decodes bitwise equal, the count it logs against the predicate's count
    on the converted JAX-layout tree, ``eval_caption(quant="int8w")``'s
    scores finite; on the runner's int8 tree (``ops.quant.quantize_tree``,
    as the decode quantizes), kernels against plain: the features, the
    prefill's logits, the first decode step's. Recorded: the int8w first
    step against bf16's (max abs err over max|bf16|, cosine), the quantized
    bytes, the int8 tree's resident memory, each route's peak memory in a
    decode, tokens/s of the decode in turns (the median of
    ``INT8W_TIMED_CALLS`` after a warm-up). Returns the launch counts of
    one int8w decode."""
    import numpy as np
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.config import TrainConfig
    from mvlt_tpu_torch.models import generation as G
    from mvlt_tpu_torch.models.heads import CaptionModel
    from mvlt_tpu_torch.ops import kernels, quant
    from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
    from mvlt_tpu_torch.tasks.caption import decode_reports, eval_caption
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.utils import convert
    B, L, K = TRAIN_BATCH, CAPTION_TEXT, CAPTION_BEAMS
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(flagship.flagship_caption_config(),
                              max_length=L)
    sd = reference_caption_state_dict(cfg)
    kw = dict(num_layers=cfg.fusion.num_hidden_layers, conv=cfg.conv,
              depths=cfg.swin.depths)
    want_count = _leaves_passing(convert.caption_from_torch(sd, **kw)
                                 ["params"])
    # threads for the loader: the decode's time, not a worker pool's start
    runner = TaskRunner(CaptionModel, cfg, TrainConfig(num_workers=0),
                        name="caption-int8w", device=dev)
    runner.init_state()
    model = runner.model
    model.load_state_dict(convert.caption_state_dict_from_torch(sd, **kw))
    del sd
    log = _LogLines()
    runner.logger.addHandler(log)
    tok = WordPieceTokenizer()
    studies = _Studies(flagship._example_images(
        np.random.default_rng(0), B, 1, cfg.swin.img_size
    ).astype(np.float32))
    print(f"int8w caption runner: a reference-layout checkpoint converted "
          f"and loaded strictly in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def decode(q):
        return decode_reports(runner, studies, tok, batch_size=B,
                              num_beams=K, quant=q)

    reset_counts()
    ids = decode("int8w")[2]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one int8w decode_reports of {B} studies: "
          f"{json.dumps(counts)}", flush=True)
    _expect_counts(counts, EXPECTED_CAPTION_GENERATE, "one int8w decode",
                   [k.__name__ for k in kernels.FORWARD_KERNELS])
    logged = [m for m in log.lines if m.startswith("int8w serving")]
    if logged != [f"int8w serving: {want_count} tensors quantized"]:
        raise AssertionError(f"int8w decode logged {logged}; JAX's predicate "
                             f"selects {want_count} tensors")
    seqs = torch.tensor(ids[0])
    if not (seqs.shape == (B, L) and ((seqs >= 0) & (seqs < cfg.fusion
                                                     .vocab_size)).all()):
        raise AssertionError(f"int8w decode returned {seqs.shape} ids out of "
                             "range")
    if decode("int8w")[2] != ids:
        raise AssertionError("two int8w decodes differ")
    same = sum(a == b for a, b in zip(decode("")[2][0], ids[0]))
    scores = eval_caption(runner, studies, tok, batch_size=B, num_beams=K,
                          quant="int8w")
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"eval_caption(quant='int8w'): {scores}")
    print(f"int8w decode_reports: {logged[0]} (the predicate on the "
          f"converted tree: {want_count}); two decodes bitwise equal; beam "
          f"sequences equal to bf16's in {same} of {B} rows; "
          f"eval_caption(quant='int8w') scores {json.dumps(scores)}",
          flush=True)

    # the int8 tree the decode serves: its bytes and resident memory, and
    # its kernels against plain
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    qtree, n_q = quant.quantize_tree(dict(model.named_parameters()), cfg)
    torch.cuda.synchronize()
    resident_q = torch.cuda.memory_allocated() - before
    qb, ob = quant.quantized_bytes(qtree)
    print(f"int8w caption model: {n_q} tensors quantized in JAX's terms "
          f"({len(qtree)} port tensors); quantized bytes {qb} (int8 + f32 "
          f"scales) vs {ob} in bf16 ({qb / ob:.4f}); the int8 tree resident "
          f"on {card}: {resident_q} bytes", flush=True)
    image = torch.from_numpy(studies.images).to(dev)
    spec = G.GenerationSpec.from_config(cfg, num_beams=K)
    greedy = dataclasses.replace(spec, num_beams=1)

    def first_step(feat, ops, tok=None):
        """(prefill logits, first decode step's logits, its token)."""
        logits, kv, P = G._prefill(model, feat, greedy, ops)
        cache = G._make_cache(model, kv, P, B, greedy)
        tok = logits.float().argmax(-1) if tok is None else tok
        return logits, G._decode_logits(model, cache, tok, P, greedy,
                                        ops), tok

    with torch.no_grad():
        with quant.dequantized(model, qtree):
            feat = model.encode_image(image)
            _check_close("int8w caption Swin-S features, kernels vs plain",
                         feat, model.encode_image(image, plain=True))
            pre_p, step_p, first = first_step(feat, PLAIN_OPS)
            pre_k, step_k, _ = first_step(feat, KERNEL_OPS, first)
            _check_close("int8w caption prefill logits, kernels vs plain",
                         pre_k, pre_p)
            _check_close("int8w first decode step logits, kernels vs plain",
                         step_k, step_p)
        _, step_b, _ = first_step(model.encode_image(image), KERNEL_OPS,
                                  first)
    a, b = step_k.float(), step_b.float()
    err, scale = _max_err(a, b)
    cos = F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
    print(f"int8w vs bf16 first decode step logits on the kernels: max abs "
          f"err {err:.4g} / max|bf16| {scale:.4g} = {err / scale:.4g}; "
          f"cosine {cos:.6f}; argmax equal in "
          f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of {B} rows",
          flush=True)
    del feat, pre_p, pre_k, step_p, step_k, step_b, a, b, qtree, image

    times, peak, resident = {"bf16": [], "int8w": []}, {}, {}
    for r in range(INT8W_TIMED_CALLS):
        for which in (("bf16", "int8w") if r % 2 == 0 else ("int8w", "bf16")):
            torch.cuda.synchronize()
            if which not in peak:
                resident[which] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            decode("" if which == "bf16" else "int8w")
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t1)
            if which not in peak:
                peak[which] = torch.cuda.max_memory_allocated()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"caption decode_reports of {B} studies, beam {K}, length {L} on "
          f"{card}, kernels: " + ", ".join(
              f"{k} {B * L / v:.1f} tokens/s ({v * 1e3:.1f} ms a decode), "
              f"peak memory {peak[k] / 2 ** 30:.3f} GiB (with "
              f"{resident[k] / 2 ** 30:.3f} GiB resident: the f32 masters)"
              for k, v in med.items())
          + f"; runs (s) in turns {json.dumps(times)}", flush=True)
    runner.logger.removeHandler(log)
    del runner, model
    return counts


def swin_pretrain_remat_phase(dev, card: str, timed_steps: int = 4) -> dict:
    """The Swin-S step of record with ``remat_backbone`` and ``remat_fusion``
    against the step without, built from one seed, the remat run replaying
    the masks the other drew: from the initial parameters, the losses and
    every gradient in both mask modes (bitwise or within ``GRAD_BAR`` /
    ``SWIN_GRAD_BAR``; the tensors that differ are named), the forward rows
    launched twice (``REMAT_FORWARD_ROWS``) and the backward rows as often
    (``REMAT_BACKWARD_ROWS``); the same with ``MVLT_KERNEL_DROPOUT=1
    MVLT_STOREP=1`` (a recompute that drew a new seed would fail it); the
    losses of 3 steps; then ms/step and peak memory in turns (without,
    with, with, without). Returns the launch counts of one remat step."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.train.steps import seq2seq_coin_flip
    B = TRAIN_BATCH
    label = "Swin-S pretrain step with remat_backbone and remat_fusion"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_r, batch = flagship.build_swin_pretrain_train_step(
        batch=B, text_len=PRETRAIN_TEXT, device=dev,
        config=flagship.flagship_swin_remat_pretrain_config())
    step_n, _ = flagship.build_swin_pretrain_train_step(
        batch=B, text_len=PRETRAIN_TEXT, device=dev)
    model_r, model_n = step_r.model, step_n.model
    if not (model_r.conv.backbone.remat and model_r.fusion.remat):
        raise AssertionError("the remat flags did not reach the model")
    print(f"{label} and the step of record built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = ("image", "caption_masked", "caption_label", "itm_label")

    def loss_close(a, b, what):
        if a == b:
            return "bitwise equal"
        if not (abs(a - b) <= LOSS_BAR * abs(b) and a == a):
            raise AssertionError(f"{what}: {a} with remat vs {b} without, "
                                 f"beyond {LOSS_BAR} relative")
        return (f"within {LOSS_BAR} relative, not bitwise: the step's "
                "gradients differ where named above")

    def held(seq2seq: bool, what: str) -> None:
        masks = DropoutMasks(gen, record=True)
        counts, losses = {}, {}
        for which, model in (("without", model_n), ("with", model_r)):
            model.zero_grad(set_to_none=True)
            src = (masks if which == "without"
                   else DropoutMasks.replay(masks.recorded))
            reset_counts()
            loss, _ = model.loss(*(batch[k] for k in keys), seq2seq=seq2seq,
                                 masks=src)
            loss.backward()
            torch.cuda.synchronize()
            counts[which], losses[which] = launch_counts(), loss.item()
            if which == "with" and next(src._replay, None) is not None:
                raise AssertionError(f"{what}: the remat run left replayed "
                                     "masks")
        grads_n = {n: p.grad for n, p in model_n.named_parameters()}
        grads_r = {n: p.grad for n, p in model_r.named_parameters()}
        differ = [n for n, g in grads_r.items()
                  if g is not None and not torch.equal(g, grads_n[n])]
        compare_grad_dicts(grads_r, grads_n, f"{what} (kernels: with remat; "
                           "plain: without)", swin_bars)
        wrong = {n: (counts["with"][n], counts["without"][n])
                 for n in REMAT_FORWARD_ROWS + REMAT_BACKWARD_ROWS
                 if counts["with"][n] != counts["without"][n]
                 * (2 if n in REMAT_FORWARD_ROWS else 1)}
        ran = {n: counts["without"][n] for n in REMAT_FORWARD_ROWS
               if counts["without"][n]}
        print(f"{what}: loss {loss_close(losses['with'], losses['without'], what)} "
              f"({losses['with']} / {losses['without']}); "
              f"{sum(g is not None for g in grads_r.values()) - len(differ)} "
              f"gradients bitwise equal, {len(differ)} not "
              f"{differ[:8]}; forward rows without remat {json.dumps(ran)}, "
              "with remat twice as often, the backward rows as often: "
              f"{'yes' if not wrong else wrong}", flush=True)
        if wrong or not ran:
            raise AssertionError(f"{what}: launches (with, without) {wrong}")

    for seq2seq in (False, True):
        held(seq2seq, f"{label}, initial gradients "
                      f"({'seq2seq' if seq2seq else 'bidirectional'})")
    with switches(True):
        held(True, f"{label} with MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1, "
                   "initial gradients (seq2seq)")
    model_r.zero_grad(set_to_none=True)
    model_n.zero_grad(set_to_none=True)

    losses, counts = {"without": [], "with": []}, None
    for i, seq2seq in enumerate(PRETRAIN_MODES):
        step_n.masks = DropoutMasks(gen, record=True)
        losses["without"].append(step_n(batch, seq2seq)["loss"].item())
        step_r.masks = DropoutMasks.replay(step_n.masks.recorded)
        if i == 0:
            reset_counts()
        out = step_r(batch, seq2seq)
        if i == 0:
            torch.cuda.synchronize()
            counts = launch_counts()
        losses["with"].append(out["loss"].item())
    verdicts = [loss_close(a, b, f"step {i + 1} loss") for i, (a, b) in
                enumerate(zip(losses["with"], losses["without"]))]
    print(f"{label}: losses of {len(PRETRAIN_MODES)} steps with remat "
          f"{losses['with']}, without {losses['without']}: {verdicts}",
          flush=True)

    turns = ("without", "with", "with", "without")
    steps = {"without": step_n, "with": step_r}
    times, peak, resident = {t: [] for t in steps}, {}, {}
    for which in turns:
        step = steps[which]
        step.masks = DropoutMasks(torch.Generator(device=dev).manual_seed(2))
        flips = torch.Generator().manual_seed(0)
        step(batch, seq2seq_coin_flip(flips))
        torch.cuda.synchronize()
        measure = which not in peak
        if measure:
            resident[which] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(timed_steps):
            step(batch, seq2seq_coin_flip(flips))
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t1) * 1e3 / timed_steps)
        if measure:
            peak[which] = torch.cuda.max_memory_allocated()
    ms = {t: sum(v) / len(v) for t, v in times.items()}
    print(f"MLM+ITM Swin-S pretrain step b{B} (S = 131) on {card}, kernels: "
          + ", ".join(
              f"remat {t} {ms[t]:.3f} ms/step ({B * 1e3 / ms[t]:.1f} "
              f"samples/s), peak memory {peak[t] / 2 ** 30:.3f} GiB (with "
              f"{resident[t] / 2 ** 30:.3f} GiB resident, both models)"
              for t in ("without", "with"))
          + f"; runs {json.dumps(times)} ({timed_steps} steps a turn)",
          flush=True)
    del step_r, step_n, steps
    return counts


class _DriverRecorder:
    """What a driver phase watches while the driver runs unchanged: the
    loader's train batches as the host made them, each step's device batch,
    mask mode and metrics, the launch counts of the first step in each mode,
    (step 1) gradients, the runner of ``run_vqa.train_round``.
    :meth:`watching` installs it around the task module's ``DataLoader`` and
    step factory (``tasks.vqa.make_vqa_step``, or with ``task`` "pretrain",
    "caption" or "retrieval" that task's; a retrieval batch is compared as
    the ``cat(pos, neg)`` it becomes), ``TaskRunner.masks_for_step``
    and ``run_vqa.train_round``. Each step's masks are drawn as the runner
    draws them and copied to the host after the step (``masks``, by step),
    so that the card holds what the driver holds; with ``replay`` (masks by
    step) the steps take those masks instead."""

    def __init__(self, replay=None, task: str = "vqa"):
        self.host, self.same, self.losses, self.masks = [], [], [], []
        self.metrics, self.modes, self.mode_counts = [], [], {}
        self.grads = self.step_counts = self.runner = None
        self.replay = replay
        self.task = task

    @contextlib.contextmanager
    def watching(self):
        from mvlt_tpu_torch import run_vqa
        from mvlt_tpu_torch.data.loader import DataLoader
        from mvlt_tpu_torch.ops.layers import DropoutMasks
        from mvlt_tpu_torch.tasks import (caption, common, pretrain,
                                          retrieval, vqa)
        module, factory, keys = {
            "vqa": (vqa, "make_vqa_step", ("image", "question", "label")),
            "pretrain": (pretrain, "make_pretrain_step", PRETRAIN_KEYS),
            "caption": (caption, "make_caption_step",
                        ("image", "caption", "mlm_labels")),
            "retrieval": (retrieval, "make_retrieval_step",
                          retrieval.PAIR_KEYS)}[self.task]
        as_step = (retrieval.merge_pairs if self.task == "retrieval"
                   else lambda b: b)
        rec, make = self, getattr(module, factory)
        draw, train_round = common.TaskRunner.masks_for_step, run_vqa.train_round

        class Recording(DataLoader):
            def epoch(self, epoch=0):
                for b in super().epoch(epoch):
                    if self.shuffle:
                        rec.host.append(as_step(b))
                    yield b

        def masks_for_step(runner, offset=0):
            if rec.replay is not None:
                return DropoutMasks.replay(rec.replay[runner.state.step])
            return DropoutMasks(draw(runner, offset).generator, record=True)

        def make_step(model, optimizer, plain=False, **kw):
            inner = make(model, optimizer, plain=plain, **kw)

            def step(batch, *mode):
                inner.masks = step.masks
                i = len(rec.losses)
                rec.same.append(all(torch.equal(
                    batch[k].cpu(), torch.from_numpy(rec.host[i][k]))
                    for k in keys))
                key = mode[0] if mode else None
                first = key not in rec.mode_counts
                before = launch_counts()
                out = inner(batch, *mode)
                if first:
                    after = launch_counts()
                    rec.mode_counts[key] = {k: after[k] - before[k]
                                            for k in after}
                if i == 0:
                    torch.cuda.synchronize()
                    rec.step_counts = rec.mode_counts[key]
                    rec.grads = {n: p.grad.detach().to("cpu", copy=True)
                                 for n, p in model.named_parameters()}
                rec.modes.append(key)
                rec.metrics.append({k: v.item() for k, v in out.items()})
                rec.losses.append(rec.metrics[-1]["loss"])
                if step.masks.recorded is not None:
                    rec.masks.append([t.cpu() for t in step.masks.recorded])
                return out

            step.prefetch, step.masks = inner.prefetch, inner.masks
            return step

        def capture(*a, **kw):
            runner, best = train_round(*a, **kw)
            rec.runner = runner
            return runner, best

        with mock.patch.object(module, "DataLoader", Recording), \
                mock.patch.object(module, factory, make_step), \
                mock.patch.object(common.TaskRunner, "masks_for_step",
                                  masks_for_step), \
                mock.patch.object(run_vqa, "train_round", capture):
            yield self


def _state_tensors(obj, prefix=""):
    """{path: tensor} of a nested state (state_dicts of the model and the
    optimizer)."""
    if torch.is_tensor(obj):
        return {prefix: obj}
    out = {}
    items = (obj.items() if isinstance(obj, dict) else
             enumerate(obj) if isinstance(obj, (list, tuple)) else ())
    for k, v in items:
        out.update(_state_tensors(v, f"{prefix}/{k}"))
    return out


def _same_state(a, b, what: str) -> None:
    """Two train states bitwise equal: step, parameters and buffers,
    optimizer state."""
    if a.step != b.step:
        raise AssertionError(f"{what}: step {a.step} vs {b.step}")
    for part, x, y in (("model", a.model.state_dict(), b.model.state_dict()),
                       ("optimizer", _state_tensors(a.optimizer.state_dict()),
                        _state_tensors(b.optimizer.state_dict()))):
        if x.keys() != y.keys() or not x:
            raise AssertionError(f"{what}: {part} keys differ")
        bad = [k for k in x if not torch.equal(x[k], y[k])]
        if bad:
            raise AssertionError(f"{what}: {len(bad)} {part} tensors differ, "
                                 f"e.g. {bad[:3]}")


def _expect_counts(counts: dict, expected: dict, what: str,
                   launched) -> None:
    """Each counterpart's count in ``counts`` as ``expected`` says, and each
    kernel named in ``launched`` at least once."""
    for name, (want, _) in expected.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in {what}, "
                                 f"expected {want}")
    for name in launched:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in {what}")


def vqa_driver_phase(dev, card: str) -> dict:
    """The VQA task driver, ``python -m mvlt_tpu_torch.run_vqa``, at its
    defaults (Swin-S @224 + BERT-base, ``for_vqa``: dropouts 0.1, DropPath
    0.3, lr 4e-5, b64) on a synthetic SLAKE in pickles
    (``VQA_DRIVER_DATA``), 2 epochs, worker processes; then its first epoch
    on the plain versions, replaying the kernel run's masks. Checks: the
    launch counts of one driver step and one eval batch, every device batch
    bitwise its host batch in order, the losses of 3 steps and step 1's
    gradients against the plain run, eval logits against the plain
    versions, ``results.json``'s keys; a save and a restore into a fresh
    runner (state and eval predictions bitwise equal, one more step bitwise
    equal to the same step without the restore). Then times the bare step
    on a resident batch and eval, with the peak memory; with
    ``--loader-pace`` also, on a train split of SLAKE's length, one epoch
    of the driver's train loop for each of ``VQA_DRIVER_TIMED_WORKERS``
    between two runs of the bare step (samples/s, the epoch start, the
    steady interval between steps) and the loader alone. Returns the
    launch counts of the kernel run's whole ``run_vqa.main`` call."""
    import shutil

    from mvlt_tpu_torch import run_vqa
    from mvlt_tpu_torch.data.datasets import (SLAKE_SPLITS, MedVQADataset,
                                              write_synthetic_vqa)
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.vqa import eval_vqa, train_vqa
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_vqa_step
    root = REPO / "build" / "vqa_driver"
    shutil.rmtree(root, ignore_errors=True)
    d, B = VQA_DRIVER_DATA, VQA_DRIVER_BATCH
    bank = {k: d[k] for k in ("images", "answers", "image_size")}
    t0 = time.perf_counter()
    write_synthetic_vqa(str(root / "data"), "SLAKE", **bank,
                        splits={k: d[k] for k in ("train", "validate",
                                                  "test")})
    if LOADER_PACE:
        write_synthetic_vqa(str(root / "timed"), "SLAKE", **bank,
                            splits={"train": SLAKE_SPLITS["train"]})
    argv = ["--dataset", "SLAKE", "--data_root", str(root / "data"),
            "--epochs", str(VQA_DRIVER_EPOCHS), "--batch_size", str(B),
            "--device", str(dev)]
    print(f"vqa driver: synthetic SLAKE written in "
          f"{time.perf_counter() - t0:.1f} s ({d}; for the timed loops a "
          f"train split of {SLAKE_SPLITS['train']}); run_vqa "
          f"{' '.join(argv)}", flush=True)

    # 1. the driver on the kernels, worker processes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec_k = _DriverRecorder()
    reset_counts()
    t0 = time.perf_counter()
    with rec_k.watching():
        results = run_vqa.main(argv + [
            "--model_name", str(root / "kernels"),
            "--num_workers", str(VQA_DRIVER_WORKERS)])
    torch.cuda.synchronize()
    counts = launch_counts()
    run_s = time.perf_counter() - t0
    runner_k = rec_k.runner
    steps = VQA_DRIVER_EPOCHS * (d["train"] // B)
    print(f"vqa driver run (kernels, {VQA_DRIVER_WORKERS} worker processes): "
          f"{run_s:.1f} s for {steps} steps, {VQA_DRIVER_EPOCHS} valid and 2 "
          f"test evals, the saves and the restore; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (the "
          f"checks' copies of masks and gradients on the host); results "
          f"{json.dumps(results)}", flush=True)
    print(f"launches in the driver run: {json.dumps(counts)}", flush=True)
    print(f"launches in one driver step: {json.dumps(rec_k.step_counts)}",
          flush=True)
    _expect_counts(rec_k.step_counts, EXPECTED_VQA_DRIVER_STEP,
                   "one driver step",
                   [k.__name__ for k in kernels.KERNELS] + ["gemm_splitk"])
    on_disk = json.loads((root / "kernels" / "results.json").read_text())
    keys = {"valid_acc", "epoch", "test_final", "test"}
    split_keys = {"overall", "total", "correct", "open", "closed"}
    if (on_disk != json.loads(json.dumps(results)) or len(on_disk) != 1
            or set(on_disk[0]) != keys
            or any(set(on_disk[0][s]) != split_keys
                   or on_disk[0][s]["total"] != d["test"]
                   for s in ("test", "test_final"))):
        raise AssertionError(f"results.json lacks JAX's keys: {on_disk}")
    if len(rec_k.same) != steps or not all(rec_k.same):
        raise AssertionError(f"device batches vs host batches: {rec_k.same}")
    print(f"vqa driver: {len(rec_k.same)} device batches bitwise equal to "
          f"their host batches, in order; results.json has JAX's keys",
          flush=True)

    # one eval batch's launches, on a split of one batch
    args = run_vqa.parse_args(argv)
    tok = WordPieceTokenizer()
    train_ds, _, test_ds = run_vqa.build_datasets(args, tok)
    one = MedVQADataset(str(root / "data"), "SLAKE", "validate")
    one.entries = one.entries[:B]
    one.tokenize(tok)
    before = launch_counts()
    eval_vqa(runner_k, one, B)
    after = launch_counts()
    eval_counts = {k: after[k] - before[k] for k in after}
    print(f"launches in one eval batch: {json.dumps(eval_counts)}",
          flush=True)
    _expect_counts(eval_counts, EXPECTED, "one eval batch",
                   ("gemm", "biased_attention", "layernorm"))

    # eval logits, kernels vs plain, on the trained model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             rec_k.host[0].items() if k in ("image", "question")}
    _, lk = runner_k.model(batch["image"], batch["question"])
    _, lp = runner_k.model(batch["image"], batch["question"], plain=True)
    _check_close(f"vqa driver eval logits b{B}", lk, lp)

    # 2. the first epoch on the plain versions from the same seed, replaying
    # the kernel run's masks
    _replayed_epoch(rec_k, "vqa", runner_k, VQAModel,
                    lambda r, ds: train_vqa(r, ds, epochs=1), train_ds,
                    "vqa driver")

    # 3. a save, then a restore into a fresh runner
    runner_k.save()
    runner_k.finish()
    fresh = TaskRunner(VQAModel, runner_k.config, runner_k.train_config,
                       workdir=runner_k.workdir, name="vqa-restore",
                       device=dev)
    fresh.init_state()
    if not fresh.maybe_restore():
        raise AssertionError("the fresh runner found no checkpoint")
    _same_state(runner_k.state, fresh.state, "restored state")
    preds = []
    for r, name in ((runner_k, "kernels"), (fresh, "restored")):
        path = root / f"predictions_{name}.json"
        eval_vqa(r, test_ds, B, predictions_path=str(path))
        preds.append(json.loads(path.read_text()))
    if preds[0] != preds[1]:
        raise AssertionError("eval predictions differ after the restore")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             rec_k.host[1].items() if k in ("image", "question", "label")}
    for r in (runner_k, fresh):
        step = make_vqa_step(r.model, r.optimizer)
        step.masks = r.masks_for_step()
        step(batch)
        r.state.step += 1
    torch.cuda.synchronize()
    _same_state(runner_k.state, fresh.state, "one step after the restore")
    print(f"vqa driver: saved at step {fresh.state.step - 1}, restored into a "
          f"fresh runner: parameters, optimizer state, step and "
          f"{len(preds[0])} test predictions bitwise equal; one more step "
          f"bitwise equal", flush=True)
    # only the kernel run's model and optimizer stay for the timed loops
    del fresh, step, r, rec_k
    gc.collect()
    torch.cuda.empty_cache()

    # 4. times: the bare step on a resident batch; with --loader-pace, one
    # epoch of a SLAKE-length train split through train_vqa for each loader
    # setting between two runs of it (the host marks each step where the
    # loop logs it)
    bare = make_vqa_step(runner_k.model, runner_k.optimizer)

    def bare_rate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VQA_DRIVER_BARE_STEPS):
            bare.masks = runner_k.masks_for_step()
            bare(batch)
            runner_k.state.step += 1
        torch.cuda.synchronize()
        return VQA_DRIVER_BARE_STEPS * B / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    bare_rates = [bare_rate()]
    loops = {}
    if LOADER_PACE:
        long_ds = MedVQADataset(str(root / "timed"), "SLAKE", "train")
        long_ds.tokenize(tok)
        loops = {w: timed_epoch(runner_k,
                                lambda r, ds: train_vqa(r, ds, epochs=1),
                                long_ds, w, len(long_ds) // B)
                 for w in VQA_DRIVER_TIMED_WORKERS}
    bare_rates.append(bare_rate())
    peak = torch.cuda.max_memory_allocated()
    bare_ms = B * 1e3 * 2 / sum(bare_rates)
    print(f"vqa driver bare step on {card}: {[round(r, 1) for r in bare_rates]}"
          f" samples/s before and after the loops, {bare_ms:.1f} ms a step",
          flush=True)
    for workers, marks in loops.items():
        print(loop_line("vqa driver", card, "", workers, marks, B, bare_ms),
              flush=True)
    if LOADER_PACE:
        loader_probe(long_ds)
    eval_rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_vqa(runner_k, test_ds, B)
        eval_rates.append(len(test_ds) / (time.perf_counter() - t0))
    print(f"vqa driver on {card}: eval (test split, {len(test_ds)} questions, "
          f"b{B} + tail) {[round(r, 1) for r in eval_rates]} samples/s; peak "
          f"memory in the timed loops (bare steps and train_vqa) "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    return counts


def timed_epoch(runner, train, dataset, workers: int, steps: int) -> list:
    """One epoch through ``train(runner, dataset)`` with the loader's
    ``num_workers=workers`` and no saves, the host marking each step where
    the loop logs it. Returns the marks, then the epoch's end, in seconds
    from its start; raises unless ``steps`` steps were logged."""
    tc, workdir = runner.train_config, runner.workdir
    marks, log_step = [], runner.log_step

    def marked_log(metrics, samples):
        marks.append(time.perf_counter())
        log_step(metrics, samples)

    runner.train_config = dataclasses.replace(tc, num_workers=workers)
    runner.workdir, runner.log_step = None, marked_log
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(runner, dataset)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    finally:
        del runner.log_step
        runner.train_config, runner.workdir = tc, workdir
    if len(marks) != steps + 1:
        raise AssertionError(f"{len(marks) - 1} steps logged, {steps} run")
    return [m - t0 for m in marks]


def loop_line(what: str, card: str, setting: str, workers: int, marks: list,
              rows: int, bare_ms: float) -> str:
    """The record of one :func:`timed_epoch` (``rows`` samples a step):
    samples/s beside the bare rate, the first step's wait, and the pace
    while the loader builds, between steps ``DRIVER_STEADY_FROM + 1`` and
    ``per - DRIVER_STEADY_FROM`` (the read-ahead neither filling nor
    draining): the mean interval (the rate the loop keeps, whether the
    batches come evenly or in bursts of a pool's workers), the median and
    the 10th-90th percentile, each beside the bare step."""
    import statistics
    from mvlt_tpu_torch.data.loader import auto_workers
    per, k = len(marks) - 1, DRIVER_STEADY_FROM
    last = per - k
    if last - k < 9:
        raise AssertionError(f"an epoch of {per} steps leaves fewer than 8 "
                             f"intervals outside the loader's read-ahead "
                             f"({k} steps at each end)")
    rate = per * rows / marks[-1]
    gaps = sorted(b - a for a, b in zip(marks[:per - 1], marks[1:per]))
    steady = sorted(b - a for a, b in
                    zip(marks[k:last - 1], marks[k + 1:last]))
    mean = (marks[last - 1] - marks[k]) / (last - 1 - k)
    med, q = statistics.median(steady), len(steady) // 10
    n = auto_workers(workers)
    kind = f"{n} processes" if n else "threads"
    return (f"{what} loop on {card}, {setting}num_workers={workers} "
            f"({kind}): one epoch of {per} steps {rate:.1f} samples/s "
            f"({rate * bare_ms / (rows * 1e3):.3f} x the bare rate); the "
            f"first step logged {marks[0] * 1e3:.1f} ms after the epoch began; "
            f"steps {k + 1}-{last}, while the loader builds: {mean * 1e3:.1f} "
            f"ms a step on average ({mean * 1e3 / bare_ms:.3f} x the bare "
            f"step), "
            f"median {med * 1e3:.1f} ms ({med * 1e3 / bare_ms:.3f} x), "
            f"{steady[q] * 1e3:.1f}-{steady[-1 - q] * 1e3:.1f} from the 10th "
            f"to the 90th percentile; over all steps {gaps[0] * 1e3:.1f}-"
            f"{gaps[-1] * 1e3:.1f} ms")


def loader_probe(train_ds, batch: int = VQA_DRIVER_BATCH,
                 settings=VQA_DRIVER_TIMED_WORKERS) -> None:
    """The loader alone, on the host in this process (CUDA up, the model
    resident), for each ``num_workers`` of ``settings``: the time to create
    and close the fork pool alone, then ``VQA_PROBE_BATCHES`` batches of
    ``batch`` samples of a shuffled epoch of ``train_ds`` with no step in
    between (the first, and the median interval over the second half, past
    the lookahead); the epoch is then abandoned."""
    import multiprocessing
    import statistics

    from mvlt_tpu_torch.data.loader import DataLoader, auto_workers
    for workers in settings:
        n = auto_workers(workers)
        pool_ms = None
        if n:
            t0 = time.perf_counter()
            with multiprocessing.get_context("fork").Pool(n) as pool:
                pool.map(abs, range(n))
            pool_ms = (time.perf_counter() - t0) * 1e3
        loader = DataLoader(train_ds, batch, shuffle=True, drop_last=True,
                            num_workers=workers)
        epoch = loader.epoch(7)
        t0 = time.perf_counter()
        marks = []
        for _ in range(VQA_PROBE_BATCHES):
            next(epoch)
            marks.append(time.perf_counter())
        epoch.close()
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        late = gaps[len(gaps) // 2:]
        kind = f"{n} processes" if n else f"{loader.num_threads} threads"
        pool = ("no fork pool" if pool_ms is None else
                f"a fork pool of {n} created and closed in {pool_ms:.1f} ms")
        print(f"loader alone, num_workers={workers} ({kind}): {pool}; first "
              f"batch of an epoch after {(marks[0] - t0) * 1e3:.1f} ms; over "
              f"batches {VQA_PROBE_BATCHES - len(late)}-{VQA_PROBE_BATCHES} "
              f"{statistics.median(late):.1f} ms median a batch "
              f"({min(late):.1f}-{max(late):.1f})", flush=True)


def _frames_normalize_check(dev, frames) -> None:
    """``device_var_normalize`` on the card against ``normalize_image_var``
    on the host for the same uint8 (B, H, W, 3) frames: within
    ``NORMALIZE_BAR`` x max|out| beyond the host's own distance from the
    float64 value (both sum in f32, in other orders)."""
    from mvlt_tpu_torch.data.transforms import normalize_image_var
    from mvlt_tpu_torch.models.backbones.adapter import device_var_normalize
    got = device_var_normalize(torch.from_numpy(frames).to(dev)).cpu()
    host = torch.from_numpy(normalize_image_var(frames.transpose(0, 3, 1, 2)))
    x = torch.from_numpy(frames).double()
    var, mean = torch.var_mean(x, dim=(-3, -2), correction=0, keepdim=True)
    exact = ((x - mean) / var).movedim(-1, -3)
    scale = exact.abs().max().item()
    err = (got.double() - host.double()).abs().max().item()
    own = (host.double() - exact).abs().max().item()
    card_err = (got.double() - exact).abs().max().item()
    print(f"device_var_normalize on the card vs normalize_image_var on the "
          f"host, {tuple(frames.shape)} uint8: max abs err {err:.4g} "
          f"({err / scale:.3g} x max|out|); the host's own distance from "
          f"float64 {own / scale:.3g}, the card's {card_err / scale:.3g}; "
          f"bar: the host's own + {NORMALIZE_BAR} x max|out|", flush=True)
    if not (got.dtype == torch.float32 and err <= own + NORMALIZE_BAR * scale):
        raise AssertionError("device_var_normalize disagrees with the host")


def table_check(grads, tables, what: str) -> None:
    """The Swin relative-position tables' gradients of a step computed three
    ways, ``grads`` = [kernels bf16, plain bf16, plain f32] by name: each
    table's gradient sums ds over up to 2048 windows, where the two bf16
    routes' roundings cancel unevenly and each sits a few hundredths of
    max|f32 grad| from the f32 one. The kernels' table is held to the f32
    one within the plain bf16 route's own distance from it plus
    ``SWIN_GRAD_BAR``, both relative to max|f32 grad|."""
    rows, failures = [], []
    for n in tables:
        gk, gp, gf = (g[n].float() for g in grads)
        scale = gf.abs().max().item()
        ek = (gk - gf).abs().max().item() / scale
        ep = (gp - gf).abs().max().item() / scale
        ekp = (gk - gp).abs().max().item() / gp.abs().max().item()
        rows.append((ek, ep, ekp, n))
        if not ek <= ep + SWIN_GRAD_BAR:
            failures.append((n, ek, ep))
    worst = max(rows)
    print(f"{what}, {len(rows)} relative-position tables: kernels vs f32 "
          f"worst {worst[0]:.4g} ({worst[3]}; the plain bf16 route there "
          f"{worst[1]:.4g}); plain bf16 vs f32 worst "
          f"{max(r[1] for r in rows):.4g}; kernels vs plain bf16 worst "
          f"{max(r[2] for r in rows):.4g} (max abs err / max|reference grad|;"
          f" bar: the plain route's own + {SWIN_GRAD_BAR})", flush=True)
    if failures:
        raise AssertionError(f"{len(failures)} table gradients beyond the "
                             f"bar: {failures[:5]}")


def _pretrain_batch(dataset, n: int) -> dict:
    """The first ``n`` samples of ``dataset`` (epoch 0) stacked, as numpy."""
    import numpy as np
    rows = [dataset[i] for i in range(n)]
    return {k: np.stack([np.asarray(r[k]) for r in rows])
            for k in PRETRAIN_KEYS}


def pretrain_driver_phase(dev, card: str) -> dict:
    """The pretrain driver, ``python -m mvlt_tpu_torch.run_pretrain``, at
    its defaults (Swin-S @224 + BERT-base, ``for_pretrain``: dropouts 0.1,
    DropPath 0.3, ITM, text 80, lr 4e-5, b32) on the RGC f32 pickles of a
    synthetic corpus (``PRETRAIN_DRIVER_DATA``), 2 epochs of 3 steps with
    loader worker processes; then its first epoch on the plain versions,
    replaying the kernel run's masks (the flips agree: they are seeded by
    (seed, epoch, batch)). Checks: the launch counts of one driver step in
    each mode, the flips, every device batch bitwise its host batch in order,
    the losses of 3 steps and step 1's gradients against the plain run, both
    exports and the last one merged into a fresh VQA runner, the driver's
    last checkpoint restored into a fresh runner (state bitwise, one more
    step bitwise), ``device_var_normalize`` against the host, one step on
    a uint8 batch (prefetched as uint8) against its plain step, and the
    ROCO split's frames equal to the uint8 cache's. Then times a bare step
    on a resident uint8 batch in each mode, with the peak memory; with
    ``--loader-pace`` also one epoch of ``PRETRAIN_TIMED_SAMPLES`` through
    ``train_pretrain`` for each source (uint8 cache, RGC f32 pickles) and
    each of ``PRETRAIN_TIMED_WORKERS``, and the loader alone. Returns ``{"run": launch
    counts of the whole run_pretrain.main call, "step": {mode: launch
    counts of one driver step}}``."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import PIL

    from mvlt_tpu_torch import run_pretrain
    from mvlt_tpu_torch.data.datasets import (PretrainDataset, U8CacheSource,
                                              write_synthetic_pretrain)
    from mvlt_tpu_torch.models.heads import PretrainModel, VQAModel
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.tasks import common
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.pretrain import batch_mode, train_pretrain
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_pretrain_step
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib
    root = REPO / "build" / "pretrain_driver"
    shutil.rmtree(root, ignore_errors=True)
    d, B, E = PRETRAIN_DRIVER_DATA, PRETRAIN_DRIVER_BATCH, PRETRAIN_DRIVER_EPOCHS
    t0 = time.perf_counter()
    data = write_synthetic_pretrain(str(root / "data"), **d)
    timed = write_synthetic_pretrain(
        str(root / "timed"), n=PRETRAIN_TIMED_SAMPLES,
        image_size=d["image_size"], seed=d["seed"] + 1,
        roco=False) if LOADER_PACE else data
    argv = ["--rgc_index", data["rgc_index"], "--epochs", str(E),
            "--batch_size", str(B), "--device", str(dev)]
    print(f"pretrain driver: Pillow {PIL.__version__}; synthetic corpus "
          f"written in {time.perf_counter() - t0:.1f} s ({d}: RGC f32 "
          f"pickles, a uint8 cache, a ROCO split of PNG frames; for the "
          f"timed loops {PRETRAIN_TIMED_SAMPLES} samples as RGC pickles and "
          f"a uint8 cache); run_pretrain {' '.join(argv)}", flush=True)

    # 1. the driver on the kernels, worker processes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec_k = _DriverRecorder(task="pretrain")
    reset_counts()
    t0 = time.perf_counter()
    with rec_k.watching():
        runner_k = run_pretrain.main(argv + [
            "--model_name", str(root / "kernels"),
            "--export_dir", str(root / "export"),
            "--num_workers", str(PRETRAIN_DRIVER_WORKERS)])
    torch.cuda.synchronize()
    counts = launch_counts()
    run_s = time.perf_counter() - t0
    tc = runner_k.train_config
    per = d["n"] // B
    steps = E * per
    modes = [batch_mode(tc, e, i) for e in range(E) for i in range(per)]
    print(f"pretrain driver run (kernels, {PRETRAIN_DRIVER_WORKERS} worker "
          f"processes): {run_s:.1f} s for {steps} steps (modes "
          f"{['seq2seq' if m else 'bidirectional' for m in modes]}), "
          f"{E} checkpoints and {2 * E} exports; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; losses "
          f"{json.dumps(rec_k.metrics)}", flush=True)
    print(f"launches in the pretrain driver run: {json.dumps(counts)}",
          flush=True)
    by_mode = {}
    for mode, c in sorted(rec_k.mode_counts.items()):
        name = "seq2seq" if mode else "bidirectional"
        by_mode[name] = c
        print(f"launches in one pretrain driver step ({name}): "
              f"{json.dumps(c)}", flush=True)
        _expect_counts(c, EXPECTED_SWIN_PRETRAIN,
                       f"one pretrain driver step ({name})",
                       [k.__name__ for k in kernels.KERNELS] + ["gemm_splitk"])
    if rec_k.modes != modes or set(by_mode) != {"bidirectional", "seq2seq"}:
        raise AssertionError(f"driver modes {rec_k.modes}, seeded {modes}")
    if len(rec_k.same) != steps or not all(rec_k.same):
        raise AssertionError(f"device batches vs host batches: {rec_k.same}")
    if runner_k.state.step != steps:
        raise AssertionError(f"runner at step {runner_k.state.step}")
    exports = [root / "export"] + [root / f"export_epoch{e}" for e in range(E)]
    for path in exports:
        if not ((path / "config.json").is_file()
                and (path / "model.pt").is_file()):
            raise AssertionError(f"no export in {path}")
    print(f"pretrain driver: {len(rec_k.same)} device batches bitwise equal "
          f"to their host batches, in order; the seeded flips; exports "
          f"{[p.name for p in exports]}", flush=True)

    # the last export into a fresh VQA runner: every shared tensor loaded
    cfg_e, sd = ckpt_lib.load_pretrained(str(root / "export"))
    vqa = TaskRunner(VQAModel, dataclasses.replace(cfg_e, result_num=224),
                     dataclasses.replace(tc, num_workers=0), device=dev,
                     name="vqa-from-pretrain")
    vqa.init_state()
    used, total = common._merge_pretrained(vqa.model, sd, vqa.logger)
    own = vqa.model.state_dict()
    head = sum(common.flax_leaves(k) for k in own
               if k.startswith("final_mlp."))
    if used != total - head or not all(
            torch.equal(own[k].cpu(), sd[k]) for k in own if k in sd):
        raise AssertionError(f"export into a VQA runner: loaded {used}/"
                             f"{total}, the head has {head}")
    print(f"pretrain export into a fresh VQA runner: loaded {used}/{total} "
          f"pretrained tensors (all but the answer head's {head})",
          flush=True)
    del vqa, own, sd

    # 2. the first epoch on the plain versions, replaying the masks
    args = run_pretrain.parse_args(argv)
    tok = WordPieceTokenizer()
    train_ds = PretrainDataset(run_pretrain.build_source(args), tok,
                               max_length=args.max_length,
                               mlm_task=runner_k.config.mlm_task,
                               itm_task=runner_k.config.itm_task)
    rec_p = _DriverRecorder(replay=rec_k.masks, task="pretrain")
    plain = TaskRunner(PretrainModel, runner_k.config,
                       dataclasses.replace(tc, num_workers=0),
                       name="pretrain-plain", device=dev, plain=True)
    plain.init_state()
    with rec_p.watching():
        train_pretrain(plain, train_ds, epochs=1)
    print(f"pretrain driver losses of {per} steps: kernels "
          f"{json.dumps(rec_k.metrics[:per])}, plain "
          f"{json.dumps(rec_p.metrics)}", flush=True)
    if rec_p.modes != modes[:per] or not all(rec_p.same):
        raise AssertionError("the plain epoch's modes or batches differ")
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("mlm_loss", "itm_loss")}
           for a, b in zip(rec_k.metrics, rec_p.metrics)]
    print(f"pretrain driver losses, kernels vs plain, relative: "
          f"{json.dumps(rel)} (bars {PRETRAIN_DRIVER_LOSS_BAR} at step 1, "
          f"{LOSS_BAR} after it)", flush=True)
    for i, r in enumerate(rel):
        bar = PRETRAIN_DRIVER_LOSS_BAR if i == 0 else LOSS_BAR
        for k, v in r.items():
            if not v <= bar:
                raise AssertionError(f"driver step {i + 1} {k} {v} relative "
                                     f"to the plain run's, beyond {bar}")
    compare_grad_dicts(rec_k.grads, rec_p.grads,
                       "pretrain driver step 1 gradients", swin_bars)
    rec_k.grads = rec_k.masks = None
    del rec_p, plain
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the driver's last checkpoint restored into a fresh runner
    runner_k.finish()
    fresh = TaskRunner(PretrainModel, runner_k.config, tc,
                       workdir=runner_k.workdir, name="pretrain-restore",
                       device=dev)
    fresh.init_state()
    if not fresh.maybe_restore():
        raise AssertionError("the fresh runner found no checkpoint")
    _same_state(runner_k.state, fresh.state, "restored state")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             rec_k.host[1].items() if k in PRETRAIN_KEYS}
    for r in (runner_k, fresh):
        step = make_pretrain_step(r.model, r.optimizer)
        step.masks = r.masks_for_step()
        step(batch, True)
        r.state.step += 1
    torch.cuda.synchronize()
    _same_state(runner_k.state, fresh.state, "one step after the restore")
    print(f"pretrain driver: its checkpoint at step {steps} restored into a "
          f"fresh runner: parameters, optimizer state and step bitwise "
          f"equal; one more (seq2seq) step bitwise equal", flush=True)
    del fresh, step, r, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the uint8 input: the normalize, one step against its plain step,
    # the ROCO split's frames
    u8_ds = PretrainDataset(U8CacheSource(data["u8_cache"]), tok,
                            max_length=args.max_length)
    host = _pretrain_batch(u8_ds, B)
    _frames_normalize_check(dev, host["image"])
    # kernels and plain in bf16, and the plain versions in f32 as the
    # reference the relative-position tables are held to
    runners = []
    for name, plain_route, bf16 in (("kernels", False, True),
                                    ("plain", True, True),
                                    ("plain f32", True, False)):
        r = TaskRunner(PretrainModel, runner_k.config,
                       dataclasses.replace(tc, bf16_compute=bf16), device=dev,
                       name=f"u8-{name}", plain=plain_route)
        r.init_state()
        runners.append(r)
    mode = batch_mode(tc, 0, 0)
    outs = []
    for r in runners:
        step = make_pretrain_step(r.model, r.optimizer, plain=r.plain)
        b = next(iter(step.prefetch(iter([host]))))
        if b["image"].dtype != torch.uint8 or b["image"].device != dev:
            raise AssertionError(f"the prefetched image is {b['image'].dtype}"
                                 f" on {b['image'].device}")
        if r.plain:
            step.masks = DropoutMasks.replay(recorded)
        else:
            step.masks = DropoutMasks(r.masks_for_step().generator,
                                      record=True)
        outs.append({k: v.item() for k, v in step(b, mode).items()})
        if not r.plain:
            recorded = step.masks.recorded
    print(f"uint8 step ({'seq2seq' if mode else 'bidirectional'}, the batch "
          f"prefetched as uint8, {host['image'].nbytes / 2 ** 20:.2f} MiB): "
          f"kernels {json.dumps(outs[0])}, plain {json.dumps(outs[1])}, "
          f"plain f32 {json.dumps(outs[2])}", flush=True)
    for k in ("mlm_loss", "itm_loss"):
        a, b = outs[0][k], outs[1][k]
        if not abs(a - b) <= PRETRAIN_DRIVER_LOSS_BAR * abs(b):
            raise AssertionError(f"uint8 step {k} {a} vs plain {b}")
    grads = [{n: p.grad for n, p in r.model.named_parameters()}
             for r in runners]
    tables = [n for n in grads[0]
              if n.endswith(".relative_position_bias_table")]
    compare_grad_dicts({n: g for n, g in grads[0].items() if n not in tables},
                       grads[1], "uint8 step gradients but the tables",
                       swin_bars)
    table_check(grads, tables, "uint8 step")
    del runners, r, step, b, recorded, grads
    gc.collect()
    torch.cuda.empty_cache()
    roco = run_pretrain.build_source(run_pretrain.parse_args(
        ["--roco_root", data["roco_root"]]))
    roco.image_size = d["image_size"]
    cache = U8CacheSource(data["u8_cache"])
    if roco.normalize != "device" or not all(
            np.array_equal(roco[i][0], cache[i][0]) for i in range(len(cache))):
        raise AssertionError("ROCO frames differ from the uint8 cache's")
    print(f"ROCO split ({len(roco)} PNG frames, normalize={roco.normalize!r}) "
          f"decodes to the uint8 cache's frames bitwise", flush=True)

    # 5. times: bare steps on a resident uint8 batch in each mode; with
    # --loader-pace, one epoch per source and loader setting through
    # train_pretrain between two runs of them
    sources = {"uint8 cache": U8CacheSource(timed["u8_cache"]),
               "RGC f32 pickles": run_pretrain.build_source(
                   run_pretrain.parse_args(["--rgc_index",
                                            timed["rgc_index"]]))}
    sets = {name: PretrainDataset(src, tok, max_length=args.max_length)
            for name, src in sources.items()}
    resident = {k: torch.from_numpy(v).to(dev) for k, v in
                _pretrain_batch(sets["uint8 cache"], B).items()}
    bare = make_pretrain_step(runner_k.model, runner_k.optimizer)

    def bare_rates():
        out = {}
        for seq2seq in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PRETRAIN_DRIVER_BARE_STEPS):
                bare.masks = runner_k.masks_for_step()
                bare(resident, seq2seq)
                runner_k.state.step += 1
            torch.cuda.synchronize()
            out["seq2seq" if seq2seq else "bidirectional"] = (
                PRETRAIN_DRIVER_BARE_STEPS * B / (time.perf_counter() - t0))
        return out

    torch.cuda.reset_peak_memory_stats()
    rates = [bare_rates()]
    per_t = PRETRAIN_TIMED_SAMPLES // B
    loops = {(name, w): timed_epoch(
                 runner_k, lambda r, d: train_pretrain(r, d, epochs=1), ds, w,
                 per_t)
             for name, ds in sets.items() for w in PRETRAIN_TIMED_WORKERS
             if LOADER_PACE}
    rates.append(bare_rates())
    peak = torch.cuda.max_memory_allocated()
    bare_rate = statistics.mean(r for x in rates for r in x.values())
    bare_ms = B * 1e3 / bare_rate
    print(f"pretrain driver bare step (b{B}, resident uint8 batch) on {card}:"
          f" {json.dumps([{k: round(v, 1) for k, v in x.items()} for x in rates])}"
          f" samples/s before and after the loops, {bare_ms:.1f} ms a step",
          flush=True)
    for (name, workers), marks in loops.items():
        print(loop_line("pretrain driver", card, f"{name}, ", workers, marks,
                        B, bare_ms), flush=True)
    for name, ds in sets.items() if LOADER_PACE else ():
        print(f"loader alone, {name}:", flush=True)
        loader_probe(ds, B, PRETRAIN_TIMED_WORKERS)
    print(f"pretrain driver: peak memory in the timed loops (bare steps and "
          f"train_pretrain) {peak / 2 ** 30:.3f} GiB on {card}", flush=True)
    return {"run": counts, "step": by_mode}


# ---------------------------------------------------------------------------
# the report generation and retrieval drivers on a synthetic IU X-Ray tree
# ---------------------------------------------------------------------------

def iu_xray_trees() -> dict:
    """The synthetic IU X-Ray trees the two task drivers read, written once
    under ``build/iu_xray`` (kept while their parameters are the same):
    ``data`` (``IU_XRAY_DATA``) and, with ``--loader-pace``, ``timed``
    (``IU_XRAY_TIMED`` train studies, no test split; else ``timed`` is the
    data tree). Returns the two ``<dir>/iu_xray`` roots."""
    import shutil
    from mvlt_tpu_torch.data.datasets import write_synthetic_iu_xray
    root = REPO / "build" / "iu_xray"
    want = {"data": IU_XRAY_DATA,
            "timed": dict(IU_XRAY_DATA, seed=IU_XRAY_DATA["seed"] + 1,
                          splits={"train": IU_XRAY_TIMED, "test": 0})}
    if not LOADER_PACE:             # the bare steps read the data tree
        want.pop("timed")
    marker = root / "params.json"
    if not (marker.is_file() and json.loads(marker.read_text()) == want):
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.perf_counter()
        for name, kw in want.items():
            write_synthetic_iu_xray(str(root / name / "iu_xray"), **kw)
        marker.write_text(json.dumps(want))
        print(f"synthetic IU X-Ray trees written in "
              f"{time.perf_counter() - t0:.1f} s: {json.dumps(want)}",
              flush=True)
    out = {name: str(root / name / "iu_xray") for name in want}
    return {"timed": out["data"], **out}


def _resident(dataset, n: int, dev, merge=None) -> dict:
    """The first ``n`` samples of ``dataset`` (epoch 0) collated as the
    loader collates them, their arrays on ``dev`` (``merge``: a retrieval
    batch's ``cat(pos, neg)``)."""
    from mvlt_tpu_torch.data.loader import _collate
    batch = _collate([dataset[i] for i in range(n)])
    batch = merge(batch) if merge else batch
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
            if hasattr(v, "dtype") and v.dtype.kind in "uif"}


def task_driver_loops(runner, sets: dict, train, bare, rows: int, what: str,
                      card: str) -> float:
    """For each image layout in ``sets`` (name -> (train dataset, resident
    device batch, loader settings)): the resident batch's Swin features
    against the plain route, ``TASK_DRIVER_BARE_STEPS`` bare steps on it,
    then, with ``--loader-pace``, one epoch through ``train(runner,
    dataset)`` for each loader setting (:func:`timed_epoch`,
    :func:`loop_line`; ``rows`` a step). Returns the peak memory of the
    loops."""
    torch.cuda.reset_peak_memory_stats()
    for name, (dataset, resident, settings) in sets.items():
        with torch.no_grad():
            image = resident["image"]
            _check_close(f"{what} Swin-S features of a {name} batch "
                         f"{tuple(image.shape)} {image.dtype}, kernels vs "
                         "plain", runner.model.encode_image(image),
                         runner.model.encode_image(image, plain=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TASK_DRIVER_BARE_STEPS):
            bare.masks = runner.masks_for_step()
            bare(resident)
            runner.state.step += 1
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3 / TASK_DRIVER_BARE_STEPS
        mb = sum(v.numel() * v.element_size() for v in resident.values())
        print(f"{what} bare step on {card}, {name} ({rows} rows, "
              f"{mb / 1e6:.1f} MB a batch): {bare_ms:.1f} ms a step, "
              f"{rows * 1e3 / bare_ms:.1f} samples/s", flush=True)
        steps = len(dataset) // runner.train_config.batch_size
        for workers in settings if LOADER_PACE else ():
            marks = timed_epoch(runner, train, dataset, workers, steps)
            print(loop_line(what, card, f"{name}, ", workers, marks, rows,
                            bare_ms), flush=True)
    return torch.cuda.max_memory_allocated()


def _replayed_epoch(rec_k, task: str, runner_k, model_cls, train, dataset,
                    what: str, pretrained=None):
    """The kernel run's first epoch again on the plain versions from the
    same seed (and ``pretrained``), replaying its masks: the losses of
    ``TRAIN_STEPS`` steps within ``LOSS_BAR`` relative, step 1's gradients
    within the Swin-S bars, the batches bitwise the same."""
    import dataclasses
    from mvlt_tpu_torch.tasks.common import TaskRunner
    rec_p = _DriverRecorder(replay=rec_k.masks, task=task)
    plain = TaskRunner(model_cls, runner_k.config,
                       dataclasses.replace(runner_k.train_config,
                                           num_workers=0),
                       name=f"{task}-plain", device=runner_k.device,
                       plain=True)
    plain.init_state(pretrained_variables=pretrained)
    with rec_p.watching():
        train(plain, dataset)
    losses = {"kernels": rec_k.losses[:TRAIN_STEPS],
              "plain": rec_p.losses[:TRAIN_STEPS]}
    print(f"{what} losses of {TRAIN_STEPS} steps: {json.dumps(losses)}",
          flush=True)
    if not all(rec_p.same) or len(rec_p.losses) < TRAIN_STEPS:
        raise AssertionError(f"{what}: the plain epoch's batches differ")
    for i, (a, b) in enumerate(zip(losses["kernels"], losses["plain"])):
        if not (abs(a - b) <= LOSS_BAR * abs(b) and a == a):
            raise AssertionError(f"{what} step {i + 1} loss {a} vs plain {b} "
                                 f"beyond {LOSS_BAR} relative")
    compare_grad_dicts(rec_k.grads, rec_p.grads, f"{what} step 1 gradients",
                       swin_bars)
    rec_k.grads = rec_k.masks = None
    del rec_p, plain
    gc.collect()
    torch.cuda.empty_cache()


def caption_driver_phase(dev, card: str) -> dict:
    """The report generation driver, ``python -m
    mvlt_tpu_torch.run_report_generation --dataset iu_xray``, at its IU
    X-Ray settings (Swin-S @224 + BERT-base, ``for_caption(max_length=80)``:
    unilm, dropouts 0.1, DropPath 0.3, lr 1e-5, b32, beam 5; two views a
    study, S = 180) with a ``--pretrained`` export (uint8 frames normalized
    on the card) on the synthetic tree, 2 epochs of 3 steps with loader
    processes and the test after the second. Checks: the launch counts of
    one driver step and of one eval batch (the Swin counterparts twice a
    step), every device batch bitwise its host batch, the first epoch on the
    plain versions replaying the masks (3 losses, step 1's gradients), the
    Swin features, the prefill's logits and the first decode step's against
    the plain route, two evals' decoded ids bitwise equal, the driver's
    checkpoint restored into a fresh runner (state bitwise, the same ids),
    the driver with ``--do_test --quant int8w`` on that checkpoint (its
    launches, and its scores those of ``eval_caption(quant="int8w")`` on
    the trained runner). Then times the eval (reports/s) and a generate call, and one epoch of
    ``IU_XRAY_TIMED`` studies through ``train_caption`` beside the bare
    step for each image layout (uint8 with the export, f32 ImageNet crops
    without) and its loader settings, with the peak memory. Returns
    ``{"run": the launch counts of the whole run_report_generation.main
    call, "step": those of one driver step}``."""
    import shutil

    import numpy as np

    from mvlt_tpu_torch import run_report_generation as cli
    from mvlt_tpu_torch.models import generation as G
    from mvlt_tpu_torch.models.heads import CaptionModel
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS
    from mvlt_tpu_torch.tasks.caption import (decode_reports, eval_caption,
                                              train_caption)
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_caption_step
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib
    trees = iu_xray_trees()
    root = REPO / "build" / "caption_driver"
    shutil.rmtree(root, ignore_errors=True)
    B, E, K = (CAPTION_DRIVER_BATCH, CAPTION_DRIVER_EPOCHS,
               CAPTION_DRIVER_BEAMS)
    tok = WordPieceTokenizer()
    # a partial pretrain export (the Swin patch embedding, seeded) puts the
    # driver on the pretrained frames: uint8, normalized on the card
    cfg = cli.build_config(cli.parse_args([]), tok, IU_XRAY_TEXT)
    gen = torch.Generator().manual_seed(5)
    export = {k: (torch.ones(v.shape) if k.endswith("norm.weight") else
                  torch.zeros(v.shape) if k.endswith("bias") else
                  torch.randn(v.shape, generator=gen) * 0.02)
              for k, v in CaptionModel(cfg, device="meta").state_dict().items()
              if k.startswith("conv.backbone.patch_embed.")}
    ckpt_lib.save_pretrained(str(root / "export"), cfg, export)
    data_root = str(pathlib.Path(trees["data"]).parent)
    argv = ["--dataset", "iu_xray", "--data_root", data_root,
            "--pretrained", str(root / "export"), "--epochs", str(E),
            "--test_freq", str(E), "--batch_size", str(B),
            "--max_length", str(IU_XRAY_TEXT), "--num_beams", str(K),
            "--device", str(dev)]
    print(f"caption driver: run_report_generation {' '.join(argv)}",
          flush=True)

    # 1. the driver on the kernels, loader processes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec_k = _DriverRecorder(task="caption")
    reset_counts()
    t0 = time.perf_counter()
    with rec_k.watching():
        runner_k, out = cli.main(argv + [
            "--model_name", str(root / "kernels"),
            "--num_workers", str(CAPTION_DRIVER_WORKERS)])
    torch.cuda.synchronize()
    counts = launch_counts()
    run_s = time.perf_counter() - t0
    args = cli.parse_args(argv)
    size = runner_k.config.swin.img_size
    train_ds, test_ds = cli.build_datasets(args, tok, IU_XRAY_TEXT, size)
    steps = E * (len(train_ds) // B)
    print(f"caption driver run (kernels, {CAPTION_DRIVER_WORKERS} worker "
          f"processes): {run_s:.1f} s for {steps} steps, {E} checkpoints and "
          f"the test of {len(test_ds)} studies (beam {K}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; losses "
          f"{json.dumps(rec_k.losses)}; scores {json.dumps(out['evals'])}",
          flush=True)
    print(f"launches in the caption driver run: {json.dumps(counts)}",
          flush=True)
    print(f"launches in one caption driver step: "
          f"{json.dumps(rec_k.step_counts)}", flush=True)
    _expect_counts(rec_k.step_counts, EXPECTED_CAPTION_DRIVER_STEP,
                   "one caption driver step",
                   [k.__name__ for k in kernels.KERNELS] + ["gemm_splitk"])
    if len(rec_k.same) != steps or not all(rec_k.same):
        raise AssertionError(f"device batches vs host batches: {rec_k.same}")
    image = rec_k.host[0]["image"]
    if image.dtype != np.uint8 or image.shape != (B, 2, size, size, 3):
        raise AssertionError(f"caption driver batch {image.dtype} "
                             f"{image.shape}")
    if (runner_k.state.step != steps or len(out["evals"]) != 1
            or not all(np.isfinite(v) for v in out["evals"][0].values())
            or "r2gen_BLEU_4" not in out["evals"][0]):
        raise AssertionError(f"caption driver: step {runner_k.state.step}, "
                             f"evals {out['evals']}")
    print(f"caption driver: {steps} device batches (two-view uint8 "
          f"{image.shape}) bitwise equal to their host batches, in order",
          flush=True)

    # 2. one eval batch: its launches; the Swin features, the prefill's
    # logits and the first decode step's against the plain route
    model = runner_k.model
    spec = G.GenerationSpec.from_config(runner_k.config, num_beams=K)
    images = _resident(test_ds, CAPTION_EVAL_BATCH, dev)["image"]
    before = launch_counts()
    G.generate(model, images, spec)
    torch.cuda.synchronize()
    after = launch_counts()
    eval_counts = {k: after[k] - before[k] for k in after}
    print(f"launches in one caption eval batch (b{CAPTION_EVAL_BATCH}, beam "
          f"{K}): {json.dumps(eval_counts)}", flush=True)
    _expect_counts(eval_counts, EXPECTED_CAPTION_DRIVER_EVAL,
                   "one caption eval batch",
                   ("gemm", "biased_attention", "layernorm"))
    with torch.no_grad():
        feats = [model.encode_image(images, plain) for plain in (False, True)]
        _check_close(f"two-view Swin-S features (b{CAPTION_EVAL_BATCH}, "
                     f"{feats[0].shape[1]} tokens), kernels vs plain", *feats)
        pre = [G._prefill(model, f, spec, ops)
               for f, ops in zip(feats, (KERNEL_OPS, PLAIN_OPS))]
        _check_close(f"caption prefill logits (prefix {pre[0][2]}), kernels "
                     "vs plain", pre[0][0], pre[1][0])
        first = pre[1][0].argmax(-1)
        step_logits = []
        for (_, kv, P), ops in zip(pre, (KERNEL_OPS, PLAIN_OPS)):
            cache = G._make_cache(model, kv, P, images.shape[0], spec)
            step_logits.append(G._decode_logits(model, cache, first, P, spec,
                                                ops))
        _check_close("caption first decode step logits, kernels vs plain",
                     *step_logits)
    del feats, pre, cache, step_logits

    # 3. the first epoch on the plain versions, replaying the masks
    pretrained = [ckpt_lib.load_pretrained(str(root / "export"))[1]]
    _replayed_epoch(rec_k, "caption", runner_k, CaptionModel,
                    lambda r, ds: train_caption(r, ds, epochs=1), train_ds,
                    "caption driver", pretrained)

    # 4. two evals bitwise equal; the checkpoint restored into a fresh runner
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(decode_reports(runner_k, test_ds, tok, num_beams=K))
        runs[-1] += (time.perf_counter() - t0,)
    if runs[0][2] != runs[1][2]:
        raise AssertionError("two caption evals decoded other ids")
    runner_k.finish()
    fresh = TaskRunner(CaptionModel, runner_k.config, runner_k.train_config,
                       workdir=runner_k.workdir, name="caption-restore",
                       device=dev)
    fresh.init_state()
    if not fresh.maybe_restore():
        raise AssertionError("the fresh runner found no checkpoint")
    _same_state(runner_k.state, fresh.state, "restored caption state")
    if decode_reports(fresh, test_ds, tok, num_beams=K)[2] != runs[0][2]:
        raise AssertionError("the restored runner decodes other ids")
    del fresh

    # 5. the driver's int8w test on its checkpoint: weight-only int8
    # serving, against eval_caption(quant="int8w") on the trained runner
    q_scores = eval_caption(runner_k, test_ds, tok, num_beams=K,
                            quant="int8w")
    before = launch_counts()
    t0 = time.perf_counter()
    q_runner, q_out = cli.main(argv + [
        "--model_name", str(root / "kernels"), "--do_test", "--quant",
        "int8w", "--num_workers", str(CAPTION_DRIVER_WORKERS)])
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    after = launch_counts()
    q_counts = {k: after[k] - before[k] for k in after}
    batches = -(-len(test_ds) // CAPTION_EVAL_BATCH)
    _expect_counts(q_counts, {k: (batches * n, src) for k, (n, src) in
                              EXPECTED_CAPTION_DRIVER_EVAL.items()},
                   f"the driver's int8w test ({batches} eval batches)",
                   ("gemm", "biased_attention", "layernorm"))
    if q_runner.state.step != steps or q_out["test"] != q_scores:
        raise AssertionError(f"run_report_generation --do_test --quant int8w "
                             f"at step {q_runner.state.step}: "
                             f"{q_out['test']} vs eval_caption(quant='int8w') "
                             f"{q_scores}")
    print(f"caption driver --do_test --quant int8w on its step-{steps} "
          f"checkpoint: {q_s:.1f} s, {batches} eval batches as launched by "
          f"eval_caption, scores equal to eval_caption(quant='int8w') on the "
          f"trained runner: {json.dumps(q_scores)}", flush=True)
    q_runner.finish()
    del q_runner
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = eval_caption(runner_k, test_ds, tok, num_beams=K)
    eval_s = time.perf_counter() - t0
    gen_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G.generate(model, images, spec)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    n = len(test_ds)
    print(f"caption driver: two evals decode the same ids; its checkpoint at "
          f"step {steps} restored into a fresh runner (state bitwise) decodes "
          f"them too; {sum(len(r) for r in runs[0][1])} report characters; "
          f"first report {runs[0][1][0][:80]!r}", flush=True)
    print(f"caption driver eval on {card}: decode of {n} studies (beam {K}, "
          f"b{CAPTION_EVAL_BATCH}) {[round(n / r[3], 2) for r in runs]} "
          f"reports/s; eval_caption with the metrics {n / eval_s:.2f} "
          f"reports/s ({eval_s:.2f} s); a generate call (b"
          f"{CAPTION_EVAL_BATCH}, beam {K}, length {IU_XRAY_TEXT}) "
          f"{[round(t * 1e3, 1) for t in gen_s]} ms; scores "
          f"{json.dumps(scores)}", flush=True)

    # 6. times: bare steps and one epoch per image layout and loader setting
    timed = {"uint8 (export)": (argv, (-1,)),
             "f32 ImageNet crops": ([a for i, a in enumerate(argv)
                                     if a != "--pretrained"
                                     and argv[i - 1] != "--pretrained"],
                                    (-1, 0))}
    sets = {}
    for name, (a, settings) in timed.items():
        a = cli.parse_args(a)
        a.data_root = str(pathlib.Path(trees["timed"]).parent)
        ds = cli.build_datasets(a, tok, IU_XRAY_TEXT, size)[0]
        sets[name] = (ds, _resident(ds, B, dev), settings)
    bare = make_caption_step(runner_k.model, runner_k.optimizer)
    peak = task_driver_loops(runner_k, sets,
                             lambda r, ds: train_caption(r, ds, epochs=1),
                             bare, B, "caption driver", card)
    print(f"caption driver: peak memory in the timed loops "
          f"{peak / 2 ** 30:.3f} GiB on {card}", flush=True)
    return {"run": counts, "step": rec_k.step_counts}


def retrieval_driver_phase(dev, card: str) -> dict:
    """The retrieval driver, ``python -m mvlt_tpu_torch.run_retrieval
    --iu_xray_root``, at its settings (Swin-S @224 + BERT-base,
    ``for_retrieval``: attention dropout 0.1, hidden dropout 0.0, DropPath
    0.3, lr 1e-6; swap 'image'; 32 pairs = 64 rows of two views, S = 180;
    uint8 frames normalized on the card) on the synthetic tree, one epoch
    of 3 steps with loader processes, then ``eval_retrieval`` on the 32
    test studies and ``eval.json``. Checks: the launch counts of one driver
    step (the Swin counterparts twice) and of one grid, every device batch
    bitwise its host ``cat(pos, neg)``, the epoch on the plain versions
    replaying the masks (3 losses, step 1's gradients), the grid's P(match)
    against the plain route, two grids bitwise equal. Then times the grid
    (pairs/s) and, per image layout (uint8, f32 host-normalized), the bare
    step and one epoch of ``IU_XRAY_TIMED`` studies through
    ``train_retrieval`` for each of its loader settings, with the peak
    memory. Returns
    ``{"run": ..., "step": ...}`` as the caption phase does."""
    import shutil

    import numpy as np

    from mvlt_tpu_torch import run_retrieval as cli
    from mvlt_tpu_torch.data.datasets import RetrievalDataset
    from mvlt_tpu_torch.models.heads import RetrievalModel
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.metrics.retrieval import evaluate_retrieval
    from mvlt_tpu_torch.tasks.retrieval import (merge_pairs, score_grid,
                                                train_retrieval)
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_retrieval_step
    trees = iu_xray_trees()
    root = REPO / "build" / "retrieval_driver"
    shutil.rmtree(root, ignore_errors=True)
    P = RETRIEVAL_DRIVER_PAIRS
    tok = WordPieceTokenizer()
    argv = ["--iu_xray_root", trees["data"], "--epochs", "1",
            "--batch_size", str(P), "--do_train", "--do_test",
            "--device", str(dev)]
    print(f"retrieval driver: run_retrieval {' '.join(argv)}", flush=True)

    # 1. the driver on the kernels, loader processes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec_k = _DriverRecorder(task="retrieval")
    reset_counts()
    t0 = time.perf_counter()
    with rec_k.watching():
        runner_k, result = cli.main(argv + [
            "--model_name", str(root / "kernels"),
            "--num_workers", str(RETRIEVAL_DRIVER_WORKERS)])
    torch.cuda.synchronize()
    counts = launch_counts()
    run_s = time.perf_counter() - t0
    args = cli.parse_args(argv)
    size = runner_k.config.swin.img_size
    src_train, src_test = cli.build_sources(args, size)
    train_ds = RetrievalDataset(src_train, tok, args.max_length, "train",
                                swap=args.swap)
    test_ds = RetrievalDataset(src_test, tok, args.max_length, "test")
    steps = len(train_ds) // P
    print(f"retrieval driver run (kernels, {RETRIEVAL_DRIVER_WORKERS} worker "
          f"processes): {run_s:.1f} s for {steps} steps (swap "
          f"{args.swap!r}), a checkpoint and the {test_ds.img_num}^2 grid; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB; metrics {json.dumps(rec_k.metrics)}; eval "
          f"{json.dumps(result)}", flush=True)
    print(f"launches in the retrieval driver run: {json.dumps(counts)}",
          flush=True)
    print(f"launches in one retrieval driver step: "
          f"{json.dumps(rec_k.step_counts)}", flush=True)
    _expect_counts(rec_k.step_counts, EXPECTED_RETRIEVAL_DRIVER_STEP,
                   "one retrieval driver step",
                   [k.__name__ for k in kernels.KERNELS] + ["gemm_splitk"])
    if len(rec_k.same) != steps or not all(rec_k.same):
        raise AssertionError(f"device batches vs host batches: {rec_k.same}")
    image = rec_k.host[0]["image"]
    on_disk = json.loads((root / "kernels" / "eval.json").read_text())
    if (args.swap != "image" or image.dtype != np.uint8
            or image.shape != (2 * P, 2, size, size, 3) or on_disk != result
            or set(result) != {"i2t_retrieval", "t2i_retrieval"}):
        raise AssertionError(f"retrieval driver: swap {args.swap}, batch "
                             f"{image.dtype} {image.shape}, eval.json "
                             f"{on_disk}")
    print(f"retrieval driver: {steps} device batches (cat(pos, neg), "
          f"{image.shape} uint8) bitwise equal to their host batches; "
          f"eval.json written", flush=True)

    # 2. the epoch on the plain versions, replaying the masks
    _replayed_epoch(rec_k, "retrieval", runner_k, RetrievalModel,
                    lambda r, ds: train_retrieval(r, ds, epochs=1), train_ds,
                    "retrieval driver")

    # 3. the grid: its launches, two grids bitwise equal, the plain route
    n = test_ds.img_num
    reset_counts()
    times, grids = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids.append(score_grid(runner_k, test_ds, min(64, len(test_ds))))
        times.append(time.perf_counter() - t0)
        if len(grids) == 1:
            grid_counts = launch_counts()
    expected = {**two_view(EXPECTED),
                "fused_attn_ln": (12 * n, "mvlt_tpu/ops/pallas_attn.py:2156"),
                "fused_mlp_ln": (12 * n, "mvlt_tpu/ops/pallas_attn.py:2817")}
    print(f"launches in one retrieval grid ({n} x {n}, one chunk): "
          f"{json.dumps(grid_counts)}", flush=True)
    _expect_counts(grid_counts, expected, "one retrieval grid",
                   ("gemm", "biased_attention", "layernorm"))
    sims, labels = grids[0]["similarities"], grids[0]["labels"]
    if not (np.array_equal(sims, grids[1]["similarities"])
            and (labels.diagonal() == 1).all() and (sims > 0).all()
            and (sims < 1).all()):
        raise AssertionError("two retrieval grids differ, or a score or "
                             "label is wrong")
    runner_k.plain = True
    plain = score_grid(runner_k, test_ds, min(64, len(test_ds)))
    runner_k.plain = False
    _check_close(f"retrieval driver P(match) of the {n} x {n} grid, kernels "
                 "vs plain", torch.from_numpy(sims),
                 torch.from_numpy(plain["similarities"]))
    print(f"retrieval driver grid on {card}: two grids bitwise equal; "
          f"{[round(n * n / t, 1) for t in times]} pairs/s ({n} x {n}, S = "
          f"{1 + 2 * 49 + 1 + args.max_length}); plain route "
          f"{json.dumps(evaluate_retrieval(plain['similarities'], labels))}",
          flush=True)

    # 4. times: bare steps and one epoch per image layout and loader setting
    sets = {}
    for name, extra, settings in (("uint8", [], (-1, 0)),
                                  ("f32 host-normalized",
                                   ["--host_normalize"], ())):
        a = cli.parse_args(["--iu_xray_root", trees["timed"]] + extra)
        ds = RetrievalDataset(cli.build_sources(a, size)[0], tok, a.max_length,
                              "train", swap=a.swap)
        sets[name] = (ds, _resident(ds, P, dev, merge_pairs), settings)
    bare = make_retrieval_step(runner_k.model, runner_k.optimizer)
    peak = task_driver_loops(runner_k, sets,
                             lambda r, ds: train_retrieval(r, ds, epochs=1),
                             bare, 2 * P, "retrieval driver", card)
    print(f"retrieval driver: peak memory in the timed loops "
          f"{peak / 2 ** 30:.3f} GiB on {card}", flush=True)
    return {"run": counts, "step": rec_k.step_counts}


def caption_driver_main() -> int:
    """``python3 chip_smoke.py --caption-driver``: phases 1-2 and the
    caption driver phase only; its last line is the launch counts of the
    driver run and of one driver step."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    with switches(False):
        counts = caption_driver_phase(dev, card)
    print(CAPTION_DRIVER_TAG + json.dumps(counts), flush=True)
    return 0


def retrieval_driver_main() -> int:
    """``python3 chip_smoke.py --retrieval-driver``: phases 1-2 and the
    retrieval driver phase only, as ``--caption-driver``."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    with switches(False):
        counts = retrieval_driver_phase(dev, card)
    print(RETRIEVAL_DRIVER_TAG + json.dumps(counts), flush=True)
    return 0


def vqa_driver_main() -> int:
    """``python3 chip_smoke.py --vqa-driver``: phases 1-2 and the VQA
    driver phase only; its last line is the driver run's launch counts."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    with switches(False):
        counts = vqa_driver_phase(dev, card)
    print(VQA_DRIVER_TAG + json.dumps(counts), flush=True)
    return 0


def pretrain_driver_main() -> int:
    """``python3 chip_smoke.py --pretrain-driver``: phases 1-2 and the
    pretrain driver phase only; its last line is the driver run's launch
    counts and those of one driver step in each mode."""
    started = start()
    if started is None:
        return 1
    dev, card = started
    with switches(False):
        counts = pretrain_driver_phase(dev, card)
    print(PRETRAIN_DRIVER_TAG + json.dumps(counts), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 21: multi-device (parallel/, the mesh steps)
# ---------------------------------------------------------------------------

def _kernel_counts_equal(got: dict, want: dict, what: str) -> None:
    """K1-K5's launch counts in ``got`` equal ``want``'s."""
    from mvlt_tpu_torch.ops import kernels
    diff = {k.__name__: (got[k.__name__], want[k.__name__])
            for k in kernels.KERNELS if got[k.__name__] != want[k.__name__]}
    if diff:
        raise AssertionError(f"{what}: kernel launches (got, want) {diff}")


def _md_time(step, batch, mode, dev, n: int = MULTI_DEVICE_TIMED) -> float:
    """ms/step over ``n`` pretrain steps on fresh masks (the step has run
    before: no warm-up)."""
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    step.masks = DropoutMasks(torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch, mode)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _md_rows(masks, rank: int, rows: int, dp: int):
    """A data rank's rows of one step's recorded masks (every mask of the
    step leads with the batch)."""
    per = rows // dp
    return [m[rank * per:(rank + 1) * per] if m.shape[0] == rows else m
            for m in masks]


def _md_same_across(tensors, group, what: str) -> None:
    """The tensors, flattened, bitwise equal on every rank of ``group``."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    if not all(torch.equal(parts[0], p) for p in parts[1:]):
        raise AssertionError(f"{what}: the ranks' tensors differ")


def _md_model(cls, cfg, dev, init):
    """A model on ``dev`` holding ``init`` on world rank 0 (the others get
    rank 0's tensors when the mesh broadcasts them)."""
    model = cls(cfg, dtype=torch.float32, device=dev,
                compute_dtype=torch.bfloat16)
    if init is not None:
        model.load_state_dict(init)
    return model


def _backbone_params(model) -> int:
    """Elements of the backbone's parameters this rank holds."""
    return sum(p.numel() for n, p in model.named_parameters()
               if n.startswith("conv."))


def _md_pretrain(rank: int, dev, ref: dict, init, mp: int,
                 vit: bool = False) -> dict:
    """Check (b) (mp = 1: DP 2, each rank its 16 rows), (c) (mp = 2: TP 2
    on the whole batch) or, with ``vit``, (e) (the ViT-B/16 step at TP 2)
    on a world of two gloo ranks: the launches of one step, step 1's
    gradients and 3 losses against the one-process b32 step on its masks,
    the replicas after 3 steps, ms/step; the backbone's parameters a rank
    holds and the step's peak memory."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.config import MeshConfig
    from mvlt_tpu_torch.models.heads import PretrainModel
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.parallel import build_mesh, partition, shard
    from mvlt_tpu_torch.train.state import TrainState, make_optimizer
    from mvlt_tpu_torch.train.steps import make_pretrain_step, \
        shard_train_state
    what = "DP 2" if mp == 1 else ("ViT-B/16 TP 2" if vit else "TP 2")
    cfg = (flagship.flagship_vit_pretrain_config() if vit
           else flagship.flagship_swin_pretrain_config())
    mesh = build_mesh(MeshConfig(model_parallel=mp), device=dev)
    model = _md_model(PretrainModel, cfg, dev, init)
    whole = _backbone_params(model)
    opt = make_optimizer(model, cfg)
    shard_train_state(TrainState(model, opt), mesh)
    held = _backbone_params(model)
    step = make_pretrain_step(model, opt, mesh=mesh)
    B = ref["batch"]["image"].shape[0]
    a, b = partition.batch_rows(mesh, B)
    batch = {k: v[a:b].to(dev) for k, v in ref["batch"].items()}
    losses, counts, peak = [], None, 0
    for i, mode in enumerate(PRETRAIN_MODES):
        step.masks = DropoutMasks.replay(
            _md_rows(ref["masks"][i], mesh.data_rank, B, mesh.dp))
        if i == 0:
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = step(batch, mode)
        torch.cuda.synchronize()
        if i == 0:
            peak = torch.cuda.max_memory_allocated()
            counts = launch_counts()
            if mp == 1:
                want = ref["counts16"]
                _expect_counts(counts, {k: (want[k], None)
                                        for k in EXPECTED_SWIN_PRETRAIN},
                               f"{what} rank {rank}", [])
            elif vit:
                want = dict(ref["counts32"])
                want["gemm"] += VIT_TP_K1_EXTRA * cfg.vit.num_layers
                _expect_counts(counts, EXPECTED_VIT_TP_STEP,
                               f"{what} rank {rank}", [])
            else:
                want = ref["counts32"]
                _expect_counts(counts, EXPECTED_TP_STEP,
                               f"{what} rank {rank}", [])
            _kernel_counts_equal(counts, want, f"{what} rank {rank}")
            grads = {n: (partition.full_tensor(
                p.grad, shard.split_shardings(model)[n], mesh.model_group)
                if n in shard.split_shardings(model) else p.grad)
                for n, p in model.named_parameters()}
            if rank == 0:
                compare_grad_dicts(
                    {n: g.float() for n, g in grads.items()}, ref["grads"],
                    f"{what} step 1 gradients (vs one process, b32)",
                    vit_bars if vit else swin_bars)
            del grads
        losses.append(out["loss"].item())
    for i, (x, y) in enumerate(zip(losses, ref["losses"])):
        if not (abs(x - y) <= LOSS_BAR * abs(y) and x == x):
            raise AssertionError(f"{what} step {i + 1} loss {x} vs one "
                                 f"process {y} beyond {LOSS_BAR} relative")
    group = mesh.data_group if mp == 1 else mesh.model_group
    split = shard.split_shardings(model)
    _md_same_across([p for n, p in model.named_parameters()
                     if n not in split], group,
                    f"{what}: the replicated parameters after 3 steps")
    ms = _md_time(step, batch, False, dev, n=1)
    print(f"{what} rank {rank}: launches of one step as expected "
          f"(gemm_splitk {counts.get('gemm_splitk')}); losses {losses} vs "
          f"one process {ref['losses']}; replicas bitwise equal; "
          f"{ms:.1f} ms/step", flush=True)
    print(f"{what} rank {rank}: backbone parameters held {held} of {whole} "
          f"({whole - held} fewer than held whole); step 1 peak memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated)", flush=True)
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": ms, "losses": losses, "mesh": mesh,
            "backbone_params": held, "backbone_params_whole": whole,
            "peak_bytes": peak}


def _md_linear_vqa(rank: int, dev, ref: dict, init, mesh) -> dict:
    """Check (d): the linear-patch VQA step at DP 2 (global b32, S = 221):
    the BatchNorm running buffers after step 1 within ``BN_BUFFER_BAR`` of
    the one-process step's and equal on both ranks."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.parallel import partition
    from mvlt_tpu_torch.train.state import TrainState, make_optimizer
    from mvlt_tpu_torch.train.steps import make_vqa_step, shard_train_state
    cfg = flagship.flagship_linear_vqa_train_config()
    model = _md_model(VQAModel, cfg, dev, init)
    opt = make_optimizer(model, cfg)
    shard_train_state(TrainState(model, opt), mesh)
    step = make_vqa_step(model, opt, mesh=mesh)
    a, b = partition.batch_rows(mesh, ref["vbatch"]["image"].shape[0])
    batch = {k: v[a:b].to(dev) for k, v in ref["vbatch"].items()}
    reset_counts()
    with attention_lengths() as seen:
        out = step(batch)
        torch.cuda.synchronize()
    counts = launch_counts()
    long_n_counts(counts, seen, VIT_VQA_N,
                  f"DP 2 linear-patch VQA rank {rank}")
    bufs = {n: t for n, t in model.named_buffers() if "running" in n}
    worst = 0.0
    for n, t in bufs.items():
        err = (t.float().cpu() - ref["vbuffers"][n]).abs().max().item()
        worst = max(worst, err)
        if not err <= BN_BUFFER_BAR:
            raise AssertionError(f"DP 2 linear-patch VQA: {n} off the one-"
                                 f"process step's by {err}")
    _md_same_across(list(bufs.values()), mesh.data_group,
                    "DP 2 linear-patch VQA: the BatchNorm buffers")
    print(f"DP 2 linear-patch VQA rank {rank}: loss {out['loss'].item():.6f} "
          f"(one process {ref['vloss']:.6f}); {len(bufs)} BatchNorm buffers "
          f"within {worst:.2e} of one process (bar {BN_BUFFER_BAR}), equal "
          "on both ranks", flush=True)
    return {"counts": counts}


def tp_adrop_checks(dev) -> None:
    """In-kernel dropout on a TP rank's heads: K2 and K4 launched on heads
    6-11 of the step of record's fusion shapes (b32, S = 131, 12 heads)
    with ``adrop=(seed, rate, 6)`` draw the mask that one device draws for
    those heads (bitwise), and their ctx / dqkv equal the 12-head launch's
    columns of those heads (bitwise) and the plain version's within
    ``KERNEL_BAR``."""
    from mvlt_tpu_torch.ops import kernels as K
    inp = Inputs(dev, seed=24)
    B, S, nH, C, rate = TRAIN_BATCH, 1 + 49 + 1 + PRETRAIN_TEXT, 12, 768, 0.1
    sc = (C // nH) ** -0.5
    seed = torch.tensor([9, 31337], dtype=torch.int32, device=dev)
    qkv, dctx = inp.rnd(B * S, 3 * C, std=0.5), inp.rnd(B * S, C)
    kb = inp.key_bias([S - 3 * i for i in range(B)], S)
    half = C // 2
    cols = torch.cat([torch.arange(j * C + half, (j + 1) * C) for j in
                      range(3)]).to(dev)
    q6, d6 = qkv[:, cols].contiguous(), dctx[:, half:].contiguous()
    full, mask = K.biased_attention(qkv, nH, S, sc, key_bias=kb,
                                    adrop=(seed, rate), save_mask=True)
    part, mask6 = K.biased_attention(q6, nH // 2, S, sc, key_bias=kb,
                                     adrop=(seed, rate, nH // 2),
                                     save_mask=True)
    plain = K.biased_attention_plain(q6, nH // 2, S, sc, key_bias=kb,
                                     adrop=(seed, rate, nH // 2))
    dfull, _ = K.biased_attention_bwd(qkv, dctx, nH, S, sc, key_bias=kb,
                                      adrop=(seed, rate))
    dpart, _ = K.biased_attention_bwd(q6, d6, nH // 2, S, sc, key_bias=kb,
                                      adrop=(seed, rate, nH // 2))
    dplain, _ = K.biased_attention_bwd_plain(q6, d6, nH // 2, S, sc,
                                             key_bias=kb,
                                             adrop=(seed, rate, nH // 2))
    torch.cuda.synchronize()
    if not torch.equal(mask6, mask[:, nH // 2:]):
        raise AssertionError("K2's mask on heads 6-11 (head0 = 6) differs "
                             "from the 12-head draw's")
    if not torch.equal(mask6, K.adrop_mask_plain(seed, B, nH // 2, S, rate,
                                                 head0=nH // 2)):
        raise AssertionError("K2's mask on heads 6-11 differs from "
                             "adrop_mask_plain(head0=6)")
    errs = []
    for what, got, want, ref in (("K2", part, full[:, half:], plain),
                                 ("K4", dpart, dfull[:, cols], dplain)):
        err, top = _max_err(got, ref)
        top = max(top, 1e-6)
        errs.append(err / top)
        if not err <= KERNEL_BAR * top:
            raise AssertionError(f"{what} on heads 6-11 with head0: max abs "
                                 f"err {err} > {KERNEL_BAR} x {top}")
        if not torch.equal(got, want):
            raise AssertionError(f"{what} on heads 6-11 differs from the "
                                 "12-head launch's columns")
    print(f"in-kernel dropout on a TP rank's heads (6-11 of 12, b{B}, S = "
          f"{S}): K2's mask bitwise the 12-head draw's and adrop_mask_plain"
          f"(head0=6)'s, ctx and dqkv bitwise the 12-head launch's columns, "
          f"vs plain {errs[0]:.2e} / {errs[1]:.2e} x max|plain|", flush=True)


def _md_wait(path: str) -> None:
    """Wait for the coordinator's file ``path`` (its references)."""
    deadline = time.monotonic() + MULTI_DEVICE_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError("phase 21's references never came")
        time.sleep(0.1)


def _md_rank(rank: int, tmp: str) -> None:
    """One of the two gloo ranks of phase 21, both on ``cuda:0``."""
    import torch.distributed as dist
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.parallel import initialize_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # started beside the coordinator's references: reach the card and load
    # the kernels (phases 1-2 filled the build directory), then wait for
    # the references
    torch.zeros((), device=MULTI_DEVICE_RANK_DEVICE)
    kernels.build()
    _md_wait(os.path.join(tmp, "ready"))
    dev = initialize_distributed(f"file://{tmp}/store", 2, rank,
                                 device=MULTI_DEVICE_RANK_DEVICE,
                                 backend="gloo",
                                 timeout_s=MULTI_DEVICE_TIMEOUT)
    try:
        ref = torch.load(os.path.join(tmp, "ref.pt"), weights_only=False)
        init = (torch.load(os.path.join(tmp, "init.pt"), weights_only=True)
                if rank == 0 else None)
        # step 1's gradients of the one-process step, compared on rank 0
        ref["grads"] = (torch.load(os.path.join(tmp, "grads.pt"),
                                   map_location=dev, weights_only=True)
                        if rank == 0 else None)
        dp = _md_pretrain(rank, dev, ref, init, 1)
        tp = _md_pretrain(rank, dev, ref, init, 2)
        vinit = (torch.load(os.path.join(tmp, "vinit.pt"), weights_only=True)
                 if rank == 0 else None)
        lin = _md_linear_vqa(rank, dev, ref, vinit, dp.pop("mesh"))
        tp.pop("mesh")
        del ref["grads"]
        gc.collect()
        # (e): the ViT-B/16 step at TP 2 on its own references
        _md_wait(os.path.join(tmp, "vit_ready"))
        vref = torch.load(os.path.join(tmp, "vit_ref.pt"), weights_only=False)
        vref["grads"] = (torch.load(os.path.join(tmp, "vit_grads.pt"),
                                    map_location=dev, weights_only=True)
                         if rank == 0 else None)
        vit_init = (torch.load(os.path.join(tmp, "vit_init.pt"),
                               weights_only=True) if rank == 0 else None)
        vit = _md_pretrain(rank, dev, vref, vit_init, 2, vit=True)
        vit.pop("mesh")
        out = {"dp2": dp, "tp2": tp, "dp2_linear_vqa": lin, "vit_tp2": vit}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _md_vit_reference(dev, tmp: str, B: int) -> None:
    """(e)'s reference: the ViT-B/16 pretrain step at b``B`` on recorded
    masks, 3 steps (losses), step 1's gradients and launch counts; written
    to ``vit_ref.pt``, ``vit_grads.pt`` and ``vit_init.pt`` under ``tmp``."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    step, batch = flagship.build_pretrain_train_step(
        batch=B, text_len=PRETRAIN_TEXT, device=dev,
        config=flagship.flagship_vit_pretrain_config())
    torch.save({k: v.detach().to("cpu", copy=True)
                for k, v in step.model.state_dict().items()},
               os.path.join(tmp, "vit_init.pt"))
    gen = torch.Generator(device=dev).manual_seed(3)
    masks, losses = [], []
    for i, mode in enumerate(PRETRAIN_MODES):
        step.masks = DropoutMasks(gen, record=True)
        if i == 0:
            reset_counts()
        out = step(batch, mode)
        torch.cuda.synchronize()
        if i == 0:
            counts = launch_counts()
            torch.save({n: p.grad.detach().float().cpu()
                        for n, p in step.model.named_parameters()},
                       os.path.join(tmp, "vit_grads.pt"))
        masks.append([m.cpu() for m in step.masks.recorded])
        losses.append(out["loss"].item())
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "masks": masks, "losses": losses, "counts32": counts},
               os.path.join(tmp, "vit_ref.pt"))
    del step, batch
    gc.collect()
    torch.cuda.empty_cache()


def multi_device_run_main() -> int:
    """Phase 21's coordinator (``--multi-device-run``, in a process of its
    own): the one-process references (the step of record at b32 on recorded
    masks: losses, step 1's gradients, launch counts; one b16 step's
    counts; the linear-patch VQA step at b32), check (a) (NCCL at world
    size 1, mesh (1, 1), bitwise), then checks (b)-(d) on two spawned gloo
    ranks sharing the card. Prints the launch counts of each path after
    ``MULTI_DEVICE_TAG``. The ranks start first, so that reaching the card
    overlaps the references, and wait for them (a ``ready`` file)."""
    import tempfile
    import torch.multiprocessing as tmp_mp
    started = start()
    if started is None:
        return 1
    dev, card = started
    t_phase = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="multi_device_", dir=REPO / "build")
    # the ranks start now and wait for the references (``ready``)
    ranks_ctx = tmp_mp.spawn(_md_rank, args=(tmp,), nprocs=2, join=False)
    try:
        return _md_coordinate(dev, card, tmp, ranks_ctx, t_phase)
    finally:
        for proc in ranks_ctx.processes:
            if proc.is_alive():
                proc.terminate()


def _md_coordinate(dev, card: str, tmp: str, ranks_ctx, t_phase) -> int:
    """:func:`multi_device_run_main` once the ranks are starting."""
    import torch.distributed as dist
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.config import MeshConfig
    from mvlt_tpu_torch.models.heads import PretrainModel
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.parallel import build_mesh, initialize_distributed
    from mvlt_tpu_torch.train.state import TrainState, make_optimizer
    from mvlt_tpu_torch.train.steps import make_pretrain_step, \
        shard_train_state
    tp_adrop_checks(dev)
    B = TRAIN_BATCH
    cfg = flagship.flagship_swin_pretrain_config()
    step, batch = flagship.build_swin_pretrain_train_step(batch=B, device=dev)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in step.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    masks, losses = [], []
    for i, mode in enumerate(PRETRAIN_MODES):
        step.masks = DropoutMasks(gen, record=True)
        if i == 0:
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = step(batch, mode)
        torch.cuda.synchronize()
        if i == 0:
            one_peak = torch.cuda.max_memory_allocated()
            counts32 = launch_counts()
            torch.save({n: p.grad.detach().float().cpu()
                        for n, p in step.model.named_parameters()},
                       os.path.join(tmp, "grads.pt"))
        masks.append([m.cpu() for m in step.masks.recorded])
        losses.append(out["loss"].item())
    # (a) NCCL at world size 1: the mesh step bitwise the one-device step
    initialize_distributed(f"file://{tmp}/nccl_store", 1, 0, device=dev)
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want_backend:
        raise AssertionError(f"the one-rank group on {dev} is "
                             f"{dist.get_backend()}, not {want_backend}")
    mesh = build_mesh(MeshConfig(), device=dev)
    model_a = _md_model(PretrainModel, cfg, dev, init)
    opt_a = make_optimizer(model_a, cfg)
    shard_train_state(TrainState(model_a, opt_a), mesh)
    step_a = make_pretrain_step(model_a, opt_a, mesh=mesh)
    losses_a = []
    for i, mode in enumerate(PRETRAIN_MODES):
        step_a.masks = DropoutMasks.replay(masks[i])
        if i == 0:
            reset_counts()
        losses_a.append(step_a(batch, mode)["loss"].item())
        torch.cuda.synchronize()
        if i == 0:
            counts_a = launch_counts()
    _expect_counts(counts_a, EXPECTED_SWIN_PRETRAIN, "the (1, 1) NCCL step",
                   [])
    _kernel_counts_equal(counts_a, counts32, "the (1, 1) NCCL step")
    if losses_a != losses:
        raise AssertionError(f"(1, 1) NCCL losses {losses_a} vs one device "
                             f"{losses}: not bitwise")
    for (n, p), q in zip(model_a.named_parameters(),
                         step.model.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"(1, 1) NCCL step: {n} differs from one "
                                 "device's after 3 steps")
    times = {"one device": [], "(1, 1) NCCL": []}
    for which in ("one device", "(1, 1) NCCL", "(1, 1) NCCL", "one device"):
        times[which].append(_md_time(step if which == "one device"
                                     else step_a, batch, False, dev))
    dist.destroy_process_group()
    print(f"(a) NCCL at world size 1, mesh (1, 1): 3 losses and every "
          f"parameter bitwise the one-device step's, launch counts as "
          f"EXPECTED_SWIN_PRETRAIN; ms/step in turns {json.dumps(times)} "
          f"on {card}", flush=True)
    del step_a, model_a, opt_a
    # one b16 step's counts (what a DP 2 rank's step launches)
    step.masks = DropoutMasks(gen)
    reset_counts()
    step({k: v[:B // 2] for k, v in batch.items()}, False)
    torch.cuda.synchronize()
    counts16 = launch_counts()
    one_ms = sum(times["one device"]) / 2
    del step
    gc.collect()
    torch.cuda.empty_cache()
    # (d)'s reference: the linear-patch VQA step at b32
    vstep, vbatch = flagship.build_vqa_train_step(
        batch=B, device=dev,
        config=flagship.flagship_linear_vqa_train_config())
    torch.save({k: v.detach().to("cpu", copy=True)
                for k, v in vstep.model.state_dict().items()},
               os.path.join(tmp, "vinit.pt"))
    vout = vstep(vbatch)
    vbuffers = {n: t.detach().float().cpu()
                for n, t in vstep.model.named_buffers() if "running" in n}
    torch.save(init, os.path.join(tmp, "init.pt"))
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "masks": masks, "losses": losses, "counts32": counts32,
                "counts16": counts16,
                "vbatch": {k: v.cpu() for k, v in vbatch.items()},
                "vbuffers": vbuffers, "vloss": vout["loss"].item()},
               os.path.join(tmp, "ref.pt"))
    del vstep, vbatch, batch, init, masks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "ready"), "w"):
        pass
    # (e)'s reference while the ranks run (b)-(d)
    _md_vit_reference(dev, tmp, B)
    with open(os.path.join(tmp, "vit_ready"), "w"):
        pass
    while not ranks_ctx.join():
        pass
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    print(f"(b) DP 2 and (c) TP 2 (gloo, both ranks on cuda:0), (d) the "
          f"linear-patch VQA step at DP 2 and (e) the ViT-B/16 step at TP 2: "
          f"every check held in {time.perf_counter() - t0:.1f} s; ms/step "
          f"(rank 0, 1): DP 2 {[r['dp2']['ms'] for r in ranks]}, TP 2 "
          f"{[r['tp2']['ms'] for r in ranks]}, ViT-B/16 TP 2 "
          f"{[r['vit_tp2']['ms'] for r in ranks]}, one device (b32) "
          f"{one_ms:.1f} on {card} (gloo on one card measures nothing a user "
          "runs)", flush=True)
    tp = [r["tp2"] for r in ranks]
    print(f"(c) TP 2 backbone parameters a rank holds: "
          f"{[t['backbone_params'] for t in tp]} of "
          f"{tp[0]['backbone_params_whole']} ("
          f"{tp[0]['backbone_params_whole'] - tp[0]['backbone_params']} "
          f"fewer); step 1 peak memory a rank (GiB): "
          f"{[round(t['peak_bytes'] / 2 ** 30, 3) for t in tp]}, DP 2 "
          f"{[round(r['dp2']['peak_bytes'] / 2 ** 30, 3) for r in ranks]}, "
          f"one device (b32) {one_peak / 2 ** 30:.3f}; ViT-B/16 TP 2 "
          f"backbone parameters "
          f"{[r['vit_tp2']['backbone_params'] for r in ranks]} of "
          f"{ranks[0]['vit_tp2']['backbone_params_whole']} on {card}",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s after "
          "its build", flush=True)
    print(MULTI_DEVICE_TAG + json.dumps({
        "multi_device_nccl_1x1": counts_a,
        "multi_device_dp2": ranks[0]["dp2"]["counts"],
        "multi_device_tp2": ranks[0]["tp2"]["counts"],
        "multi_device_dp2_linear_vqa": ranks[0]["dp2_linear_vqa"]["counts"],
        "multi_device_vit_tp2": ranks[0]["vit_tp2"]["counts"]}),
        flush=True)
    return 0


def multi_device_subprocess() -> dict:
    """Phase 21 in its own process (``--multi-device-run``, which spawns the
    ranks) under ``MULTI_DEVICE_TIMEOUT``; the process group is killed at
    the limit. Returns the launch counts of its paths."""
    return driver_subprocess("--multi-device-run", "multi-device",
                             MULTI_DEVICE_TIMEOUT, MULTI_DEVICE_TAG)


def multi_device_main() -> int:
    """``python3 chip_smoke.py --multi-device``: phases 1-2, the native
    tokenizers' check and phase 21 only, without the kernels line."""
    if start() is None:
        return 1
    native_tokenizer_checks()
    multi_device_subprocess()
    return 0


def driver_subprocess(flag: str, what: str, limit: float, tag: str):
    """A driver phase in a process of its own (``flag``) under ``limit``
    seconds: its loader forks worker processes, and a fork that hangs fails
    the run instead of stopping it. The process group is killed at the
    limit. Returns the JSON after ``tag`` on the phase's last such line."""
    import signal
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"),
                             flag] + ["--loader-pace"] * LOADER_PACE,
                            cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out, flush=True)
        raise AssertionError(f"the {what} phase passed its limit of "
                             f"{limit} s")
    print(out, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the {what} phase failed "
                             f"(exit {proc.returncode})")
    print(f"{what} phase: {time.perf_counter() - t0:.1f} s in its own "
          "process", flush=True)
    line = [l for l in out.splitlines() if l.startswith(tag)][-1]
    return json.loads(line[len(tag):])


def vqa_driver_subprocess() -> dict:
    """The VQA driver phase in its own process (``--vqa-driver``) under
    ``VQA_DRIVER_TIMEOUT``. Returns the driver run's launch counts."""
    return driver_subprocess("--vqa-driver", "vqa driver",
                             VQA_DRIVER_TIMEOUT, VQA_DRIVER_TAG)


def pretrain_driver_subprocess(swin_step: dict) -> dict:
    """The pretrain driver phase in its own process (``--pretrain-driver``)
    under ``PRETRAIN_DRIVER_TIMEOUT``; one driver step in each mode against
    ``swin_step``, the launch counts of one step of the Swin-S pretrain
    step of record (bidirectional): equal for every kernel and counterpart
    in the bidirectional mode, for every counterpart in seq2seq (the
    subprocess held both to ``EXPECTED_SWIN_PRETRAIN``). Returns the driver
    run's launch counts."""
    out = driver_subprocess("--pretrain-driver", "pretrain driver",
                            PRETRAIN_DRIVER_TIMEOUT, PRETRAIN_DRIVER_TAG)
    for mode, counts in out["step"].items():
        diff = {k: (counts.get(k), v) for k, v in swin_step.items()
                if counts.get(k) != v}
        print(f"pretrain driver step ({mode}) vs the Swin-S pretrain step: "
              f"{'the same launch counts' if not diff else diff}",
              flush=True)
        if mode == "bidirectional" and diff:
            raise AssertionError(f"a bidirectional driver step launches "
                                 f"other counts than the Swin-S step: {diff}")
    return out["run"]


def two_view_subprocess(flag: str, what: str, limit: float, tag: str,
                        single_step: dict, expected: dict) -> dict:
    """A two-view driver phase in its own process; one of its steps against
    ``single_step``, the launch counts of the single-view step of its task
    (the keys of ``expected``): the Swin counterparts twice as often, the
    fusion counterparts as often. Returns the driver run's launch counts."""
    out = driver_subprocess(flag, what, limit, tag)
    diff = {k: (out["step"][k], single_step[k]) for k in expected
            if out["step"][k] != (2 if k in SWIN_COUNTERPARTS else 1)
            * single_step[k]}
    print(f"{what} step vs the single-view step: "
          f"{'the Swin counterparts twice, the others as often' if not diff else diff}",
          flush=True)
    if diff:
        raise AssertionError(f"a two-view {what} step launches {diff} "
                             "(two-view, single-view)")
    return out["run"]


if __name__ == "__main__":
    modes = {"--norm": norm_main, "--caption": caption_main,
             "--retrieval": retrieval_main, "--vqa-driver": vqa_driver_main,
             "--pretrain-driver": pretrain_driver_main,
             "--caption-driver": caption_driver_main,
             "--retrieval-driver": retrieval_driver_main,
             "--backbones": backbones_main,
             "--swin-routes": swin_routes_main, "--long-n": long_form_main,
             "--single-card": single_card_main,
             "--multi-device": multi_device_main,
             "--multi-device-run": multi_device_run_main}
    flags = sys.argv[1:]
    LOADER_PACE = "--loader-pace" in flags
    flags = [f for f in flags if f != "--loader-pace"]
    sys.exit(modes.get(" ".join(flags),
                       loader_pace_main if LOADER_PACE else main)())
