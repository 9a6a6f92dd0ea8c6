#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX and nothing of the JAX package. Phases, each of which raises
on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``mvlt_tpu_torch/csrc`` with
   nvcc (sm_90a, one process per source, all at once) into
   ``build/torch_kernels/``;
3. kernel checks: hold K1 ``gemm``, K2 ``biased_attention``, K3
   ``layernorm`` and the six forward counterparts of
   ``mvlt_tpu_torch.ops.blocks`` against their plain PyTorch versions on the
   card, in bf16 at the flagship batch-8 shapes; then K1's backward modes,
   K4 ``biased_attention_bwd``, K5 ``layernorm_bwd`` / ``column_sum`` and
   the two backward counterparts at the train step's shapes; then the mask
   options at the pretrain step's shapes (B*S = 32*131 rows, 12 heads): K2
   and K4 with qbias and amask, K4 at N = 128, K1's epilogue multiplier, K5
   with hmask, the two masked forward counterparts and the two backward
   ones with their masks, and the shared-memory reckoning of K2 / K4
   against the compiled one. Each is timed beside its plain version, the
   library call that computes the same function (never called by the port)
   and its bound on an H100 SXM (the larger of FLOPs / 989 TFLOP/s and
   bytes / 3.35 TB/s);
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
   each block forward + backward); then the pretrain step of record
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
9. print ``{"kernels": [...]}``, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent

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

# calls per flagship forward of each TPU kernel on the JAX path, traced with
# the TPU kernel gates forced on: port function -> (count, TPU kernel)
EXPECTED = {
    "swin_full_block": (11, "mvlt_tpu/ops/pallas_attn.py:652"),
    "swin_full_block_shift": (11, "mvlt_tpu/ops/pallas_attn.py:702"),
    "window_block_attention": (2, "mvlt_tpu/ops/pallas_attn.py:166"),
    "fused_mlp_preln": (2, "mvlt_tpu/ops/pallas_attn.py:3359"),
    "fused_attn_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2156"),
    "fused_mlp_ln": (12, "mvlt_tpu/ops/pallas_attn.py:2817"),
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
}
# the modes' counts on the kernel wrappers (``kernels.MODE_COUNTS``)
MODE_ROWS = {"adrop_launches": "adrop", "save_p_launches": "save_p",
             "stored_p_launches": "stored_p"}
# the modes' counts on the counterparts (``blocks.COUNTS``)
COUNTERPART_MODES = {
    "swin_full_block": {"shift_launches": "shift",
                        "train_launches": "train",
                        "train_shift_launches": "train_shift",
                        "train_store_p_launches": "train_store_p",
                        "train_shift_store_p_launches": "train_shift_store_p"},
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
             floor: float = 1.0) -> None:
        """``bar`` is a multiple of the largest |value| of each plain output
        (at least ``floor``); ``flops`` / ``nbytes`` are what the function
        must do and move (each input read once, each output written once)."""
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
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        lib_ms = cuda_ms(library_fn) if library_fn is not None else None
        b_ms, b_by = bound(flops, nbytes)
        row = self.rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "_ops": 0.0, "_bytes": 0.0, "_nolib": False})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms                # summed over the cases of one kernel
        row["plain_ms"] += plain_ms
        row["bound_ms"] += b_ms
        row["_ops" if b_by == "operations" else "_bytes"] += b_ms
        if lib_ms is None:
            row["_nolib"] = True
        else:
            row["library_ms"] += lib_ms
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"check {name}: max_abs_err {err:.3g} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms library {lib} bound {b_ms:.4f} ms ({b_by}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)", flush=True)

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
    the graph is built once and ``torch.autograd.grad`` replays it."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = forward(*leaves)
    return lambda: torch.autograd.grad(out, leaves, cotangent,
                                       retain_graph=True)


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
                 nbytes=nbytes(qkv, pat, kb, ctx))

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
                 flops=8.0 * M * C, nbytes=nbytes(x, g, b, ri, x))

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
             KERNEL_BAR, library_fn=lib_k4, floor=1e-6, **k4_cost)
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

    chk.case("layernorm_bwd", lambda: K.layernorm_bwd(res, lns, g, 1e-12),
             lambda: K.layernorm_bwd_plain(res, lns, g, 1e-12), KERNEL_BAR,
             library_fn=lib_k5, floor=1e-6, flops=12.0 * M * C,
             nbytes=nbytes(res, lns, g, res, g) + 12 * C)
    chk.case("column_sum", lambda: K.column_sum(dI),
             lambda: K.column_sum_plain(dI), KERNEL_BAR, floor=1e-6,
             library_fn=lambda: torch.sum(dI, 0, dtype=f32),
             flops=1.0 * M * I, nbytes=nbytes(dI) + 4 * I)

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

    # the wrappers' shared-memory reckoning is the compiled one
    libs = K.build()
    for n in range(1, 161):
        assert K.attention_smem_bytes(n, 64) == \
            libs["attention"].mvlt_attention_smem(n, 64), n
        assert K.attention_bwd_smem_bytes(n, 64) == \
            libs["attention_bwd"].mvlt_attention_bwd_smem(n, 64, 0), n
    optin = K.smem_optin(dev)
    print(f"shared memory per block (opt-in): {optin} bytes; K2 admits N <= "
          f"{K.max_attention_n(64, optin)}, K4 N <= "
          f"{K.max_attention_n(64, optin, backward=True)} at head dim 64",
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
                 nbytes=nbytes(qkv, kbias, qbias, amask, dctx))

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
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
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
             nbytes=nbytes(q8, c8, kb8, q8, kb8))
    try:
        K.biased_attention_bwd(rnd(B * 141, 3 * C), rnd(B * 141, C), nH, 141,
                               sc)
    except ValueError as e:
        print(f"K4 refuses N = 141 before launching: {e}", flush=True)
    else:
        raise AssertionError("K4 took N = 141, beyond its shared memory")

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

    chk.case("layernorm_bwd",
             lambda: K.layernorm_bwd(res, lns, g, 1e-12, hmask=hmask),
             lambda: K.layernorm_bwd_plain(res, lns, g, 1e-12, hmask=hmask),
             KERNEL_BAR, library_fn=lib_k5, floor=1e-6, flops=14.0 * M * C,
             nbytes=nbytes(res, lns, g, hmask, res, g) + 12 * C)

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
    libs = K.build()
    for n in range(1, 141):
        assert K.attention_bwd_smem_bytes(n, 32, True) == \
            libs["attention_bwd"].mvlt_attention_bwd_smem(n, 32, 1), n
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
                     KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
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

            kw = dict(gres=gres, row_scale=rs, out_dtype=bf)
            chk.case("layernorm_bwd",
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd(
                         r_, gam, dh, 1e-5, **kw),
                     lambda r_=r_, gam=gam, kw=kw: K.layernorm_bwd_plain(
                         r_, gam, dh, 1e-5, **kw),
                     KERNEL_BAR, library_fn=lib_k5, floor=1e-6,
                     flops=16.0 * M * C,
                     nbytes=nbytes(r_, gam, dh, gres, rs) + 6 * M * C + 12 * C)
        chk.case("column_sum", lambda: K.column_sum(gb, row_scale=dp2),
                 lambda: K.column_sum_plain(gb, row_scale=dp2), KERNEL_BAR,
                 floor=1e-6, library_fn=lambda: (gb.float() * r2).sum(0),
                 flops=2.0 * M * C, nbytes=nbytes(gb, dp2, gb) + 4 * C)

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
                 nbytes=nbytes(qkv, kbias, qbias, seed, dctx))
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
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
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
                 nbytes=nbytes(qkv, pat, x, out_p))
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
                 KERNEL_BAR, library_fn=lib, floor=1e-6, **cost)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "mvlt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mvlt_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
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

    chk = Checker()
    kernel_checks(chk, dev)
    train_kernel_checks(chk, dev)
    pretrain_kernel_checks(chk, dev)
    swin_kernel_checks(chk, dev)
    optin_kernel_checks(chk, dev)
    with switches(False):
        by_path = {"vqa_forward": forward_phase(dev, card),
                   "vqa_train_step": train_phase(dev, card),
                   "pretrain_train_step": pretrain_phase(dev, card),
                   "swin_pretrain_train_step": pretrain_phase(dev, card,
                                                              swin=True)}
    by_path["swin_pretrain_switches_train_step"] = pretrain_phase(
        dev, card, timed_steps=10, swin=True, with_switches=True)

    def launches(name):
        return {path: c.get(name, 0) for path, c in by_path.items()}

    rows = []
    counterparts = {**EXPECTED, **EXPECTED_TRAIN, **EXPECTED_PRETRAIN,
                    **EXPECTED_SWITCHES}
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
    if name.startswith("conv.backbone."):
        return "Swin backbone", "max", SWIN_GRAD_BAR
    return "fusion / heads", "max", GRAD_BAR


def compare_grads(model_k, model_p, what: str, bars=resnet_bars) -> None:
    """Every parameter's gradient, kernels vs plain, held to the bar that
    ``bars(name)`` gives its group: ``"max"`` the max abs err over
    max|plain grad|, ``"frob"`` the relative Frobenius norm of the
    difference. A parameter the loss does not reach has no gradient on
    either side."""
    stats, failures, worst = [], [], {}
    for (name, pk), (_, pp) in zip(model_k.named_parameters(),
                                   model_p.named_parameters()):
        gk, gp = pk.grad, pp.grad
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


def forward_phase(dev, card: str) -> dict:
    """The flagship b8 VQA forward: launch counts, logits vs plain, times.
    Returns the launch counts of one forward."""
    from mvlt_tpu_torch.flagship import build_vqa_forward
    from mvlt_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    forward, (image, question) = build_vqa_forward(batch=8, device=dev)
    print(f"flagship model built in {time.perf_counter() - t0:.1f} s; "
          f"padded question tokens {(question == 0).sum().item()}", flush=True)
    reset_counts()
    logits = forward(image, question)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one forward: {json.dumps(counts)}", flush=True)
    for name, (want, _) in EXPECTED.items():
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
    print(f"forward logits vs plain: max_abs_err {err:.4g}, max|plain| "
          f"{scale:.4g}, bar {LOGITS_BAR} x max|plain|; argmax agrees on "
          f"{agree}/8", flush=True)
    if not err <= LOGITS_BAR * scale:
        raise AssertionError(f"forward logits differ from plain: {err} > "
                             f"{LOGITS_BAR * scale}")

    times = {"kernels": [], "plain": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        times[which].append(cuda_ms(
            lambda: forward(image, question, plain=(which == "plain")),
            iters=10, warmup=2))
    ms_k = sum(times["kernels"]) / 2
    ms_p = sum(times["plain"]) / 2
    print(f"flagship b8 forward on {card}: kernels {ms_k:.3f} ms "
          f"({8e3 / ms_k:.1f} samples/s), plain {ms_p:.3f} ms "
          f"({8e3 / ms_p:.1f} samples/s); runs {json.dumps(times)}",
          flush=True)
    del forward
    return counts


def train_phase(dev, card: str, timed_steps: int = 8) -> dict:
    """The VQA finetune train step (ResNet-101 + BERT-base, b32) on the
    kernels and on the plain versions from one seed: launch counts of one
    step, step-1 gradients and the losses of TRAIN_STEPS steps against the
    plain run, then step times in turns. Returns the launch counts of one
    step."""
    from mvlt_tpu_torch.flagship import build_vqa_train_step
    from mvlt_tpu_torch.ops import kernels
    B = TRAIN_BATCH
    t0 = time.perf_counter()
    step_k, batch = build_vqa_train_step(batch=B, device=dev)
    step_p, batch_p = build_vqa_train_step(batch=B, device=dev, plain=True)
    n_params = sum(p.numel() for p in step_k.model.parameters())
    print(f"train step built twice in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} parameters, image {tuple(batch['image'].shape)}, "
          f"question {tuple(batch['question'].shape)}", flush=True)

    reset_counts()
    out_k = step_k(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in one train step: {json.dumps(counts)}", flush=True)
    for name, (want, _) in EXPECTED_TRAIN.items():
        if counts[name] != want:
            raise AssertionError(f"{name} ran {counts[name]} times in one "
                                 f"train step, expected {want}")
    for k in kernels.KERNELS:
        if counts[k.__name__] <= 0:
            raise AssertionError(f"kernel {k.__name__} never launched in the "
                                 "train step")
    out_p = step_p(batch_p)
    torch.cuda.synchronize()
    compare_grads(step_k.model, step_p.model, "step-1 gradients")

    losses = {"kernels": [out_k["loss"].item()],
              "plain": [out_p["loss"].item()]}
    acc = [out_k["accuracy"].item()]
    for _ in range(TRAIN_STEPS - 1):
        losses["kernels"].append(step_k(batch)["loss"].item())
        losses["plain"].append(step_p(batch_p)["loss"].item())
    print(f"losses of {TRAIN_STEPS} steps: {json.dumps(losses)}; step-1 "
          f"accuracy {acc[0]:.4f}", flush=True)
    for i, (lk, lp) in enumerate(zip(losses["kernels"], losses["plain"])):
        if not (abs(lk - lp) <= LOSS_BAR * abs(lp) and lk == lk):
            raise AssertionError(f"step {i + 1} loss {lk} vs plain {lp} "
                                 f"beyond {LOSS_BAR} relative")

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
    print(f"VQA train step b{B} on {card}: kernels {ms_k:.3f} ms/step "
          f"({B * 1e3 / ms_k:.1f} samples/s), plain {ms_p:.3f} ms/step "
          f"({B * 1e3 / ms_p:.1f} samples/s); runs {json.dumps(times)}; "
          f"peak memory in a kernel step {peak / 2 ** 30:.3f} GiB "
          f"(with {resident / 2 ** 30:.3f} GiB resident, both models)",
          flush=True)
    return counts


def pretrain_phase(dev, card: str, timed_steps: int = 6,
                   swin: bool = False, with_switches: bool = False) -> dict:
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
    Returns the launch counts of one step."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    from mvlt_tpu_torch.train.steps import seq2seq_coin_flip
    B = TRAIN_BATCH
    build = (flagship.build_swin_pretrain_train_step if swin
             else flagship.build_pretrain_train_step)
    expected = (EXPECTED_SWITCHES if with_switches
                else EXPECTED_SWIN_PRETRAIN if swin else EXPECTED_PRETRAIN)
    label = "Swin-S pretrain step" if swin else "pretrain step"
    if with_switches:
        label += " with MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1"
    gc.collect()          # a step refers to itself: free the last phase's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_k, batch = build(batch=B, text_len=PRETRAIN_TEXT, device=dev)
    step_p, batch_p = build(batch=B, text_len=PRETRAIN_TEXT, device=dev,
                            plain=True)
    n_params = sum(p.numel() for p in step_k.model.parameters())
    labels = (batch["caption_label"] != -100).sum().item()
    print(f"{label} built twice in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} parameters, image {tuple(batch['image'].shape)}, "
          f"caption {tuple(batch['caption_masked'].shape)}, {labels} MLM "
          f"labels, padded caption tokens "
          f"{(batch['caption_masked'] == 0).sum().item()}", flush=True)
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
                          swin_bars if swin else resnet_bars)
            del masks

        for i, seq2seq in enumerate(PRETRAIN_MODES):
            step_k.masks = recording()
            if i == 0:
                reset_counts()
            out_k = step_k(batch, seq2seq)
            torch.cuda.synchronize()
            if i == 0:
                counts = launch_counts()
                print(f"launches in one {label}: {json.dumps(counts)}",
                      flush=True)
                for name, (want, _) in expected.items():
                    if counts[name] != want:
                        raise AssertionError(
                            f"{name} ran {counts[name]} times in one "
                            f"{label}, expected {want}")
                for k in kernels.KERNELS:
                    if counts[k.__name__] <= 0:
                        raise AssertionError(f"kernel {k.__name__} never "
                                             f"launched in the {label}")
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

    # turns: plain vs kernels, or the kernel step with the switches off / on
    turns = (("off", "on", "on", "off") if with_switches
             else ("plain", "kernels", "kernels", "plain"))
    times = {t: [] for t in turns}
    peak, resident = {}, {}
    for which in turns:
        step, b = (step_p, batch_p) if which == "plain" else (step_k, batch)
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
    if with_switches:
        print(f"MLM+ITM Swin-S pretrain step b{B} (S = 131) on {card}, "
              f"kernels: switches off {ms['off']:.3f} ms/step "
              f"({B * 1e3 / ms['off']:.1f} samples/s), on {ms['on']:.3f} "
              f"ms/step ({B * 1e3 / ms['on']:.1f} samples/s); runs "
              f"{json.dumps(times)}; peak memory off {gib['off']}, on "
              f"{gib['on']}", flush=True)
    else:
        ms_k, ms_p = ms["kernels"], ms["plain"]
        print(f"MLM+ITM {label} b{B} (S = 131) on {card}: kernels "
              f"{ms_k:.3f} ms/step ({B * 1e3 / ms_k:.1f} samples/s), plain "
              f"{ms_p:.3f} ms/step ({B * 1e3 / ms_p:.1f} samples/s); runs "
              f"{json.dumps(times)}; peak memory in a kernel step "
              f"{gib['kernels']}", flush=True)
    return counts


if __name__ == "__main__":
    sys.exit(main())
