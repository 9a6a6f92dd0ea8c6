#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX. Phases, each of which raises on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's three CUDA kernels from ``mvlt_tpu_torch/csrc``
   with nvcc (sm_90a) into ``build/torch_kernels/``;
3. kernel checks: hold K1 ``gemm``, K2 ``biased_attention``, K3
   ``layernorm`` and the six TPU-kernel counterparts of
   ``mvlt_tpu_torch.ops.blocks`` against their plain PyTorch versions on the
   card, in bf16 at the flagship batch-8 shapes, and time both;
4. forward: run the flagship VQA forward (Swin-S @224 + BERT-base, bf16,
   batch 8, question length 23 with padding) through the kernels, check the
   launch counts, compare its logits with the same model on the plain
   versions, and time both;
5. print ``{"kernels": [...]}``, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

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
# the three hand-written kernels and the TPU code whose pieces each carries
KERNEL_SOURCES = {
    "gemm": ("mvlt_tpu_torch/csrc/gemm.cu", "mvlt_tpu/ops/pallas_attn.py:571"),
    "biased_attention": ("mvlt_tpu_torch/csrc/attention.cu",
                         "mvlt_tpu/ops/pallas_attn.py:512"),
    "layernorm": ("mvlt_tpu_torch/csrc/layernorm.cu",
                  "mvlt_tpu/ops/pallas_attn.py:494"),
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


class Checker:
    """Runs each kernel case against its plain twin and keeps the numbers."""

    def __init__(self):
        self.rows = {}

    def case(self, name: str, kernel_fn, plain_fn, bar: float) -> None:
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (name, got.shape, want.shape, got.dtype, want.dtype)
        assert torch.isfinite(got).all(), f"{name}: non-finite output"
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        limit = bar * max(scale, 1.0)
        if not err <= limit:
            raise AssertionError(f"{name}: max abs err {err} > {limit} "
                                 f"(bar {bar} x max|plain| {scale})")
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        row = self.rows.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                          "plain_ms": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms                # summed over the cases of one kernel
        row["plain_ms"] += plain_ms
        print(f"check {name}: max_abs_err {err:.3g} (limit {limit:.3g}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)


def kernel_checks(chk: Checker, dev) -> None:
    from mvlt_tpu_torch.models.backbones.swin import shifted_window_mask
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    def dense(k, n):
        return rnd(n, k, std=k ** -0.5), rnd(n, std=0.1)

    def ln(c):
        return rnd(c, std=0.1, dtype=torch.float32) + 1.0, \
            rnd(c, std=0.1, dtype=torch.float32)

    def perm(m):
        return torch.randperm(m, generator=gen).to(dev, torch.int32)

    # K1 at the flagship's product shapes (M, K, N, gelu, residual, indices)
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
        chk.case("gemm", lambda: K.gemm(a, w, b, **kw),
                 lambda: K.gemm_plain(a, w, b, **kw), KERNEL_BAR)

    # K2: Swin windows (shift patterns per window at stages 1-3), BERT rows
    for G, N, C, nH, P, padded in [(512, 49, 96, 3, 64, False),
                                   (32, 49, 384, 12, 4, False),
                                   (8, 49, 768, 24, 1, False),
                                   (8, 74, 768, 12, 0, True)]:
        qkv = rnd(G * N, 3 * C)
        pat = rnd(P, nH, N, N, dtype=torch.float32) if P else None
        kb = None
        if padded:
            kb = torch.where(torch.rand(G, N, generator=gen) < 0.2,
                             -10000.0, 0.0).to(dev)
        sc = (C // nH) ** -0.5
        chk.case("biased_attention",
                 lambda: K.biased_attention(qkv, nH, N, sc, pat, kb),
                 lambda: K.biased_attention_plain(qkv, nH, N, sc, pat, kb),
                 KERNEL_BAR)

    # K3: stage-1 LN1 with the shift gather, stage-3 merge norm, BERT LN
    for M, C, idx, eps in [(25088, 96, True, 1e-5), (392, 1536, False, 1e-5),
                           (592, 768, False, 1e-12)]:
        x = rnd(M, C, std=2.0) + 0.5
        g, b = ln(C)
        ri = perm(M) if idx else None
        chk.case("layernorm", lambda: K.layernorm(x, g, b, eps, ri),
                 lambda: K.layernorm_plain(x, g, b, eps, ri), KERNEL_BAR)

    # the six counterparts at stages 1-3 / stage 4 / BERT, batch 8
    for res, C, nH in [(56, 96, 3), (28, 192, 6), (14, 384, 12)]:
        N, nW = 49, (res // 7) ** 2
        x = rnd(8 * nW, N, C)
        params = (*ln(C), *dense(C, 3 * C), *dense(C, C), *ln(C),
                  *dense(C, 4 * C), *dense(4 * C, C))
        rel = rnd(1, nH, N, N, dtype=torch.float32)
        mask = torch.as_tensor(shifted_window_mask(res, res, 7, 3), device=dev)
        shifted = (rel + mask[:, None]).contiguous()
        sc = (C // nH) ** -0.5
        chk.case("swin_full_block",
                 lambda: blocks.swin_full_block(x, params, rel, sc, nH),
                 lambda: blocks.swin_full_block_plain(x, params, rel, sc, nH),
                 BLOCK_BAR)
        spec = (res, res, 7, 3)
        chk.case("swin_full_block_shift",
                 lambda: blocks.swin_full_block(x, params, shifted, sc, nH,
                                                shift_spec=spec),
                 lambda: blocks.swin_full_block_plain(x, params, shifted, sc,
                                                      nH, shift_spec=spec),
                 BLOCK_BAR)

    C, nH = 768, 24
    x, h = rnd(8, 49, C), rnd(8, 49, C)
    (wq, bq), (wp, bp) = dense(C, 3 * C), dense(C, C)
    rel = rnd(1, nH, 49, 49, dtype=torch.float32)
    sc = (C // nH) ** -0.5
    chk.case("window_block_attention",
             lambda: blocks.window_block_attention(h, wq, bq, wp, bp, rel, sc,
                                                   nH, residual=x),
             lambda: blocks.window_block_attention_plain(
                 h, wq, bq, wp, bp, rel, sc, nH, residual=x), BLOCK_BAR)
    mlp = (*ln(C), *dense(C, 4 * C), *dense(4 * C, C))
    chk.case("fused_mlp_preln", lambda: blocks.fused_mlp_preln(x, *mlp),
             lambda: blocks.fused_mlp_preln_plain(x, *mlp), BLOCK_BAR)

    C, nH, S = 768, 12, 74
    x = rnd(8, S, C)
    lengths = torch.tensor([74, 70, 60, 55, 74, 53, 66, 58])
    kb = torch.where(torch.arange(S)[None] < lengths[:, None], 0.0,
                     -10000.0).to(dev)
    attn = (*dense(C, 3 * C), *dense(C, C), kb, *ln(C), (C // nH) ** -0.5,
            nH, 1e-12)
    chk.case("fused_attn_ln", lambda: blocks.fused_attn_ln(x, *attn),
             lambda: blocks.fused_attn_ln_plain(x, *attn), BLOCK_BAR)
    bert_mlp = (*dense(C, 4 * C), *dense(4 * C, C), *ln(C), 1e-12)
    chk.case("fused_mlp_ln", lambda: blocks.fused_mlp_ln(x, *bert_mlp),
             lambda: blocks.fused_mlp_ln_plain(x, *bert_mlp), BLOCK_BAR)


def launch_counts() -> dict:
    from mvlt_tpu_torch.ops import blocks, kernels
    counts = {k.__name__: k.launches for k in kernels.KERNELS}
    for fn in blocks.COUNTERPARTS:
        counts[fn.__name__] = fn.launches
    counts["swin_full_block_shift"] = blocks.swin_full_block.shift_launches
    return counts


def reset_counts() -> None:
    from mvlt_tpu_torch.ops import blocks, kernels
    for fn in kernels.KERNELS:
        fn.launches = 0
    for fn in blocks.COUNTERPARTS:
        fn.launches = fn.shift_launches = 0


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

    from mvlt_tpu_torch.flagship import build_vqa_forward
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
    for k in kernels.KERNELS:
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

    rows = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     **chk.rows[name]})
    for name, (_, replaces) in EXPECTED.items():
        rows.append({"name": name, "route": "cuda",
                     "source": "mvlt_tpu_torch/ops/blocks.py",
                     "replaces": replaces, "launches": counts[name],
                     **chk.rows[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
