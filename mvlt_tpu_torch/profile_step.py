"""Where the device time of a train step goes, on one GPU.

    python -m mvlt_tpu_torch.profile_step [--path vqa|pretrain|swin_pretrain] [--batch 32] [--steps 3]

Builds the VQA finetune train step (``--path vqa``, the default:
:func:`mvlt_tpu_torch.flagship.build_vqa_train_step`), the MLM+ITM
pretrain train step on ResNet-101 (``--path pretrain``:
:func:`~mvlt_tpu_torch.flagship.build_pretrain_train_step`) or the pretrain
step of record on Swin-S with DropPath 0.3 (``--path swin_pretrain``:
:func:`~mvlt_tpu_torch.flagship.build_swin_pretrain_train_step`), both at
text length 80 with the mask mode of each step from a seeded coin flip,
runs two warm-up steps, then traces ``--steps`` steps with
``torch.profiler`` and prints the device time per step by kernel family
(the port's kernels K1-K5, cuDNN convolutions and BatchNorm, cuBLAS
products, PyTorch's LayerNorm, the optimizer, the rest), the
device busy share of the traced window, the unprofiled step times with the
SM clock and power sampled before and after them, and the card's name and
power limit. Needs a CUDA device. The opt-in kernel switches are read
from the environment, e.g. the step of record with both:

    MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1 python -m mvlt_tpu_torch.profile_step --path swin_pretrain
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch

# kernel-name fragment -> family, first match wins; the port's kernels live
# in an anonymous namespace
OURS = "namespace)::"
CUBLAS = ("cuBLAS products (resnet_fc, pooler, heads; Swin patch embed and "
          "merge)")
FAMILIES = [
    (OURS + "attention_bwd_kernel", "K4 biased_attention_bwd"),
    (OURS + "sum_heads_kernel", "K4 biased_attention_bwd"),
    (OURS + "sum_chunks_kernel", "K4 biased_attention_bwd"),
    (OURS + "attention_kernel", "K2 biased_attention"),
    (OURS + "ln_bwd_kernel", "K5 layernorm_bwd"),
    (OURS + "colsum_kernel", "K5 column_sum"),
    (OURS + "reduce_kernel", "K5 partial-sum fold"),
    (OURS + "layernorm_kernel", "K3 layernorm"),
    (OURS + "gemm_kernel", "K1 gemm"),
    ("multi_tensor_apply", "AdamW (multi-tensor)"),
    ("batch_norm", "BatchNorm (ResNet)"),
    ("bn_", "BatchNorm (ResNet)"),
    ("fprop", "cuDNN convolutions (ResNet)"),
    ("dgrad", "cuDNN convolutions (ResNet)"),
    ("wgrad", "cuDNN convolutions (ResNet)"),
    ("conv", "cuDNN convolutions (ResNet)"),
    ("cudnn", "cuDNN convolutions (ResNet)"),
    ("layer_norm", "PyTorch LayerNorm (Swin patch embed / merge / final)"),
    ("gemm", CUBLAS),
    ("nvjet", CUBLAS),
    ("cutlass", CUBLAS),
    ("max_pool", "ResNet max-pool"),
]


# the profiler also puts these ranges on the device timeline; they are not
# kernels and would count their kernels twice
ANNOTATIONS = ("Optimizer.", "ProfilerStep", "aten::", "autograd::")
SAMPLE = "clocks.sm,power.draw,temperature.gpu"
SWITCHES = ("MVLT_KERNEL_DROPOUT", "MVLT_STOREP", "MVLT_NO_STOREP")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag in low:
            return fam
    return "other elementwise / reductions (ReLU, GELU, casts, adds, loss)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("vqa", "pretrain", "swin_pretrain"),
                    default="vqa")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.train.steps import seq2seq_coin_flip
    card = smi("name,power.limit")
    if args.path == "vqa":
        step, batch = flagship.build_vqa_train_step(batch=args.batch,
                                                    device="cuda")
    else:
        build = (flagship.build_swin_pretrain_train_step
                 if args.path == "swin_pretrain"
                 else flagship.build_pretrain_train_step)
        pre_step, batch = build(batch=args.batch, device="cuda")
        flips = torch.Generator().manual_seed(0)
        step = lambda b: pre_step(b, seq2seq_coin_flip(flips))  # noqa: E731
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    clocks = [smi(SAMPLE)]
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    clocks.append(smi(SAMPLE))
    unprofiled_ms = sum(step_ms) / len(step_ms)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    fams, launches, per_kernel = {}, {}, {}
    for evt in prof.events():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or evt.name.startswith(ANNOTATIONS)):
            continue                     # device kernels only, each once
        ms = evt.time_range.elapsed_us() / 1e3 / args.steps
        fam = family(evt.name)
        fams[fam] = fams.get(fam, 0.0) + ms
        launches[fam] = launches.get(fam, 0) + 1
        t, n = per_kernel.get(evt.name, (0.0, 0))
        per_kernel[evt.name] = (t + ms, n + 1)
    launches = {k: v // args.steps for k, v in launches.items()}
    kernels = [(t, n // args.steps, name) for name, (t, n) in per_kernel.items()]
    total = sum(fams.values())
    print(card)
    on = {k: os.environ[k] for k in SWITCHES if k in os.environ}
    print(f"switches: {on or 'none set'}")
    print(f"{SAMPLE} before / after the unprofiled steps: {clocks}")
    print(f"unprofiled step times (ms): {[round(t, 3) for t in step_ms]}")
    print(f"{args.path} train step b{args.batch}: {unprofiled_ms:.3f} ms/step unprofiled, "
          f"{wall_ms:.3f} ms/step under the profiler; device time "
          f"{total:.3f} ms/step, busy share {total / wall_ms:.3f}")
    print(f"{'family':58s} {'ms/step':>9s} {'share':>6s} {'launches':>8s}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"{fam:58s} {ms:9.3f} {ms / total:6.1%} {launches[fam]:8d}")
    print("top kernels (ms/step, launches/step, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:15]:
        print(f"  {ms:8.3f} {n:5d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
