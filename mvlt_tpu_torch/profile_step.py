"""Where the device time of a train step or a report-generation call goes,
on one GPU.

    python -m mvlt_tpu_torch.profile_step [--path vqa|pretrain|swin_pretrain|swin_pretrain_remat|caption_step|caption_generate|retrieval_step|retrieval_grid|vqa_driver|vqa_driver_bare|pretrain_driver] [--batch 32] [--steps 3] [--attn-impl auto|pallas|pallas_block|xla] [--conv vit|linear|swin|resnet101|resnet50] [--trace DIR]

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
products, PyTorch's LayerNorm, the optimizer, the rest), K1's time by
layout (NT forward, NN data gradients, TN weight gradients and their
split-K fold), the
device busy share of the traced window, the unprofiled step times with the
SM clock and power sampled before and after them, and the card's name and
power limit. Needs a CUDA device. The opt-in kernel switches are read
from the environment, e.g. the step of record with both:

    MVLT_KERNEL_DROPOUT=1 MVLT_STOREP=1 python -m mvlt_tpu_torch.profile_step --path swin_pretrain

``--conv`` swaps the backbone of ``--path vqa`` or ``--path pretrain``
(ResNet-101 by default): ``--conv vit`` is ViT-B/16 @224 (S = 221 / 278 in
the fusion encoder), ``--conv linear`` the linear patch (the VQA finetune
step of ``flagship_linear_vqa_train_config``); and of ``--path
caption_step`` (Swin-S by default): ``--conv vit`` or ``linear`` put the
caption step at S = 1 + 196 + 1 + 150 = 348, where K2 and K4 run their
long form.

``--attn-impl pallas`` builds the Swin backbone on its ``attn_impl='pallas'``
route (``window_attention`` in every block), ``pallas_block`` on row 1 in
every block, ``xla`` on the plain torch attention, as the JAX package's
tests set it: the adapter's ``SwinTransformer`` patched while the step is
built.

``--path swin_pretrain_remat`` is ``swin_pretrain`` with
``remat_backbone`` and ``remat_fusion`` (:func:`~mvlt_tpu_torch.flagship.
flagship_swin_remat_pretrain_config`): every Swin block and fusion layer
recomputed before its backward.

``--path caption_step`` is the caption train step
(:func:`~mvlt_tpu_torch.flagship.build_caption_train_step`: Swin-S +
BERT-base, text 150, unilm); ``--path caption_generate`` one call of report
generation (:func:`~mvlt_tpu_torch.flagship.build_caption_generate`: beam
5, length 150, bf16), whose "step" is a whole generate call: its device
time, busy share and launches (``--steps 1`` keeps the trace short).
``--path retrieval_step`` is the retrieval train step
(:func:`~mvlt_tpu_torch.flagship.build_retrieval_train_step`: ``--batch``
pairs, ``cat(pos, neg)`` = twice as many rows, text 80); ``--path
retrieval_grid`` one N x N retrieval grid of 128 samples in chunks of 64
(:func:`~mvlt_tpu_torch.flagship.build_retrieval_grid`, bf16), whose
"step" is a whole grid.

``--path vqa_driver`` traces steps of the VQA task driver's train loop
(:func:`mvlt_tpu_torch.tasks.vqa.train_vqa`'s body: the shuffled loader
with its worker processes, the device prefetch, the masks of the step, the
step, the host step count and ``log_step``) at ``run_vqa``'s defaults
(Swin-S + BERT-base, ``for_vqa``, DropPath 0.3; ``--batch 64`` as the
driver runs it) over a synthetic SLAKE of the English release's lengths
(4,919 train questions: 76 steps at b64) written as pickles under
``build/profile_vqa_driver``; before the warm-up it runs
``DRIVER_STEADY_FROM`` steps, past what the loader builds ahead at an
epoch's start, so that the window shows the loop's steady pace.
``--path vqa_driver_bare`` is the same model's bare step on one resident
batch, to set beside it.

``--path pretrain_driver`` traces steps of the pretrain driver's loop
(:func:`mvlt_tpu_torch.tasks.pretrain.train_pretrain`'s body: the loader,
the device prefetch of uint8 frames, the coin flip, the masks, the step,
``log_step``) at ``run_pretrain``'s defaults (Swin-S + BERT-base,
``for_pretrain`` with ITM, text 80, b32) over a synthetic uint8 cache
(``U8CacheSource``) of ``PRETRAIN_DRIVER_SAMPLES`` frames of 224,
normalized on the device, written under ``build/profile_pretrain_driver``,
after ``DRIVER_STEADY_FROM`` steps.

``--trace DIR`` traces the profiled steps through
:func:`mvlt_tpu_torch.utils.profiling.trace`, each step inside
``annotate("mvlt step")``, and keeps the trace, ``DIR/trace.json`` (Chrome
trace format, for Perfetto), beside the same printed breakdown.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import subprocess
import time
from unittest import mock

import torch

# kernel-name fragment -> family, first match wins; the port's kernels live
# in an anonymous namespace
OURS = "namespace)::"
CUBLAS = ("cuBLAS products (resnet_fc, pooler, heads; Swin patch embed and "
          "merge; on 'pallas' every Swin dense layer; ViT training)")
FAMILIES = [
    (OURS + "attention_bwd_", "K4 biased_attention_bwd"),   # both passes
    (OURS + "sum_heads_kernel", "K4 biased_attention_bwd"),
    (OURS + "sum_chunks_kernel", "K4 biased_attention_bwd"),
    (OURS + "attention_wgmma_kernel", "K2 biased_attention"),
    (OURS + "attention_mid_kernel", "K2 biased_attention"),   # 160 < N <= 288
    (OURS + "attention_long_kernel", "K2 biased_attention"),  # N > 288
    (OURS + "ln_bwd_kernel", "K5 layernorm_bwd"),          # <lanes, chunks>
    (OURS + "colsum_kernel", "K5 column_sum"),
    (OURS + "fold_kernel", "K5 partial-sum fold"),          # both K5 calls
    (OURS + "layernorm_kernel", "K3 layernorm"),            # <lanes, chunks>
    (OURS + "gemm_", "K1 gemm"),      # the mainloop and the split-K fold
    # SDPA's kernels (cuDNN's, or cutlass's memory-efficient ones) name
    # cuDNN or cutlass: before the convolutions and cuBLAS
    ("sdpa", "SDPA (decode and prefill attention)"),
    ("fmha", "SDPA (decode and prefill attention)"),
    ("flash_fwd", "SDPA (decode and prefill attention)"),
    ("multi_tensor_apply", "AdamW (multi-tensor)"),
    ("batch_norm", "BatchNorm (ResNet, linear patch)"),
    ("bn_", "BatchNorm (ResNet, linear patch)"),
    ("fprop", "cuDNN convolutions (ResNet, linear patch)"),
    ("dgrad", "cuDNN convolutions (ResNet, linear patch)"),
    ("wgrad", "cuDNN convolutions (ResNet, linear patch)"),
    ("conv", "cuDNN convolutions (ResNet, linear patch)"),
    ("cudnn", "cuDNN convolutions (ResNet, linear patch)"),
    ("layer_norm", "PyTorch LayerNorm (Swin patch embed / merge / final; "
                   "on 'pallas' every Swin LN; ViT training)"),
    ("gemm", CUBLAS),
    ("nvjet", CUBLAS),
    ("cutlass", CUBLAS),
    ("max_pool", "ResNet max-pool"),
    ("sort", "torch.sort (beam candidates)"),
    ("index", "gathers / index copies (beam and cache reorder, "
              "embedding backward)"),
    ("scatter_gather", "gathers / index copies (beam and cache reorder, "
                       "embedding backward)"),
]


# K1's kernels by what they compute: the mainloop's template argument is its
# layout (csrc/gemm.cu)
K1_PARTS = [
    ("gemm_wgmma_kernel<0>", "NT: forward products"),
    ("gemm_wgmma_kernel<1>", "NN: data gradients dX = dY W"),
    ("gemm_wgmma_kernel<2>", "TN: weight gradients dW = dY^T X"),
    ("gemm_fold_kernel", "split-K fold (weight gradients)"),
]

# the profiler also puts these ranges on the device timeline; they are not
# kernels and would count their kernels twice
ANNOTATIONS = ("Optimizer.", "ProfilerStep", "aten::", "autograd::",
               "mvlt step")
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


def k1_part(name: str):
    """K1's part (layout, or the split-K fold) of a kernel name, or None."""
    for frag, part in K1_PARTS:
        if frag in name:
            return part
    return None


# steps of the driver's loop run before its warm-up: past the batches that
# the loader builds ahead while an epoch starts (its workers' and 2 more
# pool jobs, 2 queued, 2 in the device prefetch: 13 with the 7 workers of
# an 8-core host)
DRIVER_STEADY_FROM = 16


def _driver(args):
    """(step(_), None): one step of the VQA driver's train loop, or with
    ``vqa_driver_bare`` the bare step on one resident batch."""
    import pathlib

    from mvlt_tpu_torch import run_vqa
    from mvlt_tpu_torch.config import TrainConfig
    from mvlt_tpu_torch.data.datasets import SLAKE_SPLITS, write_synthetic_vqa
    from mvlt_tpu_torch.data.loader import DataLoader
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_vqa_step
    root = pathlib.Path("build") / "profile_vqa_driver"
    write_synthetic_vqa(str(root), splits=SLAKE_SPLITS)
    rargs = run_vqa.parse_args(["--data_root", str(root), "--batch_size",
                                str(args.batch)])
    tok = WordPieceTokenizer()
    train, _, _ = run_vqa.build_datasets(rargs, tok)
    cfg = run_vqa.build_config(rargs, tok, len(train.ans2label))
    runner = TaskRunner(VQAModel, cfg, TrainConfig(batch_size=args.batch),
                        device="cuda", name="vqa-profile")
    runner.init_state()
    tc = runner.train_config
    step = make_vqa_step(runner.model, runner.optimizer)
    loader = DataLoader(train, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers)
    print(f"vqa driver: {loader.num_workers} loader worker processes, "
          f"{loader.batches_per_epoch()} steps an epoch")

    def batches():
        epoch = 0
        while True:
            yield from step.prefetch(loader.epoch(epoch))
            epoch += 1

    it = batches()
    resident = next(it) if args.path == "vqa_driver_bare" else None

    def one(_):
        b = resident if resident is not None else next(it)
        step.masks = runner.masks_for_step()
        out = step(b)
        runner.state.step += 1
        runner.log_step(out, samples=tc.batch_size)
        return out

    if resident is None:
        for _ in range(DRIVER_STEADY_FROM):
            one(None)
    return one, None


# samples of the synthetic uint8 cache of --path pretrain_driver (32 steps
# at b32)
PRETRAIN_DRIVER_SAMPLES = 1024


def _pretrain_driver(args):
    """(step(_), None): one step of the pretrain driver's loop on a uint8
    cache."""
    import pathlib

    from mvlt_tpu_torch import run_pretrain
    from mvlt_tpu_torch.config import TrainConfig
    from mvlt_tpu_torch.data.datasets import (PretrainDataset, U8CacheSource,
                                              synthetic_pretrain_frames,
                                              write_u8_cache)
    from mvlt_tpu_torch.data.loader import DataLoader
    from mvlt_tpu_torch.models.heads import PretrainModel
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.pretrain import batch_mode
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    from mvlt_tpu_torch.train.steps import make_pretrain_step
    root = pathlib.Path("build") / "profile_pretrain_driver"
    cache = write_u8_cache(str(root), *synthetic_pretrain_frames(
        PRETRAIN_DRIVER_SAMPLES))
    rargs = run_pretrain.parse_args(["--batch_size", str(args.batch)])
    tok = WordPieceTokenizer()
    cfg = run_pretrain.build_config(rargs, tok)
    data = PretrainDataset(U8CacheSource(cache), tok,
                           max_length=rargs.max_length,
                           mlm_task=cfg.mlm_task, itm_task=cfg.itm_task)
    runner = TaskRunner(PretrainModel, cfg, TrainConfig(batch_size=args.batch),
                        device="cuda", name="pretrain-profile")
    runner.init_state()
    tc = runner.train_config
    step = make_pretrain_step(runner.model, runner.optimizer)
    loader = DataLoader(data, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers)
    print(f"pretrain driver: {loader.num_workers} loader worker processes, "
          f"{loader.batches_per_epoch()} steps an epoch, uint8 frames")

    def batches():
        epoch = 0
        while True:
            for i, b in enumerate(step.prefetch(loader.epoch(epoch))):
                yield batch_mode(tc, epoch, i), b
            epoch += 1

    it = batches()

    def one(_):
        mode, b = next(it)
        step.masks = runner.masks_for_step()
        out = step(b, mode)
        runner.state.step += 1
        runner.log_step(out, samples=tc.batch_size)
        return out

    for _ in range(DRIVER_STEADY_FROM):
        one(None)
    return one, None


def _build(args, flagship, seq2seq_coin_flip):
    """(step(batch), batch) of ``args.path`` on the card."""
    if args.path.startswith("vqa_driver"):
        return _driver(args)
    if args.path == "pretrain_driver":
        return _pretrain_driver(args)
    if args.path == "vqa":
        cfg = args.conv and dataclasses.replace(
            flagship.flagship_vqa_train_config(), conv=args.conv)
        return flagship.build_vqa_train_step(batch=args.batch, device="cuda",
                                             config=cfg)
    if args.path == "caption_step":
        cfg = {"vit": flagship.flagship_vit_caption_config,
               "linear": lambda: flagship.flagship_linear_caption_config(150),
               }.get(args.conv, lambda: None)()
        return flagship.build_caption_train_step(batch=args.batch,
                                                 device="cuda", config=cfg)
    if args.path == "retrieval_step":
        return flagship.build_retrieval_train_step(pairs=args.batch,
                                                   device="cuda")
    if args.path == "retrieval_grid":
        grid, data = flagship.build_retrieval_grid(device="cuda")
        return (lambda d: grid(*d)), data
    if args.path == "caption_generate":
        gen, image = flagship.build_caption_generate(batch=args.batch,
                                                     device="cuda")
        return (lambda im: gen(im)), image
    if args.path.startswith("swin_pretrain"):
        cfg = (flagship.flagship_swin_remat_pretrain_config()
               if args.path == "swin_pretrain_remat" else None)
        pre_step, batch = flagship.build_swin_pretrain_train_step(
            batch=args.batch, device="cuda", config=cfg)
    else:
        cfg = args.conv and dataclasses.replace(
            flagship.flagship_pretrain_config(), conv=args.conv)
        pre_step, batch = flagship.build_pretrain_train_step(
            batch=args.batch, device="cuda", config=cfg)
    flips = torch.Generator().manual_seed(0)
    return (lambda b: pre_step(b, seq2seq_coin_flip(flips))), batch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("vqa", "pretrain", "swin_pretrain",
                                       "swin_pretrain_remat", "caption_step",
                                       "caption_generate", "retrieval_step",
                                       "retrieval_grid",
                                       "vqa_driver", "vqa_driver_bare",
                                       "pretrain_driver"),
                    default="vqa")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "pallas", "pallas_block", "xla"),
                    help="the Swin backbone's route (swin_pretrain)")
    ap.add_argument("--conv", default=None,
                    choices=("vit", "linear", "swin", "resnet101", "resnet50"),
                    help="the backbone of --path vqa / pretrain / "
                         "caption_step")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="keep the profiled steps' trace as DIR/trace.json "
                         "(mvlt_tpu_torch.utils.profiling.trace)")
    args = ap.parse_args()
    if args.conv and args.path not in ("vqa", "pretrain", "caption_step"):
        ap.error("--conv applies to --path vqa, pretrain and caption_step")
    if args.path == "caption_step" and args.conv in ("resnet101",
                                                      "resnet50"):
        ap.error("--path caption_step takes --conv vit, linear or swin")
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models.backbones import adapter, swin
    from mvlt_tpu_torch.train.steps import seq2seq_coin_flip
    from mvlt_tpu_torch.utils import profiling
    card = smi("name,power.limit")
    route = contextlib.nullcontext()
    if args.attn_impl != "auto":
        route = mock.patch.object(adapter, "SwinTransformer", functools.partial(
            swin.SwinTransformer, attn_impl=args.attn_impl))
    with route:
        step, batch = _build(args, flagship, seq2seq_coin_flip)
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

    traced = (profiling.trace(args.trace) if args.trace else
              profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]))
    with traced as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with profiling.annotate("mvlt step"):
                step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    fams, launches, per_kernel, k1 = {}, {}, {}, {}
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
        part = k1_part(evt.name)
        if part is not None:
            t, n = k1.get(part, (0.0, 0))
            k1[part] = (t + ms, n + 1)
    launches = {k: v // args.steps for k, v in launches.items()}
    kernels = [(t, n // args.steps, name) for name, (t, n) in per_kernel.items()]
    total = sum(fams.values())
    print(card)
    on = {k: os.environ[k] for k in SWITCHES if k in os.environ}
    print(f"switches: {on or 'none set'}; attn_impl={args.attn_impl!r}")
    print(f"{SAMPLE} before / after the unprofiled steps: {clocks}")
    print(f"unprofiled step times (ms): {[round(t, 3) for t in step_ms]}")
    what = {"caption_generate": "call", "retrieval_grid": "grid"}.get(
        args.path, "step")
    size = {"retrieval_grid": "n128",
            "retrieval_step": f"{args.batch} pairs"}.get(args.path,
                                                        f"b{args.batch}")
    print(f"{args.path} {size}: {unprofiled_ms:.3f} ms/{what} unprofiled, "
          f"{wall_ms:.3f} ms/{what} under the profiler; device time "
          f"{total:.3f} ms/{what}, busy share {total / wall_ms:.3f}")
    print(f"{'family':58s} {'ms/' + what:>9s} {'share':>6s} {'launches':>8s}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"{fam:58s} {ms:9.3f} {ms / total:6.1%} {launches[fam]:8d}")
    print("K1 gemm by part (ms/step, launches/step):")
    for part, (ms, n) in sorted(k1.items(), key=lambda kv: -kv[1][0]):
        print(f"  {part:56s} {ms:9.3f} {n // args.steps:8d}")
    print("top kernels (ms/step, launches/step, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:15]:
        print(f"  {ms:8.3f} {n:5d}  {name[:110]}")
    if args.trace:
        path = os.path.join(args.trace, profiling.TRACE_FILE)
        print(f"trace: {path}, {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
