#!/usr/bin/env python3
"""How much of the ``drop_rate`` Swin-S step's table-gradient error is bf16
itself (ROADMAP.md C13).

    python3 scripts/c13_bf16_share.py            # from the root of a checkout

Builds the Swin-S pretrain step with ``swin.drop_rate`` 0.1 of
``chip_smoke.py --swin-routes`` (``flagship_swin_dropout_pretrain_config``,
b32, text 80, seed 0) twice from one seed, with bf16 and with float32
compute (both keep f32 master weights, so both start from the same
parameters), and takes the initial gradients in seq2seq mode three ways:
the kernels in bf16, the plain versions in bf16 and the plain versions in
f32, the last two replaying the DropPath and dropout masks the first drew.
For every Swin relative-position table it prints each bf16 route's max abs
error against the f32 gradient, relative to max|f32 grad|, and the kernels
against the plain bf16 route relative to max|plain grad| (the check that
``chip_smoke.py`` holds to 0.05, ``SWIN_GRAD_BAR``): the worst table of
each, then all three on the three tables where kernels and plain bf16
differ most, with the card's name and power limit. Needs a CUDA device;
builds the kernels.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

KEYS = ("image", "caption_masked", "caption_label", "itm_label")


def table_grads(step, batch, plain: bool, masks) -> dict:
    """The relative-position tables' gradients of one seq2seq loss."""
    model = step.model
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(*(batch[k] for k in KEYS), seq2seq=True,
                         plain=plain, masks=masks)
    loss.backward()
    torch.cuda.synchronize()
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters()
            if n.endswith(".relative_position_bias_table")}


def rel_errs(a: dict, b: dict) -> dict:
    """max|a - b| / max|b| per table."""
    return {n: ((a[n] - b[n]).abs().max() / b[n].abs().max()).item()
            for n in b}


def main() -> int:
    if not torch.cuda.is_available():
        print("c13_bf16_share: needs a CUDA device", file=sys.stderr)
        return 1
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops import kernels
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    kernels.build()
    config = flagship.flagship_swin_dropout_pretrain_config()
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        step, batch = flagship.build_swin_pretrain_train_step(
            batch=chip_smoke.TRAIN_BATCH, text_len=chip_smoke.PRETRAIN_TEXT,
            device="cuda", compute_dtype=dtype, config=config)
        if dtype == torch.bfloat16:
            gen = torch.Generator(device="cuda").manual_seed(1)
            record = DropoutMasks(gen, record=True)
            grads["kernels_bf16"] = table_grads(step, batch, False, record)
            grads["plain_bf16"] = table_grads(
                step, batch, True, DropoutMasks.replay(record.recorded))
        else:
            grads["plain_f32"] = table_grads(
                step, batch, True, DropoutMasks.replay(record.recorded))
        del step, batch
        torch.cuda.empty_cache()
    ref = grads["plain_f32"]
    errs = {"plain_bf16_vs_f32": rel_errs(grads["plain_bf16"], ref),
            "kernels_bf16_vs_f32": rel_errs(grads["kernels_bf16"], ref),
            "kernels_vs_plain_bf16": rel_errs(grads["kernels_bf16"],
                                              grads["plain_bf16"])}
    out = {k: {"max": max(v.values()), "table": max(v, key=v.get)}
           for k, v in errs.items()}
    # the three routes side by side on the tables where kernels and plain
    # bf16 differ most
    worst = sorted(ref, key=errs["kernels_vs_plain_bf16"].get)[-3:]
    print(card)
    print(f"c13 drop_rate step, {len(ref)} relative-position tables, "
          "seq2seq, max abs error / max|reference grad|: " + json.dumps(out),
          flush=True)
    for n in reversed(worst):
        print(f"c13 {n}: " + json.dumps({k: v[n] for k, v in errs.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
