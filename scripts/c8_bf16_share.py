#!/usr/bin/env python3
"""How much of the retrieval sub-grid's kernels-vs-plain error is bf16
itself (ROADMAP.md C8).

    python3 scripts/c8_bf16_share.py            # from the root of a checkout

Builds the retrieval model of ``chip_smoke.py``'s retrieval phase twice from
one seed, in bf16 and in float32, and computes the 2-way logits of the same
16 x 64 sub-grid (b64 Swin-S features of the first 64 images, then the
fusion-only score of each of 16 images against 64 captions) three ways: the
kernels in bf16, the plain versions in bf16 and the plain versions in f32.
Prints each bf16 route's max abs error against the f32 run, relative to
max|f32|, and the kernels against the plain bf16 route relative to
max|plain| (the check ``chip_smoke.py`` holds to 0.05), with the card's
name and power limit. Needs a CUDA device; builds the kernels.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def sub_grid(model, images, captions, plain):
    from mvlt_tpu_torch.tasks import retrieval as R
    ni, nc = chip_smoke.RETRIEVAL_SUB
    chunk = chip_smoke.RETRIEVAL_CHUNK
    with torch.no_grad():
        feat = R.encode_images(model, images[:chunk], chunk, plain=plain)
        caps = captions[:nc]
        return torch.stack([model.logits_from_features(
            feat[i:i + 1].expand(nc, -1, -1), caps, plain=plain)
            for i in range(ni)]).float()


def main() -> int:
    if not torch.cuda.is_available():
        print("c8_bf16_share: needs a CUDA device", file=sys.stderr)
        return 1
    from mvlt_tpu_torch.flagship import build_retrieval_grid
    from mvlt_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    kernels.build()
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        grid, (images, captions, _) = build_retrieval_grid(
            n=chip_smoke.RETRIEVAL_N, text_len=chip_smoke.RETRIEVAL_TEXT,
            batch_size=chip_smoke.RETRIEVAL_CHUNK, dtype=dtype, device="cuda")
        model = grid.model
        out[f"plain_{name}"] = sub_grid(model, images, captions, True)
        if name == "bf16":
            out["kernels_bf16"] = sub_grid(model, images, captions, False)
        del grid, model
        torch.cuda.empty_cache()
    ref = out["plain_f32"]
    scale = ref.abs().max().item()
    rel = {
        "plain_bf16_vs_f32": (out["plain_bf16"] - ref).abs().max().item()
        / scale,
        "kernels_bf16_vs_f32": (out["kernels_bf16"] - ref).abs().max().item()
        / scale,
        "kernels_vs_plain_bf16": (out["kernels_bf16"] - out["plain_bf16"])
        .abs().max().item() / out["plain_bf16"].abs().max().item(),
    }
    print(card)
    print("c8 sub-grid " + "x".join(map(str, chip_smoke.RETRIEVAL_SUB))
          + " max abs error / max|reference|: " + json.dumps(rel), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
