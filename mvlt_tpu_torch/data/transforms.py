"""Host-side data transforms of the port (numpy, explicit PRNG): a copy of
the pieces of ``mvlt_tpu/data/transforms.py`` that the port's drivers use:
:func:`sample_rng` (``transforms.py:34-42``), which keys the loader's
shuffle and every sample's draws; the pretrain driver's image loads
(``:45-87``: the reference's per-channel ``(x - mean) / var``, variance and
not std) and its masking and truncation (``:125-172``: <= 10 tokens at 20%
a token, 80/10/10 mask / random / keep; the trailing ``[END]`` kept). The
caption transforms come with the caption driver (ROADMAP.md queue A).

PIL is imported inside the functions that decode images, as in JAX."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def sample_rng(seed: int, epoch: int, index: int,
               tag: int = 0) -> np.random.Generator:
    """Stable per-sample generator (independent of worker layout).
    Philox takes a 128-bit key: pack (seed, epoch) and (index, tag)."""
    key = np.array([(np.uint64(seed & 0xFFFFFFFF) << np.uint64(32))
                    | np.uint64(epoch & 0xFFFFFFFF),
                    (np.uint64(index & 0xFFFFFFFF) << np.uint64(32))
                    | np.uint64(tag & 0xFFFFFFFF)], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def normalize_image_var(im_chw: np.ndarray) -> np.ndarray:
    """Per-channel (x - mean) / var — the reference's quirk (var, not std)."""
    im = im_chw.astype(np.float32, copy=False)
    mean = im.mean(axis=(-2, -1), keepdims=True)
    var = im.var(axis=(-2, -1), keepdims=True)
    return (im - mean) / var


def _open_resized(path: str, size: int, fast: bool):
    from PIL import Image
    im = Image.open(path)
    if fast:
        # libjpeg's DCT-domain prescaling: pixels differ slightly from the
        # full decode, so it is opt-in (--jpeg_draft)
        im.draft("RGB", (size, size))
    return im.convert("RGB").resize((size, size))


def load_image_var_normalized(path: str, size: int = 224,
                              fast: bool = False) -> np.ndarray:
    """PIL open -> RGB -> resize -> CHW float32 -> variance-normalize
    (run_pretrain_rgc_roco_medicat.py:104-110)."""
    im = np.asarray(_open_resized(path, size, fast), dtype=np.float32)
    return normalize_image_var(im.transpose(2, 0, 1))


def load_image_u8(path: str, size: int = 224,
                  fast: bool = False) -> np.ndarray:
    """PIL open -> RGB -> resize -> (H, W, 3) uint8: the device-normalize
    host path; the float cast, the CHW layout and the per-channel
    ``(x - mean) / var`` run on the device
    (:func:`mvlt_tpu_torch.models.backbones.adapter.device_var_normalize`),
    and a quarter of the f32 bytes crosses the bus."""
    return np.asarray(_open_resized(path, size, fast))


def random_mask_word(tokens: Sequence[str], vocab: dict,
                     rng: np.random.Generator,
                     vocab_words: Optional[List[str]] = None,
                     ) -> Tuple[List[str], List[int]]:
    """80/10/10 masking over <=10 tokens at 20%/token
    (run_pretrain.py:130-158; identical copies in the caption drivers)."""
    token_len = len(tokens)
    output_tokens = list(tokens)
    output_labels = [-100] * token_len
    masked_num = min(10, max(1, round(token_len * 0.2)))
    idx_list = rng.permutation(token_len)[:masked_num]
    words = vocab_words if vocab_words is not None else list(vocab.keys())
    unk = vocab.get("[UNK]")
    for idx in idx_list:
        idx = int(idx)
        p = rng.random()
        token = tokens[idx]
        if p < 0.8:
            output_tokens[idx] = "[MASK]"
        elif p < 0.9:
            output_tokens[idx] = words[int(rng.integers(0, len(words)))]
        # else: keep
        output_labels[idx] = vocab.get(token, unk)
    return output_tokens, output_labels


def pad_truncate_preserve_end(ids: Sequence[int], max_length: int,
                              labels: Optional[Sequence[int]] = None,
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Truncate keeping the last ([END]) token, zero-pad ids, -100-pad
    labels (run_pretrain.py:114-127)."""
    ids = list(ids)
    labels = list(labels) if labels is not None else None
    if len(ids) > max_length:
        ids = ids[:max_length - 1] + [ids[-1]]
        if labels is not None:
            labels = labels[:max_length - 1] + [labels[-1]]
    n = min(len(ids), max_length)
    out_ids = np.zeros(max_length, np.int32)
    out_ids[:n] = np.asarray(ids[:n], np.int32)
    out_labels = np.full(max_length, -100, np.int32)
    if labels is not None:
        out_labels[:n] = np.asarray(labels[:n], np.int32)
    return out_ids, out_labels
