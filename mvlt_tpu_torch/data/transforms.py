"""Host-side data transforms of the port (numpy, explicit PRNG): a copy of
the pieces of ``mvlt_tpu/data/transforms.py`` that the port's drivers use:
:func:`sample_rng` (``transforms.py:34-42``), which keys the loader's
shuffle and every sample's draws; the pretrain driver's image loads
(``:45-87``: the reference's per-channel ``(x - mean) / var``, variance and
not std) and its masking and truncation (``:125-172``: <= 10 tokens at 20%
a token, 80/10/10 mask / random / keep; the trailing ``[END]`` kept); the
caption driver's ImageNet transforms (``:90-120``: resize the shorter side,
random crop and flip for training, resize for eval, ImageNet's mean / std),
used where no ``--pretrained`` export is given; and the report cleaning of
IU X-Ray and MIMIC-CXR (``:175-214``, the reference's regexes verbatim).

PIL is imported inside the functions that decode images, as in JAX."""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


def imagenet_normalize(im_hwc01: np.ndarray) -> np.ndarray:
    """(H, W, 3) in [0,1] -> normalized CHW (torchvision Normalize)."""
    out = (im_hwc01 - IMAGENET_MEAN) / IMAGENET_STD
    return out.transpose(2, 0, 1).astype(np.float32)


def train_augment_imagenet(pil_image, rng: np.random.Generator,
                           resize: int = 256, crop: int = 224) -> np.ndarray:
    """Resize-shorter-side + random crop + hflip + ImageNet normalize
    (run_report_generation_cxr.py:23-29). PIL's BILINEAR, as torchvision's
    ``Resize`` (PIL's own default is BICUBIC)."""
    from PIL import Image
    w, h = pil_image.size
    if w <= h:
        nw, nh = resize, max(1, round(h * resize / w))
    else:
        nh, nw = resize, max(1, round(w * resize / h))
    im = pil_image.resize((nw, nh), resample=Image.BILINEAR)
    x0 = int(rng.integers(0, nw - crop + 1))
    y0 = int(rng.integers(0, nh - crop + 1))
    im = im.crop((x0, y0, x0 + crop, y0 + crop))
    arr = np.asarray(im, dtype=np.float32) / 255.0
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return imagenet_normalize(arr)


def eval_transform_imagenet(pil_image, size: int = 224) -> np.ndarray:
    """Resize + ImageNet normalize (run_report_generation_cxr.py:30-36)."""
    from PIL import Image
    arr = np.asarray(pil_image.resize((size, size),
                                      resample=Image.BILINEAR),
                     np.float32) / 255.0
    return imagenet_normalize(arr)


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


# verbatim from the reference (run_report_generation_cxr.py:110), with its
# `:-\[` character RANGE (codepoints 58..91: it also strips ; < = > ? @):
# the cleaned text must match for metric parity
_SENT_PUNC_RE = re.compile(r'[.,?;*!%^&_+():-\[\]{}]')


def _clean_sent(t: str) -> str:
    t = (t.replace('"', '').replace('/', '').replace('\\', '')
         .replace("'", '').strip().lower())
    return _SENT_PUNC_RE.sub('', t)


def _numbered(t: str) -> str:
    """Drop the list numbers "1. " .. "5. " as the reference does."""
    return (t.replace('1. ', '').replace('. 2. ', '. ').replace('. 3. ', '. ')
            .replace('. 4. ', '. ').replace('. 5. ', '. ')
            .replace(' 2. ', '. ').replace(' 3. ', '. ')
            .replace(' 4. ', '. ').replace(' 5. ', '. '))


def _join_sents(t: str) -> str:
    sents = t.strip().lower().split('. ')
    tokens = [_clean_sent(s) for s in sents if _clean_sent(s) != '']
    return ' . '.join(tokens) + ' .'


def clean_report_iu_xray(report: str) -> str:
    """run_report_generation_cxr.py:104-113 (verbatim semantics)."""
    t = report
    for _ in range(3):
        t = t.replace('..', '.')
    return _join_sents(_numbered(t))


def clean_report_mimic_cxr(report: str) -> str:
    """run_report_generation_cxr.py:257-270 (verbatim semantics)."""
    t = report.replace('\n', ' ')
    for _ in range(7):
        t = t.replace('__', '_')
    for _ in range(6):
        t = t.replace('  ', ' ')
    for _ in range(8):
        t = t.replace('..', '.')
    return _join_sents(_numbered(t).replace('--', ' -- '))
