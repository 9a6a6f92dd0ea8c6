"""Offline preprocessing of the port (a copy of
``mvlt_tpu/data/preprocess.py`` on the port's ``data/transforms.py``): RGC
pretrain pickles, SLAKE / VQA-RAD image-bank and QA pickles (reference
``preprocess_rgc.py`` / ``preprocess_VQA.py``), and the uint8 image caches.
The same inputs give the same pickles and bytes as JAX's
(``tests/test_torch_preprocess.py``).

Output formats are byte-compatible with what the datasets in
``mvlt_tpu_torch.data.datasets`` (and the reference's run scripts) consume:

- RGC: per-sample ``[im_np, caption, img_id, cap_id]`` pickles + an
  ``{idx: path}`` index per split (preprocess_rgc.py:8-51);
- VQA images: ``(img_id2idx, idx2img_id, img_list_in_np)``
  (preprocess_VQA.py:20-76);
- VQA text: ``(entries, ans2label, label2ans)`` with MICCAI19-MedVQA
  label files joined in, VQA-RAD question cleanup regexes, and
  unanswerables mapped to label None (preprocess_VQA.py:96-305).
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from mvlt_tpu_torch.data.transforms import normalize_image_var


def _load_image(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image
    im = Image.open(path).resize((size, size))
    im = im.convert("RGB")
    im_np = np.asarray(im, np.float32).transpose(2, 0, 1)
    return normalize_image_var(im_np)


def preprocess_rgc(data_root: str, splits=("train", "test"),
                   image_size: int = 224) -> None:
    """RGC_annotation.json -> per-sample pickles (preprocess_rgc.py:8-51).
    Each image is resized, then converted to RGB, as the reference and
    JAX's copy do (:func:`_load_image`)."""
    with open(os.path.join(data_root, "RGC_annotation.json")) as f:
        data = json.load(f)
    for split in splits:
        split_root = os.path.join(data_root, split)
        os.makedirs(split_root, exist_ok=True)
        img_idx2path: Dict[int, str] = {}
        for i, entry in enumerate(data[split]):
            im_np = _load_image(os.path.join(data_root, "images",
                                             entry["image"]), image_size)
            save_path = os.path.join(split_root,
                                     f"{len(img_idx2path)}.pkl")
            with open(save_path, "wb") as f:
                pickle.dump([im_np, entry["caption"], entry["img_id"],
                             entry["cap_id"]], f)
            img_idx2path[i] = save_path
        index_path = os.path.join(split_root, f"{split}_img_idx2path.pkl")
        with open(index_path, "wb") as f:
            pickle.dump(img_idx2path, f)


def build_u8_cache(items, out_dir: str, image_size: int = 224,
                   img_ids=None, cap_ids=None) -> str:
    """Offline decode+resize to a raw-uint8 memmap cache
    (:class:`mvlt_tpu_torch.data.datasets.U8CacheSource`).

    ``items``: sequence of ``(image_path, caption)`` — or
    ``([path_view0, path_view1], caption)`` for two-view sources.  The
    reference's own production layout is offline-preprocessed pickles
    (``preprocess_rgc.py:8-51``); its normalized-f32 payload becomes raw
    uint8 here because normalization runs on device
    (``adapter.device_var_normalize``) — 4x smaller on disk and the
    train-time host path is read + collate only.
    """
    from mvlt_tpu_torch.data.transforms import load_image_u8

    os.makedirs(out_dir, exist_ok=True)
    items = list(items)
    n = len(items)
    first_paths = items[0][0]
    two_view = isinstance(first_paths, (list, tuple))
    v = len(first_paths) if two_view else 1
    shape = ((n, v, image_size, image_size, 3) if two_view
             else (n, image_size, image_size, 3))
    arr = np.memmap(os.path.join(out_dir, "images.u8"), dtype=np.uint8,
                    mode="w+", shape=shape)
    captions = []
    for i, (paths, caption) in enumerate(items):
        if two_view:
            for j, p in enumerate(paths):
                arr[i, j] = load_image_u8(p, image_size)
        else:
            arr[i] = load_image_u8(paths, image_size)
        captions.append(caption)
    arr.flush()
    meta = {"shape": list(shape), "image_size": image_size,
            "captions": captions,
            "img_ids": list(img_ids) if img_ids is not None
            else list(range(n)),
            "cap_ids": list(cap_ids) if cap_ids is not None
            else list(range(n))}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


def preprocess_vqa_images(data_root: str, dataset: str,
                          image_size: int = 224) -> str:
    """SLAKE xmlab<id> dirs / VQA-RAD image folder -> image bank pickle
    (preprocess_VQA.py:20-76)."""
    assert dataset in ("SLAKE", "VQA-RAD")
    data_path = os.path.join(data_root, dataset)
    img_id2idx, idx2img_id, img_list = {}, [], []
    if dataset == "SLAKE":
        img_root = os.path.join(data_path, "imgs")
        for d in sorted(os.listdir(img_root)):
            m = re.search("xmlab", d)
            if not m:
                continue
            img_id = int(d[m.span()[1]:])
            if img_id in img_id2idx:
                continue
            for fn in sorted(os.listdir(os.path.join(img_root, d))):
                if fn.endswith(".jpg"):
                    im = _load_image(os.path.join(img_root, d, fn),
                                     image_size)
                    img_id2idx[img_id] = len(img_id2idx)
                    idx2img_id.append(img_id)
                    img_list.append(im)
                    break
    else:
        img_root = os.path.join(data_path, "VQA_RAD Image Folder")
        for fn in sorted(os.listdir(img_root)):
            if fn in img_id2idx:
                continue
            im = _load_image(os.path.join(img_root, fn), image_size)
            img_id2idx[fn] = len(img_id2idx)
            idx2img_id.append(fn)
            img_list.append(im)
    out = os.path.join(data_root, dataset, dataset + "_image_data.pkl")
    with open(out, "wb") as f:
        pickle.dump((img_id2idx, idx2img_id, img_list), f)
    return out


_RAD_STRIP = ["? -yes/no", "? -open", "? - open"]


def clean_rad_question(question: str) -> str:
    """VQA-RAD question cleanup (preprocess_VQA.py:220-233)."""
    s = question.lower()
    for pat in _RAD_STRIP:
        s = s.replace(pat, "")
    return (s.replace(",", "").replace("?", "").replace("'s", " 's")
            .replace("...", "").replace("x ray", "x-ray").replace(".", ""))


def _entry(question: str, label: Optional[int], img_id,
           answer_type: str) -> dict:
    return {"question": question, "label": label, "img_id": img_id,
            "answer_type": answer_type}


def preprocess_vqa_text(data_root: str, dataset: str) -> str:
    """Join raw QA json with MICCAI19-MedVQA target pickles
    (preprocess_VQA.py:96-305)."""
    data_path = os.path.join(data_root, dataset)
    if dataset == "SLAKE":
        base = os.path.join(data_path, "combine")
        with open(os.path.join(base, "en_ans2label.pkl"), "rb") as f:
            ans2label = pickle.load(f)
        with open(os.path.join(base, "en_label2ans.pkl"), "rb") as f:
            label2ans = pickle.load(f)
        targets = ["en_train_target.pkl", "en_validate_target.pkl",
                   "en_test_target.pkl"]
        jsons = ["question_train.json", "question_validate.json",
                 "question_test.json"]
        split_names = ["train", "validate", "test"]
        entries: Dict[str, List[dict]] = {s: [] for s in split_names}
        for split, jf, tf in zip(split_names, jsons, targets):
            with open(os.path.join(data_path, jf), encoding="utf-8") as f:
                qa_file = json.load(f)
            with open(os.path.join(base, tf), "rb") as f:
                target = pickle.load(f)
            for idx, qa in enumerate(qa_file):
                if qa["q_lang"] == "zh":
                    continue
                assert qa["qid"] == target[idx]["qid"], "not aligned!"
                label = (target[idx]["labels"][0]
                         if target[idx]["labels"] else None)
                entries[split].append(_entry(qa["question"], label,
                                             qa["img_id"],
                                             qa["answer_type"]))
    else:
        cache = os.path.join(data_path, "cache")
        with open(os.path.join(cache, "trainval_ans2label.pkl"), "rb") as f:
            ans2label = pickle.load(f)
        with open(os.path.join(cache, "trainval_label2ans.pkl"), "rb") as f:
            label2ans = pickle.load(f)
        entries = {"train": [], "test": []}
        for split, jf, tf in zip(["train", "test"],
                                 ["trainset.json", "testset.json"],
                                 ["train_target.pkl", "test_target.pkl"]):
            with open(os.path.join(data_path, jf), encoding="utf-8") as f:
                qa_file = json.load(f)
            with open(os.path.join(cache, tf), "rb") as f:
                target = pickle.load(f)
            for idx, qa in enumerate(qa_file):
                assert (qa["qid"] == target[idx]["qid"]
                        and qa["image_name"] == target[idx]["image_name"]), \
                    "not aligned!"
                question = clean_rad_question(qa["question"])
                label = (target[idx]["labels"][0]
                         if target[idx]["labels"] else None)
                entries[split].append(_entry(question, label,
                                             qa["image_name"],
                                             qa["answer_type"]))
    out = os.path.join(data_path, dataset + "_text_data.pkl")
    with open(out, "wb") as f:
        pickle.dump((entries, ans2label, label2ans), f)
    return out
