"""Task datasets of the port over the reference's on-disk formats: a copy
of ``mvlt_tpu/data/datasets.py``'s :class:`MedVQADataset`
(``datasets.py:366-418``). The pretrain, retrieval and caption datasets
come with their drivers (ROADMAP.md queue A, "Host modules").

VQA pickles (``run_vqa.py:17-72``): an image bank ``(img_id2idx,
idx2img_id, img_list_in_np)`` in ``<root>/<dataset>/<dataset>_image_data.pkl``
(images already variance-normalized, (3, 224, 224) float) and the text
``(entries, ans2label, label2ans)`` in ``<dataset>_text_data.pkl``, where
``entries[split]`` is a list of dicts with ``img_id``, ``question``,
``label`` (None: unanswerable) and ``answer_type`` (OPEN / CLOSED).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np


# questions a split of the English SLAKE release (Liu et al., 2021): the
# lengths a synthetic SLAKE takes where a run's pace is measured
SLAKE_SPLITS = {"train": 4919, "validate": 1053, "test": 1061}


class MedVQADataset:
    """SLAKE / VQA-RAD pickles (run_vqa.py:17-72)."""

    MAX_LEN = {"SLAKE": 23, "VQA-RAD": 30}

    def __init__(self, root: str, dataset: str, split: str):
        assert dataset in ("SLAKE", "VQA-RAD")
        self.dataset = dataset
        image_path = os.path.join(root, dataset, dataset + "_image_data.pkl")
        text_path = os.path.join(root, dataset, dataset + "_text_data.pkl")
        with open(image_path, "rb") as f:
            self.img_id2idx, self.idx2img_id, self.img_list_in_np = pickle.load(f)
        with open(text_path, "rb") as f:
            entries, self.ans2label, self.label2ans = pickle.load(f)
        self.entries = entries[split]
        self.max_len = self.MAX_LEN[dataset]

    @classmethod
    def from_arrays(cls, images: np.ndarray, entries: List[dict],
                    ans2label: dict, max_len: int = 23) -> "MedVQADataset":
        """Synthetic/test constructor bypassing pickles."""
        self = cls.__new__(cls)
        self.dataset = "SLAKE"
        self.img_list_in_np = images
        self.img_id2idx = {i: i for i in range(len(images))}
        self.idx2img_id = {i: i for i in range(len(images))}
        self.entries = entries
        self.ans2label = ans2label
        self.label2ans = {v: k for k, v in ans2label.items()}
        self.max_len = max_len
        return self

    def __len__(self):
        return len(self.entries)

    def tokenize(self, tokenizer):
        """Append [END], convert, zero-pad to max_len (run_vqa.py:56-72)."""
        assert tokenizer.eos_token == "[END]"
        for entry in self.entries:
            ids = tokenizer.convert_tokens_to_ids(
                tokenizer.tokenize(entry["question"] + " [END]"))
            q = np.zeros(self.max_len, np.int32)
            n = min(len(ids), self.max_len)
            q[:n] = np.asarray(ids[:n], np.int32)
            entry["q_ids"] = q

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        e = self.entries[index]
        v = self.img_list_in_np[self.img_id2idx[e["img_id"]]]
        label = -100 if e["label"] is None else e["label"]
        return {"image": np.asarray(v, np.float32), "question": e["q_ids"],
                "label": np.int32(label),
                "answer_type": e.get("answer_type", "")}


def write_synthetic_vqa(root: str, dataset: str = "SLAKE", images: int = 64,
                        answers: int = 224, splits=None, image_size: int = 224,
                        seed: int = 0) -> str:
    """Write a synthetic VQA dataset in the pickle layout above under
    ``root`` (for smoke runs and profiles of the driver: ``MedVQADataset(
    root, dataset, split)`` reads it). Images are normal draws from
    ``numpy.random.default_rng(seed)``, (3, image_size, image_size) f32,
    variance-normalized per channel as ``preprocess_data.py`` stores them
    ((x - mean) / var); image ids are not row numbers; each question names
    an organ and a finding, its answer one of ``answers`` labels, OPEN and
    CLOSED alternating. ``splits`` maps split names to question counts
    (default: SLAKE's three splits of 320 / 100 / 100). Returns ``root``."""
    splits = splits or {"train": 320, "validate": 100, "test": 100}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(images, 3, image_size, image_size)).astype(np.float32)
    mean = x.mean(axis=(-2, -1), keepdims=True)
    var = x.var(axis=(-2, -1), keepdims=True)
    bank = ((x - mean) / var).astype(np.float32)
    ids = [1000 + 3 * i for i in range(images)]
    organs = ("lung", "liver", "heart", "brain", "kidney", "colon")
    findings = ("nodule", "mass", "effusion", "lesion", "opacity")
    text = {}
    for name, n in splits.items():
        entries = []
        for i in range(n):
            o, f = rng.integers(len(organs)), rng.integers(len(findings))
            entries.append({
                "img_id": ids[int(rng.integers(images))],
                "question": f"is there a {findings[f]} in the {organs[o]} "
                            f"of this image ?",
                "label": int(rng.integers(answers)),
                "answer_type": "OPEN" if i % 2 else "CLOSED"})
        text[name] = entries
    ans2label = {f"answer {k}": k for k in range(answers)}
    label2ans = list(ans2label)
    d = os.path.join(root, dataset)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, dataset + "_image_data.pkl"), "wb") as f:
        pickle.dump(({k: i for i, k in enumerate(ids)},
                     {i: k for i, k in enumerate(ids)}, bank), f, protocol=4)
    with open(os.path.join(d, dataset + "_text_data.pkl"), "wb") as f:
        pickle.dump((text, ans2label, label2ans), f, protocol=4)
    return root
