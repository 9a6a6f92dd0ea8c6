"""Task datasets of the port over the reference's on-disk formats: a copy
of ``mvlt_tpu/data/datasets.py``: the pretrain sources and
:class:`PretrainDataset` (``datasets.py:37-364``), :class:`MedVQADataset`
(``:366-418``), the report generation datasets :class:`CaptionDataset` and
:class:`CXRAnnotationDataset` (``:421-509``) and the retrieval dataset
:class:`RetrievalDataset` (``:512-566``) with its IU X-Ray source
:class:`AnnotationSource` (``:219-254``).

Every dataset is index-addressable and draws from a per-sample
``np.random.Generator`` keyed by (seed, epoch, index)
(:func:`~mvlt_tpu_torch.data.transforms.sample_rng`), so that its samples
are bitwise JAX's for the same source.

Pretrain sources yield ``(image, caption, img_id, cap_id)``:

- :class:`PickleSource`: RGC per-sample pickles ``[im_np, caption, img_id,
  cap_id]`` behind an ``{idx: path}`` index (``preprocess_rgc.py:44-50``);
  ``im_np`` is (3, H, W) f32, variance-normalized offline;
- :class:`ImageFolderSource`: (path, caption) pairs decoded per sample:
  ROCO (``<root>/<split>/radiology/{images,captions.txt}``, scanned once
  into ``ROCO.json``) and MedICaT (``medicat.json``); with ``normalize =
  "device"`` a (H, W, 3) uint8 frame that the model normalizes on the card,
  with ``"host"`` the f32 (3, H, W) of the reference's numpy chain;
- :class:`U8CacheSource`: a raw uint8 memmap ``images.u8`` (N, H, W, 3)
  and ``meta.json`` (captions, ids, shape);
- :class:`AnnotationSource`: the studies of one split of an R2Gen-style
  ``annotation.json`` (IU X-Ray: two views a study, stacked (2, ...));
- :class:`SyntheticSource` and :class:`ConcatSource`.

IU X-Ray / MIMIC-CXR (``run_report_generation_cxr.py:79-270``): an image
directory and ``annotation.json`` ``{"train" | "val" | "test": [{"id",
"report", "image_path": [view, ...], "split"}]}``;
:func:`write_synthetic_iu_xray` writes a seeded one.

VQA pickles (``run_vqa.py:17-72``): an image bank ``(img_id2idx,
idx2img_id, img_list_in_np)`` in ``<root>/<dataset>/<dataset>_image_data.pkl``
(images already variance-normalized, (3, 224, 224) float) and the text
``(entries, ans2label, label2ans)`` in ``<dataset>_text_data.pkl``, where
``entries[split]`` is a list of dicts with ``img_id``, ``question``,
``label`` (None: unanswerable) and ``answer_type`` (OPEN / CLOSED).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mvlt_tpu_torch.data import transforms as T


# ---------------------------------------------------------------------------
# pretrain sample sources (image, caption, img_id, cap_id)
# ---------------------------------------------------------------------------

class PickleSource:
    """RGC-style per-sample pickles behind an ``{idx: path}`` index
    (run_pretrain.py:16-37). The files are the dataset's own, written by
    its preprocessing; unpickle only files of a trusted source."""

    def __init__(self, index_path: str):
        with open(index_path, "rb") as f:
            self.idx2path = pickle.load(f)
        self._cache: Optional[list] = None
        self._peek_cache: dict = {}

    def __len__(self):
        return len(self.idx2path)

    def cache_in_memory(self):
        """run_pretrain.py save_data_in_cache (35-59)."""
        self._cache = [self._load(i) for i in range(len(self))]

    def _load(self, index: int):
        with open(self.idx2path[index], "rb") as f:
            im_np, caption, img_id, cap_id = pickle.load(f)
        return np.asarray(im_np, np.float32), caption, img_id, cap_id

    def __getitem__(self, index: int):
        if self._cache is not None:
            return self._cache[index]
        return self._load(index)

    def peek(self, index: int):
        """(caption, cap_id) — per-index caption cache so repeated
        negative-sampling probes don't re-unpickle the image payload."""
        if self._cache is not None:
            _, caption, _, cap_id = self._cache[index]
            return caption, cap_id
        hit = self._peek_cache.get(index)
        if hit is None:
            _, caption, _, cap_id = self._load(index)
            hit = self._peek_cache[index] = (caption, cap_id)
        return hit


class ImageFolderSource:
    """(path, caption) pairs decoded + variance-normalized on the fly
    (ROCO / MedICaT pattern, run_pretrain_rgc_roco_medicat.py:99-129).
    ``normalize``: "host" gives the f32 (3, H, W) of the reference's numpy
    chain; "device" the (H, W, 3) uint8 frame, normalized by the model
    (``adapter.device_var_normalize``)."""

    def __init__(self, items: Sequence[Tuple[str, str]], image_size: int = 224,
                 fast_decode: bool = False, normalize: str = "host"):
        self.items = list(items)
        self.image_size = image_size
        self.fast_decode = fast_decode
        self.normalize = normalize

    @staticmethod
    def from_roco(root: str, split: str = "train") -> "ImageFolderSource":
        """Scan ``<root>/<split>/radiology/captions.txt`` with a json cache
        and image-exists check (run_pretrain_rgc_roco_medicat.py:34-77)."""
        base = os.path.join(root, split, "radiology")
        cache = os.path.join(base, "ROCO.json")
        if os.path.exists(cache):
            with open(cache) as f:
                items = [tuple(x) for x in json.load(f)]
            return ImageFolderSource(items)
        items = []
        skipped = 0
        with open(os.path.join(base, "captions.txt")) as f:
            for line in f:
                parts = line.strip().split("\t", 1)
                if len(parts) != 2:
                    continue
                name, caption = parts
                path = os.path.join(base, "images", name + ".jpg")
                # validity check with logged skip — the reference's only
                # fault tolerance (run_pretrain_rgc_roco_medicat.py:58-62)
                if os.path.exists(path):
                    items.append((path, caption))
                else:
                    skipped += 1
        if skipped:
            logging.getLogger("mvlt.data").warning(
                "ROCO scan: skipped %d entries with missing images", skipped)
        with open(cache, "w") as f:
            json.dump(items, f)
        return ImageFolderSource(items)

    @staticmethod
    def from_medicat(root: str) -> "ImageFolderSource":
        with open(os.path.join(root, "medicat.json")) as f:
            data = json.load(f)
        items = [(os.path.join(root, "figures",
                               d["pdf_hash"] + "_" + d["fig_uri"]),
                  d["s2_caption"]) for d in data]
        return ImageFolderSource(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        path, caption = self.items[index]
        load = (T.load_image_u8 if self.normalize == "device"
                else T.load_image_var_normalized)
        im = load(path, self.image_size, fast=self.fast_decode)
        return im, caption, index, (path, caption[:64])

    def peek(self, index: int):
        """(caption, cap_id) WITHOUT decoding the image — negative
        sampling probes captions only (see ``PretrainDataset``)."""
        path, caption = self.items[index]
        return caption, (path, caption[:64])


class U8CacheSource:
    """Preprocessed raw-uint8 image cache: one memory-mapped ``images.u8``
    array of shape (N, H, W, 3) — or (N, V, H, W, 3) for two-view — plus a
    ``meta.json`` sidecar with captions / ids / the shape
    (:func:`write_u8_cache`). The model normalizes the frames on the card,
    so a sample costs a memmap read and a quarter of the f32 bytes."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            meta = json.load(f)
        self.captions: List[str] = meta["captions"]
        self.img_ids = meta["img_ids"]
        self.cap_ids = meta["cap_ids"]
        shape = tuple(meta["shape"])
        self.images = np.memmap(os.path.join(cache_dir, "images.u8"),
                                dtype=np.uint8, mode="r", shape=shape)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, index: int):
        # np.asarray: a plain view; the stack in collate makes the copy
        return (np.asarray(self.images[index]), self.captions[index],
                self.img_ids[index], self.cap_ids[index])

    def peek(self, index: int):
        return self.captions[index], self.cap_ids[index]


_WORDS = ["lung", "heart", "normal", "opacity", "pleural", "effusion",
          "chest", "left", "right", "mild"]


class SyntheticSource:
    """Deterministic fake source for tests and smoke runs: (3, size, size)
    f32 normal draws keyed by (seed, index), captions of 5-8 words."""

    def __init__(self, n: int = 16, image_size: int = 32, seed: int = 0,
                 captions: Optional[List[str]] = None):
        self.n = n
        self.image_size = image_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.captions = captions or [
            " ".join(rng.choice(_WORDS, size=5 + i % 4)) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 10007 + index)
        im = rng.normal(size=(3, self.image_size, self.image_size)
                        ).astype(np.float32)
        return im, self.captions[index], index, index

    def peek(self, index: int):
        return self.captions[index], index


class AnnotationSource:
    """(image, report) source over an R2Gen-style annotation.json + image
    dir — feeds :class:`RetrievalDataset` for the IU X-Ray retrieval
    variant (reference ``run_retrieval_iuxray.py:18-179``; two-view images,
    negatives always swap the image). ``cap_id`` is the study id."""

    def __init__(self, image_dir: str, ann_path: str, split: str = "train",
                 two_view: bool = True, image_size: int = 224,
                 normalize: str = "host"):
        self.image_dir = image_dir
        self.two_view = two_view
        self.image_size = image_size
        self.normalize = normalize
        with open(ann_path) as f:
            self.examples = json.load(f)[split]

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, index: int):
        e = self.examples[index]
        paths = e["image_path"][:2 if self.two_view else 1]
        load = (T.load_image_u8 if self.normalize == "device"
                else T.load_image_var_normalized)
        views = [load(os.path.join(self.image_dir, p), self.image_size)
                 for p in paths]
        im = np.stack(views, 0) if self.two_view else views[0]
        return im, e["report"], e["id"], e["id"]

    def peek(self, index: int):
        e = self.examples[index]
        return e["report"], e["id"]


class ConcatSource:
    """Index-range dispatch over multiple sources
    (run_pretrain_rgc_roco_medicat.py:94-129)."""

    def __init__(self, *sources):
        self.sources = sources
        self.offsets = np.cumsum([0] + [len(s) for s in sources])

    def _locate(self, index: int):
        i = int(np.searchsorted(self.offsets, index, side="right")) - 1
        return i, index - int(self.offsets[i])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index: int):
        i, j = self._locate(index)
        im, cap, _, cap_id = self.sources[i][j]
        return im, cap, index, (i, cap_id)

    def peek(self, index: int):
        i, j = self._locate(index)
        cap, cap_id = _peek(self.sources[i], j)
        return cap, (i, cap_id)


def _peek(source, index: int):
    """(caption, cap_id) as cheaply as the source allows: ``peek`` skips
    the image decode entirely where available; otherwise fall back to a
    full fetch."""
    fn = getattr(source, "peek", None)
    if fn is not None:
        return fn(index)
    _, cap, _, cap_id = source[index]
    return cap, cap_id


class PretrainDataset:
    """MLM+ITM pretraining samples (run_pretrain*.py): ``{"image",
    "caption_masked", "caption_label", "itm_label"}``.

    Semantics of the multi-source variant: on the ITM=0 branch the
    *caption string* is replaced before tokenization
    (run_pretrain_rgc_roco_medicat.py:149-156); the RGC-only script's bug
    that re-tokenizes the original caption (run_pretrain.py:103-105) is not
    reproduced. The ITM branch is decided before any image is decoded:
    negatives are probed through ``peek`` (captions only), and exactly one
    image is decoded per sample, in JAX's draw order."""

    def __init__(self, source, tokenizer, max_length: int = 150,
                 mlm_task: bool = True, itm_task: bool = True, seed: int = 0):
        self.source = source
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.mlm_task = mlm_task
        self.itm_task = itm_task
        self.seed = seed
        self._vocab_words = list(tokenizer.vocab.keys())

    def __len__(self):
        return len(self.source)

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = T.sample_rng(self.seed, epoch, index)
        caption, cap_id = _peek(self.source, index)
        itm_label = 1
        image_index = index
        if self.itm_task and rng.random() >= 0.5:
            itm_label = 0
            # bounded rejection sampling (the reference's while True,
            # run_pretrain.py:90-93): a degenerate source where no valid
            # negative exists must error, not hang the loader
            for _try in range(1000):
                rand_index = int(rng.integers(0, len(self)))
                r_cap, r_cap_id = _peek(self.source, rand_index)
                if rand_index != index and cap_id != r_cap_id:
                    break
            else:
                raise ValueError(
                    "ITM negative sampling found no sample with a "
                    "different cap_id in 1000 draws — the source is too "
                    "small or degenerate for itm_task=True")
            if rng.random() < 0.5:
                image_index = rand_index
            else:
                caption = r_cap
        im_np = self.source[image_index][0]

        tokens = self.tokenizer.tokenize(caption + " " + self.tokenizer.eos_token)
        if self.mlm_task and itm_label == 1:
            tokens, mlm_labels = T.random_mask_word(
                tokens, self.tokenizer.vocab, rng, self._vocab_words)
        else:
            mlm_labels = None
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        cap_ids, labels = T.pad_truncate_preserve_end(ids, self.max_length,
                                                      mlm_labels)
        return {"image": im_np, "caption_masked": cap_ids,
                "caption_label": labels,
                "itm_label": np.int32(itm_label)}


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


class CaptionDataset:
    """RGC report generation (run_report_generation.py:22-176): ``{"image",
    "caption", "mlm_labels", "image_id", "raw_caption"}``. On the train
    split, 'unilm' masks words (``random_mask_word``) and labels the masked
    ones; 'normal' labels every token; on the other splits the labels are
    all -100."""

    def __init__(self, source, tokenizer, max_length: int = 100,
                 split: str = "train", seed: int = 0,
                 learning_strategy: str = "unilm"):
        self.source = source
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.split = split
        self.seed = seed
        self.learning_strategy = learning_strategy
        self._vocab_words = list(tokenizer.vocab.keys())

    def __len__(self):
        return len(self.source)

    def _encode(self, caption: str, rng) -> Tuple[np.ndarray, np.ndarray]:
        tokens = self.tokenizer.tokenize(caption + " " +
                                         self.tokenizer.eos_token)
        if self.split == "train" and self.learning_strategy == "unilm":
            tokens, mlm_labels = T.random_mask_word(
                tokens, self.tokenizer.vocab, rng, self._vocab_words)
        elif self.split == "train":
            # 'normal' strategy: labels are the full token ids
            # (run_report_generation_cxr.py:229-230)
            mlm_labels = self.tokenizer.convert_tokens_to_ids(tokens)
        else:
            mlm_labels = None
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        return T.pad_truncate_preserve_end(ids, self.max_length, mlm_labels)

    def __getitem__(self, index: int, epoch: int = 0) -> Dict:
        rng = T.sample_rng(self.seed, epoch, index)
        im_np, caption, img_id, _ = self.source[index]
        cap_ids, labels = self._encode(caption, rng)
        return {"image": im_np, "caption": cap_ids, "mlm_labels": labels,
                "image_id": img_id, "raw_caption": caption}


class CXRAnnotationDataset(CaptionDataset):
    """IU X-Ray (two-view: image (2, ...)) / MIMIC-CXR (single-view) over
    annotation.json (run_report_generation_cxr.py:79-270); reports cleaned
    by ``clean_report_iu_xray`` / ``clean_report_mimic_cxr``.

    Images: with ``pretrained`` the reference's variance-normalized f32
    (3, H, W), or with ``normalize="device"`` the uint8 (H, W, 3) frame
    normalized on the device; without, the ImageNet transforms (train:
    resize the shorter side to ``image_size * 8 // 7``, random crop of
    ``image_size`` and flip; other splits: resize). ``image_size`` (224, as
    in JAX, where it is fixed) is an addition that lets a tiny model read
    the same tree."""

    def __init__(self, image_dir: str, ann_path: str, tokenizer,
                 split: str = "train", two_view: bool = True,
                 max_length: int = 80, pretrained: bool = True, seed: int = 0,
                 learning_strategy: str = "unilm", normalize: str = "host",
                 image_size: int = 224):
        self.image_dir = image_dir
        self.two_view = two_view
        self.pretrained = pretrained
        self.normalize = normalize
        self.image_size = image_size
        clean = T.clean_report_iu_xray if two_view else T.clean_report_mimic_cxr
        with open(ann_path) as f:
            ann = json.load(f)
        self.examples = ann[split]
        for e in self.examples:
            e["report"] = clean(e["report"]).lower()
        super().__init__(self.examples, tokenizer, max_length, split, seed,
                         learning_strategy)

    def __len__(self):
        return len(self.examples)

    def _load_view(self, rel_path: str, rng) -> np.ndarray:
        from PIL import Image
        path = os.path.join(self.image_dir, rel_path)
        size = self.image_size
        if self.pretrained:
            if self.normalize == "device":
                return T.load_image_u8(path, size)
            return T.load_image_var_normalized(path, size)
        im = Image.open(path).convert("RGB")
        if self.split == "train":
            return T.train_augment_imagenet(im, rng, resize=size * 8 // 7,
                                            crop=size)
        return T.eval_transform_imagenet(im, size)

    def __getitem__(self, index: int, epoch: int = 0) -> Dict:
        rng = T.sample_rng(self.seed, epoch, index)
        e = self.examples[index]
        paths = e["image_path"]
        if self.two_view:
            image = np.stack([self._load_view(paths[0], rng),
                              self._load_view(paths[1], rng)], 0)
        else:
            image = self._load_view(paths[0], rng)
        cap_ids, labels = self._encode(e["report"], rng)
        return {"image": image, "caption": cap_ids, "mlm_labels": labels,
                "image_id": e["id"], "raw_caption": e["report"]}


class RetrievalDataset:
    """Train: ``{"pos", "neg"}`` pairs of ``{"image", "caption", "label"}``;
    test: the virtual N x N cross-product, item ``i * N + j`` image i with
    caption j (run_retrieval.py:18-145). ``swap`` picks the negative:
    'either' flips a coin between replacing the image and the caption
    (run_retrieval.py:104-111); 'image' always swaps the image
    (run_retrieval_iuxray.py:130-137). A negative is a sample of another
    ``cap_id``, drawn at most 1,000 times."""

    def __init__(self, source, tokenizer, max_length: int = 80,
                 split: str = "train", seed: int = 0, swap: str = "either"):
        self.source = source
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.split = split
        self.seed = seed
        self.swap = swap
        self.img_num = len(source)

    def __len__(self):
        return self.img_num if self.split == "train" else self.img_num ** 2

    def _cap_ids(self, caption: str) -> np.ndarray:
        ids = self.tokenizer.convert_tokens_to_ids(
            self.tokenizer.tokenize(caption + " " + self.tokenizer.eos_token))
        out, _ = T.pad_truncate_preserve_end(ids, self.max_length)
        return out

    def __getitem__(self, index: int, epoch: int = 0) -> Dict:
        if self.split == "train":
            rng = T.sample_rng(self.seed, epoch, index)
            cap_gt, cap_id = _peek(self.source, index)
            for _try in range(1000):
                rand_index = int(rng.integers(0, self.img_num))
                r_cap, r_cap_id = _peek(self.source, rand_index)
                if rand_index != index and cap_id != r_cap_id:
                    break
            else:
                raise ValueError(
                    "retrieval negative sampling found no sample with a "
                    "different cap_id in 1000 draws — source too small")
            im_gt = self.source[index][0]
            if self.swap == "image" or rng.random() < 0.5:
                # the negative image is decoded only when the image swaps
                im_neg, cap_neg = self.source[rand_index][0], cap_gt
            else:
                im_neg, cap_neg = im_gt, r_cap
            return {"pos": {"image": im_gt, "caption": self._cap_ids(cap_gt),
                            "label": np.int32(1)},
                    "neg": {"image": im_neg, "caption": self._cap_ids(cap_neg),
                            "label": np.int32(0)}}
        img_idx, cap_idx = divmod(index, self.img_num)
        im1, _, _, cap_id1 = self.source[img_idx]
        cap2, cap_id2 = _peek(self.source, cap_idx)
        label = 1 if img_idx == cap_idx or cap_id1 == cap_id2 else 0
        return {"image": im1, "caption": self._cap_ids(cap2),
                "label": np.int32(label)}


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


def write_u8_cache(out_dir: str, frames: np.ndarray, captions: Sequence[str],
                   img_ids=None, cap_ids=None) -> str:
    """Write ``frames`` ((N, H, W, 3) uint8) and their captions as a
    :class:`U8CacheSource` directory (``images.u8`` + ``meta.json``, the
    layout of JAX's ``preprocess.build_u8_cache``). Returns ``out_dir``."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n = len(frames)
    os.makedirs(out_dir, exist_ok=True)
    frames.tofile(os.path.join(out_dir, "images.u8"))
    meta = {"shape": list(frames.shape), "image_size": int(frames.shape[-2]),
            "captions": list(captions),
            "img_ids": list(img_ids) if img_ids is not None else list(range(n)),
            "cap_ids": list(cap_ids) if cap_ids is not None else list(range(n))}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


def synthetic_pretrain_frames(n: int, image_size: int = 224, seed: int = 0):
    """(frames, captions) of a synthetic pretrain corpus: ``n`` uint8 (H,
    W, 3) frames drawn from ``numpy.random.default_rng(seed)`` (a smooth
    gradient plus noise, so that channels differ in mean and variance) and
    one caption of 6-12 words each, no two alike."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, image_size, dtype=np.float32)
    frames = np.empty((n, image_size, image_size, 3), np.uint8)
    for i in range(n):
        base = rng.uniform(40, 200, size=3).astype(np.float32)
        tilt = rng.uniform(-40, 40, size=3).astype(np.float32)
        noise = rng.normal(0, 25, size=(image_size, image_size, 3))
        x = base + tilt * ramp[:, None, None] + noise
        frames[i] = np.clip(x, 0, 255).astype(np.uint8)
    captions = [f"case {i} " + " ".join(rng.choice(_WORDS, size=5 + i % 7))
                for i in range(n)]
    return frames, captions


def write_synthetic_pretrain(root: str, n: int = 64, image_size: int = 224,
                             seed: int = 0, roco: bool = True
                             ) -> Dict[str, str]:
    """Write one synthetic pretrain corpus (:func:`synthetic_pretrain_frames`)
    under ``root`` in the driver's source layouts, for smoke runs and
    profiles of ``python -m mvlt_tpu_torch.run_pretrain``:

    - ``rgc``: RGC per-sample pickles ``[im_np, caption, img_id, cap_id]``
      with the f32 (3, H, W) variance-normalized frame
      (``preprocess_rgc.py:44-50``) and ``train_img_idx2path.pkl``;
    - ``u8``: a :class:`U8CacheSource` directory of the raw frames;
    - ``roco`` (needs Pillow; left out with ``roco=False``): a ROCO split,
      ``train/radiology/{captions.txt, images/<name>.jpg}``, the frames
      stored losslessly (PNG data under ROCO's ``.jpg`` names).

    Returns ``{"rgc_index", "u8_cache", "roco_root"}`` (no ``roco_root``
    with ``roco=False``)."""
    frames, captions = synthetic_pretrain_frames(n, image_size, seed)
    rgc = os.path.join(root, "rgc", "train")
    os.makedirs(rgc, exist_ok=True)
    index = {}
    for i in range(n):
        path = os.path.join(rgc, f"{i}.pkl")
        im = T.normalize_image_var(frames[i].transpose(2, 0, 1))
        with open(path, "wb") as f:
            pickle.dump([im, captions[i], i, i], f, protocol=4)
        index[i] = path
    out = {"rgc_index": os.path.join(rgc, "train_img_idx2path.pkl"),
           "u8_cache": write_u8_cache(os.path.join(root, "u8"), frames,
                                      captions)}
    with open(out["rgc_index"], "wb") as f:
        pickle.dump(index, f, protocol=4)
    if not roco:
        return out
    from PIL import Image
    base = os.path.join(root, "roco", "train", "radiology")
    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    with open(os.path.join(base, "captions.txt"), "w") as f:
        for i in range(n):
            name = f"ROCO_{i:05d}"
            Image.fromarray(frames[i]).save(
                os.path.join(base, "images", name + ".jpg"), format="PNG")
            f.write(f"{name}\t{captions[i]}\n")
    out["roco_root"] = os.path.join(root, "roco")
    return out


_FINDINGS = ("the heart is normal in size", "the mediastinum is unremarkable",
             "the lungs are clear", "no pleural effusion",
             "no pneumothorax", "mild cardiomegaly",
             "there is a small left pleural effusion",
             "right lower lobe opacity", "degenerative changes of the spine",
             "no acute cardiopulmonary abnormality")


def write_synthetic_iu_xray(root: str, splits=None, image_size: int = 256,
                            views: int = 2, seed: int = 0) -> str:
    """Write a seeded IU X-Ray tree under ``root`` for smoke runs and tests
    of the caption and retrieval drivers: ``images/<id>/<v>.png`` (``views``
    grayscale frames of ``image_size`` a study, a gradient plus noise) and
    ``annotation.json`` with R2Gen's layout (``{"train" | "val" | "test":
    [{"id", "report", "image_path", "split"}]}``). ``splits`` maps the
    splits to study counts (default 96 / 16 / 32). Reports are 3-6 findings
    as a radiologist writes them ("1. ", double periods, "/"), so that the
    cleaning runs. ``views=1`` gives a MIMIC-CXR-shaped tree. Needs Pillow.
    Returns ``root``."""
    from PIL import Image
    splits = splits or {"train": 96, "val": 16, "test": 32}
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, image_size, dtype=np.float32)
    ann, n = {}, 0
    for split, count in splits.items():
        entries = []
        for _ in range(count):
            sid = f"CXR{1000 + n}_IM-{seed:02d}{n:04d}"
            n += 1
            os.makedirs(os.path.join(root, "images", sid), exist_ok=True)
            paths = []
            for v in range(views):
                base, tilt = rng.uniform(60, 180), rng.uniform(-50, 50)
                x = (base + tilt * ramp[:, None]
                     + rng.normal(0, 20, (image_size, image_size)))
                rel = f"{sid}/{v}.png"
                Image.fromarray(np.clip(x, 0, 255).astype(np.uint8)).save(
                    os.path.join(root, "images", rel))
                paths.append(rel)
            picks = rng.choice(len(_FINDINGS), size=int(rng.integers(3, 7)),
                               replace=False)
            sents = [_FINDINGS[int(i)].capitalize() for i in picks]
            report = " ".join(f"{k + 1}. {t}.." if k % 3 == 0 else
                              f"{t}/ ." if k % 3 == 1 else f"{t}."
                              for k, t in enumerate(sents))
            entries.append({"id": sid, "report": report,
                            "image_path": paths, "split": split})
        ann[split] = entries
    with open(os.path.join(root, "annotation.json"), "w") as f:
        json.dump(ann, f)
    return root
