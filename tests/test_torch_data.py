"""The port's VQA dataset, loader and device prefetch against the JAX
package's: the same samples from the same pickles, the same batch stream
for the same (seed, epoch), and the device prefetch's order, error and
in-flight bounds (which JAX's ``device_prefetch`` does not keep: with two
threads it can raise a producer's error before batch 0, and it can hold
``size + threads`` batches)."""

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from mvlt_tpu.data.datasets import MedVQADataset as JaxVQADataset
from mvlt_tpu.data.loader import DataLoader as JaxLoader
from mvlt_tpu.data.transforms import sample_rng as jax_sample_rng
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu_torch.data.datasets import MedVQADataset
from mvlt_tpu_torch.data.loader import DataLoader, device_prefetch
from mvlt_tpu_torch.data.transforms import sample_rng
from mvlt_tpu_torch.metrics.vqa import vqa_accuracy
from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer

torch.set_num_threads(2)


def _write_pickles(root, dataset="SLAKE", n_img=6, size=16):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(n_img, 3, size, size)).astype(np.float32)
    ids = [100 + 7 * i for i in range(n_img)]          # img ids != rows
    img_id2idx = {k: i for i, k in enumerate(ids)}
    idx2img_id = {i: k for i, k in enumerate(ids)}
    words = ("lung", "heart", "liver")

    def entries(n, seed):
        r = np.random.default_rng(seed)
        return [{"img_id": ids[int(r.integers(0, n_img))],
                 "question": f"Where is the {words[i % 3]} in image {i}?",
                 "label": None if i % 5 == 4 else int(r.integers(0, 3)),
                 "answer_type": "OPEN" if i % 2 else "CLOSED"}
                for i in range(n)]

    text = {"train": entries(13, 1), "validate": entries(5, 2),
            "test": entries(7, 3)}
    ans2label = {w: i for i, w in enumerate(words)}
    label2ans = list(words)
    d = os.path.join(root, dataset)
    os.makedirs(d)
    with open(os.path.join(d, f"{dataset}_image_data.pkl"), "wb") as f:
        pickle.dump((img_id2idx, idx2img_id, images), f)
    with open(os.path.join(d, f"{dataset}_text_data.pkl"), "wb") as f:
        pickle.dump((text, ans2label, label2ans), f)


def _assert_same_sample(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or np.isscalar(a[k]):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("dataset", ["SLAKE", "VQA-RAD"])
def test_vqa_dataset_from_pickles_matches_jax(tmp_path, dataset):
    _write_pickles(str(tmp_path), dataset)
    jt, pt = JaxTokenizer(), WordPieceTokenizer()
    for split in ("train", "validate", "test"):
        a = JaxVQADataset(str(tmp_path), dataset, split)
        b = MedVQADataset(str(tmp_path), dataset, split)
        a.tokenize(jt)
        b.tokenize(pt)
        assert len(a) == len(b) and b.max_len == a.max_len
        assert b.ans2label == a.ans2label and b.label2ans == a.label2ans
        for i in range(len(a)):
            _assert_same_sample(a[i], b[i])
        assert b[4]["label"] == -100


def test_vqa_dataset_from_arrays_matches_jax():
    images = np.random.default_rng(1).normal(
        size=(3, 3, 8, 8)).astype(np.float32)
    entries = lambda: [{"img_id": i % 3, "question": f"is finding {i} here ?",
                        "label": i % 2, "answer_type": "CLOSED"}
                       for i in range(5)]
    a = JaxVQADataset.from_arrays(images, entries(), {"no": 0, "yes": 1},
                                  max_len=6)
    b = MedVQADataset.from_arrays(images, entries(), {"no": 0, "yes": 1},
                                  max_len=6)
    a.tokenize(JaxTokenizer())
    b.tokenize(WordPieceTokenizer())
    assert b.label2ans == a.label2ans
    for i in range(5):
        _assert_same_sample(a[i], b[i])
    # truncated to max_len: [END] cut off, no padding
    assert (b[0]["question"] > 0).all()


def test_sample_rng_matches_jax():
    for args in ((0, 0, 0, 0), (7, 3, 11, 1), (2 ** 33 + 5, 1, 2, 3)):
        np.testing.assert_array_equal(sample_rng(*args).random(8),
                                      jax_sample_rng(*args).random(8))


class _Indexed:
    """A dataset whose samples are their index (and epoch)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        return {"x": np.full((3,), i, np.int32), "e": np.int32(epoch),
                "tag": f"s{i}"}


def _stream(loader, epoch):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in b.items()} for b in loader.epoch(epoch)]


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, seed=7),
    dict(shuffle=True, drop_last=False, seed=3),
    dict(shuffle=False, drop_last=False),
    dict(shuffle=True, drop_last=True, seed=5, process_index=1,
         process_count=3),
])
def test_loader_stream_matches_jax(kw):
    ds = _Indexed(23)
    for epoch in (0, 1):
        want = _stream(JaxLoader(ds, 4, num_workers=0, **kw), epoch)
        got = _stream(DataLoader(ds, 4, num_workers=0, **kw), epoch)
        assert got == want
        procs = _stream(DataLoader(ds, 4, num_workers=2, **kw), epoch)
        assert procs == want
    a = DataLoader(ds, 4, num_workers=0, **kw)
    b = JaxLoader(ds, 4, num_workers=0, **kw)
    assert a.batches_per_epoch() == b.batches_per_epoch()


def test_loader_shards_are_equal_and_disjoint():
    ds = _Indexed(15)
    shards = [DataLoader(ds, 2, shuffle=True, seed=1, process_index=p,
                         process_count=2)._indices(0) for p in range(2)]
    assert len(shards[0]) == len(shards[1]) == 7
    assert not set(shards[0].tolist()) & set(shards[1].tolist())


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_abandoned_epoch_does_not_leak(workers):
    before = threading.active_count()
    dl = DataLoader(_Indexed(64), batch_size=4, prefetch=1, num_threads=2,
                    num_workers=workers)
    for n, _ in enumerate(dl.epoch(0)):
        if n == 1:
            break
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_sample_error_reaches_the_consumer(workers):
    class Bad(_Indexed):
        def __getitem__(self, i, epoch=0):
            if i == 9:
                raise KeyError("sample 9")
            return super().__getitem__(i, epoch)

    got = []
    with pytest.raises(KeyError, match="sample 9"):
        for b in DataLoader(Bad(16), 4, num_workers=workers).epoch(0):
            got.append(b["x"][:, 0].tolist())
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7]]


def _jittered(n, raise_at=None, pulls=None):
    for i in range(n):
        if raise_at == i:
            raise RuntimeError(f"producer failed at {i}")
        time.sleep(0.002 if i % 3 else 0.006)
        if pulls is not None:
            pulls.append(i)
        yield {"i": np.full((2,), i, np.int32), "name": f"b{i}"}


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_device_prefetch_keeps_order(threads):
    got = []
    for b in device_prefetch(_jittered(17), size=3, device="cpu",
                             threads=threads):
        assert isinstance(b["i"], torch.Tensor) and b["i"].device.type == "cpu"
        assert b["name"] == f"b{int(b['i'][0])}"
        got.append(int(b["i"][0]))
    assert got == list(range(17))


def test_device_prefetch_raises_after_every_earlier_batch():
    """The race of JAX's device_prefetch (ROADMAP.md C): the source's
    error comes after 3 batches; with two threads it must reach the
    consumer after those 3, in every one of 200 repeats."""
    for rep in range(200):
        got = []
        with pytest.raises(RuntimeError, match="failed at 3"):
            for b in device_prefetch(_jittered(6, raise_at=3), size=2,
                                     device="cpu", threads=2):
                got.append(int(b["i"][0]))
        assert got == [0, 1, 2], (rep, got)


def test_device_prefetch_copy_error_keeps_its_place():
    """An error in the copy of batch 2 (the transform) is raised after
    batches 0 and 1."""
    def transform(b):
        if int(b["i"][0]) == 2:
            raise ValueError("bad batch 2")
        return b

    for threads in (1, 3):
        got = []
        with pytest.raises(ValueError, match="bad batch 2"):
            for b in device_prefetch(_jittered(8), size=3, device="cpu",
                                     transform=transform, threads=threads):
                got.append(int(b["i"][0]))
        assert got == [0, 1]


@pytest.mark.parametrize("threads", [1, 4])
def test_device_prefetch_bounds_batches_in_flight(threads):
    """A slow consumer: at every pull from the source, the batches taken
    and not yet yielded (held by producers, queued or resequenced) are at
    most ``size``."""
    pulls, yielded, worst = [], [0], [0]

    def source():
        for b in _jittered(20, pulls=pulls):
            worst[0] = max(worst[0], len(pulls) - yielded[0])
            yield b

    size = 2
    for _ in device_prefetch(source(), size=size, device="cpu",
                             threads=threads):
        yielded[0] += 1
        time.sleep(0.01)
    assert yielded[0] == 20
    assert 1 <= worst[0] <= size, worst[0]


def test_device_prefetch_abandoned_does_not_leak():
    before = threading.active_count()
    it = device_prefetch(_jittered(50), size=2, device="cpu", threads=3)
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_device_prefetch_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_prefetch(iter([]), device="cuda")


def test_vqa_accuracy_matches_jax():
    from mvlt_tpu.metrics.vqa import vqa_accuracy as jax_acc
    rng = np.random.default_rng(4)
    preds = rng.integers(0, 5, 50)
    labels = rng.integers(0, 5, 50)
    labels[::7] = -100
    types = ["open" if i % 3 else "CLOSED" for i in range(50)]
    assert vqa_accuracy(preds, labels, types) == jax_acc(preds, labels, types)
    assert vqa_accuracy(preds, labels) == jax_acc(preds, labels)
    assert vqa_accuracy([], []) == jax_acc([], [])
