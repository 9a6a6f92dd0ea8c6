"""The port's offline preprocessing (``mvlt_tpu_torch/data/preprocess.py``
and ``python -m mvlt_tpu_torch.preprocess_data``) against the JAX
package's: each task of the CLI (``rgc``, ``vqa-images`` on SLAKE and
VQA-RAD, ``vqa-text`` on both, ``u8-cache`` from a ROCO split, a MedICaT
json and a two-view annotation.json) run on a synthetic tree under
``tmp_path`` by the port's CLI and, on a copy of the tree, by the root
``preprocess_data.py`` gives the same pickles and the same uint8 bytes; the
two CLIs take the same flags.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mvlt_tpu_torch import preprocess_data

REPO = Path(__file__).resolve().parents[1]
Image = pytest.importorskip("PIL.Image")


def _image(path: Path, rng, mode: str = "RGB", size=(36, 28)) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    shape = (size[1], size[0]) + ((3,) if mode == "RGB" else ())
    Image.fromarray(rng.integers(0, 255, shape, np.uint8), mode).save(path)


def _tree(root: Path) -> None:
    """Every input layout the CLI reads, seeded."""
    rng = np.random.default_rng(0)
    # RGC
    rgc = root / "RGC"
    ann = {"train": [], "test": []}
    for split, n in (("train", 3), ("test", 2)):
        for i in range(n):
            name = f"{split}_{i}.png"
            _image(rgc / "images" / name, rng, "L")
            ann[split].append({"image": name, "img_id": i, "cap_id": 100 + i,
                               "caption": f"{split} caption {i}"})
    (rgc / "RGC_annotation.json").write_text(json.dumps(ann))
    # SLAKE: images and QA
    slake = root / "SLAKE"
    for i in (3, 11, 7):
        _image(slake / "imgs" / f"xmlab{i}" / "source.jpg", rng)
    (slake / "imgs" / "notes").mkdir()
    base = slake / "combine"
    base.mkdir(parents=True)
    with open(base / "en_ans2label.pkl", "wb") as f:
        pickle.dump({"yes": 0, "no": 1, "lung": 2}, f)
    with open(base / "en_label2ans.pkl", "wb") as f:
        pickle.dump(["yes", "no", "lung"], f)
    for split in ("train", "validate", "test"):
        qa = [{"qid": 1, "question": "is it normal?", "img_id": 7,
               "answer_type": "CLOSED", "q_lang": "en"},
              {"qid": 2, "question": "好吗?", "img_id": 7,
               "answer_type": "CLOSED", "q_lang": "zh"},
              {"qid": 3, "question": "which organ?", "img_id": 11,
               "answer_type": "OPEN", "q_lang": "en"}]
        (slake / f"question_{split}.json").write_text(json.dumps(qa))
        with open(base / f"en_{split}_target.pkl", "wb") as f:
            pickle.dump([{"qid": 1, "labels": [0]}, {"qid": 2, "labels": [0]},
                         {"qid": 3, "labels": []}], f)
    # VQA-RAD: images and QA
    rad = root / "VQA-RAD"
    for name in ("synpic1.jpg", "synpic20.jpg"):
        _image(rad / "VQA_RAD Image Folder" / name, rng)
    cache = rad / "cache"
    cache.mkdir(parents=True)
    with open(cache / "trainval_ans2label.pkl", "wb") as f:
        pickle.dump({"yes": 0, "no": 1}, f)
    with open(cache / "trainval_label2ans.pkl", "wb") as f:
        pickle.dump(["yes", "no"], f)
    for split in ("train", "test"):
        qa = [{"qid": 5, "image_name": "synpic1.jpg", "answer_type": "CLOSED",
               "question": "Is the patient's x ray normal? -yes/no"},
              {"qid": 6, "image_name": "synpic20.jpg", "answer_type": "OPEN",
               "question": "Where is the lesion, exactly?..."}]
        (rad / f"{split}set.json").write_text(json.dumps(qa))
        with open(cache / f"{split}_target.pkl", "wb") as f:
            pickle.dump([{"qid": 5, "image_name": "synpic1.jpg",
                          "labels": [1]},
                         {"qid": 6, "image_name": "synpic20.jpg",
                          "labels": []}], f)
    # ROCO split, MedICaT json, two-view annotation.json
    roco = root / "train" / "radiology"
    lines = []
    for i in range(3):
        _image(roco / "images" / f"ROCO_{i}.jpg", rng)
        lines.append(f"ROCO_{i}\tcaption {i} of roco")
    lines.append("ROCO_9\ta caption whose image is missing")
    (roco / "captions.txt").write_text("\n".join(lines) + "\n")
    med = []
    for i in range(2):
        _image(root / "figures" / f"h{i}_fig{i}.png", rng)
        med.append({"pdf_hash": f"h{i}", "fig_uri": f"fig{i}.png",
                    "s2_caption": f"medicat {i}"})
    (root / "medicat.json").write_text(json.dumps(med))
    ann = {"train": []}
    for i in range(2):
        views = [f"s{i}/0.png", f"s{i}/1.png"]
        for v in views:
            _image(root / "images" / v, rng, "L")
        ann["train"].append({"id": f"s{i}", "image_path": views,
                             "report": f"report {i}"})
    ann["train"].append({"id": "one", "image_path": ["s0/0.png", "s1/1.png"],
                         "report": "a third study"})
    (root / "annotation.json").write_text(json.dumps(ann))


TASKS = {
    "rgc": (["rgc"], ["RGC"]),
    "vqa-images SLAKE": (["vqa-images", "--dataset", "SLAKE"],
                         ["SLAKE/SLAKE_image_data.pkl"]),
    "vqa-images VQA-RAD": (["vqa-images", "--dataset", "VQA-RAD"],
                           ["VQA-RAD/VQA-RAD_image_data.pkl"]),
    "vqa-text SLAKE": (["vqa-text", "--dataset", "SLAKE"],
                       ["SLAKE/SLAKE_text_data.pkl"]),
    "vqa-text VQA-RAD": (["vqa-text", "--dataset", "VQA-RAD"],
                         ["VQA-RAD/VQA-RAD_text_data.pkl"]),
    "u8-cache roco": (["u8-cache", "--source", "roco"],
                      ["u8cache_roco_train"]),
    "u8-cache medicat": (["u8-cache", "--source", "medicat"],
                         ["u8cache_medicat_train"]),
    "u8-cache annotation": (["u8-cache", "--source", "annotation",
                             "--out", "{root}/two_view"], ["two_view"]),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("preprocess")
    _tree(base / "src")
    return base


def _run_root_cli(argv, monkeypatch):
    """The root script's ``main`` in this process on ``argv``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "root_preprocess_data", REPO / "preprocess_data.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    monkeypatch.setattr(sys, "argv", ["preprocess_data.py"] + argv)
    root.main()


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(a, b, where):
    """Deep equality, numpy arrays bitwise."""
    assert type(a) is type(b), where
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("task", sorted(TASKS))
def test_each_task_writes_what_jax_writes(task, trees, monkeypatch):
    """The port's CLI and the root CLI, each on its own copy of the tree:
    the same pickles (arrays bitwise; RGC's index paths relative to their
    trees) and the same uint8 cache bytes and metadata."""
    argv, outputs = TASKS[task]
    roots = {}
    for side in ("port", "jax"):
        root = trees / task.replace(" ", "_") / side
        shutil.copytree(trees / "src", root)
        args = [a.format(root=root) for a in argv] + ["--data_root",
                                                      str(root)]
        if side == "port":
            preprocess_data.main(args)
        else:
            _run_root_cli(args, monkeypatch)
        roots[side] = root
    for out in outputs:
        port, jax_ = roots["port"] / out, roots["jax"] / out
        if out == "RGC":
            for split in ("train", "test"):
                index = {i: Path(p).relative_to(roots["port"])
                         for i, p in _load(port / split /
                                           f"{split}_img_idx2path.pkl").items()}
                want = {i: Path(p).relative_to(roots["jax"])
                        for i, p in _load(jax_ / split /
                                          f"{split}_img_idx2path.pkl").items()}
                assert index == want and len(index) == (3 if split == "train"
                                                         else 2)
                for rel in index.values():
                    _same(_load(roots["port"] / rel), _load(roots["jax"] / rel),
                          str(rel))
        elif out.endswith(".pkl"):
            _same(_load(port), _load(jax_), out)
            assert port.read_bytes() == jax_.read_bytes(), out
        else:
            assert (port / "images.u8").read_bytes() == \
                (jax_ / "images.u8").read_bytes()
            meta = json.loads((port / "meta.json").read_text())
            assert meta == json.loads((jax_ / "meta.json").read_text())
            assert meta["shape"][0] == {"u8cache_roco_train": 3,
                                        "u8cache_medicat_train": 2,
                                        "two_view": 3}[out]


def test_cli_flags_equal_the_root_scripts():
    """``python -m mvlt_tpu_torch.preprocess_data --help`` prints the root
    ``preprocess_data.py --help``, word for word."""
    outs = [subprocess.run([sys.executable, *cmd, "--help"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for cmd in (["preprocess_data.py"],
                        ["-m", "mvlt_tpu_torch.preprocess_data"])]
    assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
    assert outs[0].stdout == outs[1].stdout and "u8-cache" in outs[0].stdout
