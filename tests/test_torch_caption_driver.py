"""The port's report-generation driver against the JAX package's: the report
cleaning and the ImageNet transforms, ``CaptionDataset`` and
``CXRAnnotationDataset`` (bitwise, two-view IU X-Ray and single-view
MIMIC-CXR, both strategies, uint8 / f32 / ImageNet frames, train and test),
the two-view adapter input, the two-view caption loss and its gradients on
JAX's replayed masks, ``eval_caption`` (decoded ids, greedy and beam, and
the score dicts), ``train_caption``'s losses, and the entry point
``python -m mvlt_tpu_torch.run_report_generation`` with its refusals.

The model tests run JAX's ``tiny_config`` of ``for_caption`` (Swin 32 px,
depths (1, 1), fusion 64 wide, 1 layer, the full vocabulary) in float32
from one perturbed parameter tree: the adapter, and the loss and the
gradients (1e-4 x max|grad| per tensor) with DropPath 0.3 and dropouts 0.1;
the driver with dropouts 0, on a two-view 32-px IU X-Ray tree read by
``AnnotationSource`` under ``CaptionDataset`` on both sides. JAX trains and
decodes on its 8-device CPU mesh (its last test batch padded with a zero
image), the port on the CPU (its last test batch short).
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mvlt_tpu import config as jcfg
from mvlt_tpu.data import datasets as jds
from mvlt_tpu.data import transforms as jT
from mvlt_tpu.models.heads import CaptionModel as JaxCaption
from mvlt_tpu.tasks import caption as jax_caption
from mvlt_tpu.tasks.common import TaskRunner as JaxRunner
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu.train import (create_train_state, make_optimizer,
                            shard_train_state)
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.data import datasets as pds
from mvlt_tpu_torch.data import transforms as pT
from mvlt_tpu_torch.models.heads import CaptionModel
from mvlt_tpu_torch.tasks import caption as port_caption
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.utils.convert import params_from_flax
from test_torch_caption import _inject_masks

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
B, IMG = 2, 32
KEYS = ("image", "caption", "mlm_labels")


def _same(a, b):
    """Two samples bitwise equal: arrays with their dtypes, strings."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A seeded IU X-Ray tree (two 48-px views a study) and a MIMIC-CXR one
    (one view), 16 / 2 / 5 studies."""
    root = tmp_path_factory.mktemp("cxr")
    splits = {"train": 16, "val": 2, "test": 5}
    return {"iu_xray": pds.write_synthetic_iu_xray(
                str(root / "iu_xray"), splits, image_size=48, seed=0),
            "mimic_cxr": pds.write_synthetic_iu_xray(
                str(root / "mimic_cxr"), splits, image_size=48, views=1,
                seed=1)}


# ---- report cleaning and transforms ------------------------------------------

def test_report_cleaning_is_jax(tree):
    rng = np.random.default_rng(0)
    pieces = ["1. ", "2. ", ". 3. ", " 4. ", "5. ", "..", "...", ". ", "__",
              "  ", "\n", "--", '"', "/", "\\", "'", ";", "<", "@", "(", ")",
              "[", "]", "{", "}", "%", "Heart", "size", "NORMAL", "x-ray",
              "3.5", " "]
    reports = ["".join(rng.choice(pieces, size=int(rng.integers(0, 40))))
               for _ in range(300)]
    with open(os.path.join(tree["iu_xray"], "annotation.json")) as f:
        reports += [e["report"] for e in json.load(f)["train"]]
    for r in reports:
        assert pT.clean_report_iu_xray(r) == jT.clean_report_iu_xray(r)
        assert pT.clean_report_mimic_cxr(r) == jT.clean_report_mimic_cxr(r)


def test_imagenet_transforms_are_bitwise_jax():
    rng = np.random.default_rng(1)
    for w, h in ((300, 260), (240, 320), (256, 256), (500, 224)):
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for i in range(3):
            got = pT.train_augment_imagenet(im, pT.sample_rng(0, 1, i))
            want = jT.train_augment_imagenet(im, jT.sample_rng(0, 1, i))
            assert got.dtype == want.dtype == np.float32
            assert got.shape == (3, 224, 224)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pT.eval_transform_imagenet(im),
                                      jT.eval_transform_imagenet(im))
        np.testing.assert_array_equal(
            pT.imagenet_normalize(np.asarray(im, np.float32) / 255),
            jT.imagenet_normalize(np.asarray(im, np.float32) / 255))


# ---- datasets ------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["unilm", "normal"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_caption_dataset_is_bitwise_jax(strategy, split):
    mk = lambda mod, tok: mod.CaptionDataset(
        mod.SyntheticSource(n=6, image_size=IMG, seed=2), tok, 24, split,
        seed=3, learning_strategy=strategy)
    port, jax_ds = mk(pds, WordPieceTokenizer()), mk(jds, JaxTokenizer())
    assert len(port) == len(jax_ds) == 6
    for epoch in (0, 1):
        for i in range(6):
            _same(port.__getitem__(i, epoch), jax_ds.__getitem__(i, epoch))
    labels = np.stack([port[i]["mlm_labels"] for i in range(6)])
    assert (labels != -100).any() == (split == "train")


@pytest.mark.parametrize("dataset", ["iu_xray", "mimic_cxr"])
@pytest.mark.parametrize("frames", ["uint8", "f32", "imagenet"])
@pytest.mark.parametrize("strategy,split", [("unilm", "train"),
                                            ("normal", "train"),
                                            ("unilm", "test")])
def test_cxr_dataset_is_bitwise_jax(tree, dataset, frames, strategy, split):
    """Both views of a study (IU X-Ray) or its one view (MIMIC-CXR),
    cleaned reports, labels: uint8 frames with a pretrained export and the
    device normalize, f32 with the host normalize, ImageNet crops without
    an export."""
    root = tree[dataset]
    kw = dict(split=split, two_view=dataset == "iu_xray", max_length=30,
              pretrained=frames != "imagenet", seed=4,
              learning_strategy=strategy,
              normalize="device" if frames == "uint8" else "host")
    args = (os.path.join(root, "images"), os.path.join(root, "annotation.json"))
    port = pds.CXRAnnotationDataset(*args, WordPieceTokenizer(), **kw)
    jax_ds = jds.CXRAnnotationDataset(*args, JaxTokenizer(), **kw)
    assert len(port) == len(jax_ds) == (16 if split == "train" else 5)
    for epoch, i in ((0, 0), (1, 0), (0, len(port) - 1)):
        got = port.__getitem__(i, epoch)
        _same(got, jax_ds.__getitem__(i, epoch))
    views = (2,) if dataset == "iu_xray" else ()
    shape = (224, 224, 3) if frames == "uint8" else (3, 224, 224)
    assert got["image"].shape == views + shape
    assert got["image"].dtype == (np.uint8 if frames == "uint8"
                                  else np.float32)


# ---- the two-view model and the driver ---------------------------------------------

DRIVER_L = 12


def _driver_config(tok, dropout=0.0, drop_path=0.0):
    cfg = jcfg.MVLTConfig.for_caption(max_length=DRIVER_L, lr=1e-3)
    cfg = jcfg.tiny_config(cfg).with_tokenizer(tok)
    return dataclasses.replace(
        cfg, swin=dataclasses.replace(cfg.swin, drop_path_rate=drop_path),
        fusion=dataclasses.replace(
            cfg.fusion, num_hidden_layers=1, hidden_dropout_prob=dropout,
            attention_probs_dropout_prob=dropout))


def _port_model(cfg, variables):
    model = CaptionModel(pcfg.MVLTConfig.from_json(cfg.to_json()),
                         device="cpu")
    model.load_state_dict(params_from_flax(variables))       # strict
    return model


def _two_view(seed, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, (B, 2, IMG, IMG, 3), dtype=np.uint8)
    return rng.normal(size=(B, 2, 3, IMG, IMG)).astype(np.float32)


@pytest.mark.parametrize("uint8", [False, True])
def test_two_view_adapter_matches_jax(driver, uint8):
    """The adapter's (B, 2N, hidden) tokens of a two-view batch, f32 (B, 2,
    3, H, W) or uint8 (B, 2, H, W, 3), within 1e-4; view 0's tokens first,
    each view's equal to its own single-view encoding."""
    cfg, variables = driver[:2]
    image = _two_view(5, uint8)
    want = jax.jit(lambda v, im: JaxCaption(cfg).apply(
        v, im, method=JaxCaption.encode_image))(variables, jnp.asarray(image))
    model = _port_model(cfg, variables)
    got = model.encode_image(torch.from_numpy(image))
    assert got.shape == (B, 32, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    one = model.encode_image(torch.from_numpy(image[:, 1]))
    np.testing.assert_allclose(got[:, 16:].numpy(), one.numpy(), atol=1e-6,
                               rtol=0)


def test_two_view_loss_and_grads_match_jax(driver, monkeypatch):
    """The unilm caption loss of a two-view batch and every gradient, with
    DropPath 0.3 and dropouts 0.1, on JAX's masks replayed in its order:
    view 0's DropPath draws, view 1's, then the fusion layer's."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    _, variables, _, _, jtok, _ = driver
    cfg = _driver_config(jtok, dropout=0.1, drop_path=0.3)
    batch = {k: v.numpy() for k, v in flagship.example_caption_batch(
        B, DRIVER_L, seed=6, image_size=IMG, vocab=1000).items()}
    batch["image"] = _two_view(7)
    S = 1 + 32 + 1 + DRIVER_L
    drawn = _inject_masks(monkeypatch, 8)
    jmodel = JaxCaption(cfg)
    args = [jnp.asarray(batch["image"])] + [jnp.asarray(batch[k], jnp.int32)
                                            for k in KEYS[1:]]

    def loss_fn(params):
        return jmodel.apply({"params": params}, *args, "unilm",
                            deterministic=False, method=jmodel.loss,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    # each view's second Swin block draws two DropPath masks (the first
    # block's rate is 0); then the attention mask and the two hidden ones
    assert [m.shape for m in drawn] == [(B, 1, 1)] * 4 + [
        (B, 4, S, S), (B, S, 64), (B, S, 64)]
    model = _port_model(cfg, variables)
    masks = DropoutMasks.replay(m.reshape(B) if m.shape == (B, 1, 1) else m
                                for m in drawn)
    loss, _ = model.loss(*(torch.from_numpy(batch[k]) for k in KEYS),
                         "unilm", masks=masks)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want = params_from_flax({"params": grads})
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.startswith("fusion.pooler."):
            assert p.grad is None and not w.any(), name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _caption_sets(mod, tok, root, seed=0):
    """(train, test) ``CaptionDataset``s over two-view 32-px
    ``AnnotationSource``s of the IU X-Ray tree."""
    src = lambda split: mod.AnnotationSource(
        os.path.join(root, "images"), os.path.join(root, "annotation.json"),
        split, two_view=True, image_size=IMG)
    return (mod.CaptionDataset(src("train"), tok, DRIVER_L, "train", seed),
            mod.CaptionDataset(src("test"), tok, DRIVER_L, "test", seed))


class _Recording:
    """A tokenizer whose ``decode`` keeps the ids it is given."""

    def __init__(self, tok):
        self.tok, self.ids = tok, []

    def decode(self, ids):
        self.ids.append([int(i) for i in ids])
        return self.tok.decode(ids)


@pytest.fixture(scope="module")
def driver(tree):
    """The config with dropouts 0, one perturbed parameter tree of it, both
    packages' (train, test) datasets and tokenizers."""
    jtok, ptok = JaxTokenizer(), WordPieceTokenizer()
    cfg = _driver_config(jtok)
    jsets = _caption_sets(jds, jtok, tree["iu_xray"])
    psets = _caption_sets(pds, ptok, tree["iu_xray"])
    sample = jsets[0][0]
    variables = jax.jit(JaxCaption(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(sample["image"][None]),
        jnp.asarray(sample["caption"][None]))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return cfg, {"params": params}, jsets, psets, jtok, ptok


def _runners(cfg, variables, tmp_path, batch=8, epochs=2):
    tc = dict(batch_size=batch, epochs=epochs, seed=0, log_every=1,
              num_workers=0)
    jrun = JaxRunner(JaxCaption(cfg), cfg, jcfg.TrainConfig(
        **tc, checkpoint_every_epochs=epochs + 1, mesh=jcfg.MeshConfig()),
        workdir=str(tmp_path / "jax"), name="jax-caption-parity")
    state = create_train_state(jrun.model, jax.tree.map(jnp.array, variables),
                               make_optimizer(cfg))
    jrun.state, jrun.shardings = shard_train_state(state, jrun.mesh)
    prun = TaskRunner(CaptionModel, pcfg.MVLTConfig.from_json(cfg.to_json()),
                      pcfg.TrainConfig(**tc, checkpoint_every_epochs=epochs,
                                       bf16_compute=False),
                      workdir=str(tmp_path / "port"),
                      name="port-caption-parity", device="cpu")
    prun.init_state(pretrained_variables=params_from_flax(variables))
    return jrun, prun


@pytest.fixture(scope="module")
def eval_runners(driver, tmp_path_factory):
    """Both packages' runners on the driver's tree, shared by the eval
    tests (which change no state)."""
    return _runners(*driver[:2], tmp_path_factory.mktemp("eval"))


@pytest.mark.parametrize("num_beams", [1, 3])
def test_eval_caption_matches_jax(driver, eval_runners, num_beams):
    """5 test studies in batches of 2: the decoded ids of every study
    equal JAX's (its last batch padded with a zero image, the port's run
    short), and so do both score dicts."""
    _, _, (_, jtest), (_, ptest), jtok, ptok = driver
    jrun, prun = eval_runners
    jrec, prec = _Recording(jtok), _Recording(ptok)
    want = jax_caption.eval_caption(jrun, jtest, jrec, batch_size=2,
                                    num_beams=num_beams)
    got = port_caption.eval_caption(prun, ptest, prec, batch_size=2,
                                    num_beams=num_beams)
    assert len(prec.ids) == 5 and prec.ids == jrec.ids
    assert len(set(map(tuple, jrec.ids))) > 1
    assert got == want
    assert {f"r2gen_{k}" for k in ("BLEU_4", "METEOR", "CIDEr")} <= set(got)


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(l)["loss"] for l in f]


def test_train_caption_matches_jax(driver, tmp_path):
    """``train_caption`` (unilm, 2 epochs of 16 studies at b8, dropouts 0)
    from one parameter tree: the per-step losses within 1e-4; the port
    checkpoints after the last epoch; no test without a tokenizer."""
    cfg, variables, (jtrain, _), (ptrain, _), _, _ = driver
    for i in range(len(jtrain)):
        _same(ptrain.__getitem__(i, 1), jtrain.__getitem__(i, 1))
    jrun, prun = _runners(cfg, variables, tmp_path, batch=8)
    assert jax_caption.train_caption(jrun, jtrain) == []
    assert port_caption.train_caption(prun, ptrain) == []
    jl, pl = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(jl) == len(pl) == 2 * (16 // 8)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    assert jl[-1] < jl[0]
    assert prun.state.step == 4
    assert "step_00000004" in os.listdir(tmp_path / "port")


def test_quant_refusal_names_its_roadmap_item():
    """JAX's modes are taken ('int8w' since the port has it); any other
    still raises."""
    port_caption.check_quant("int8w")
    port_caption.check_quant("")
    with pytest.raises(ValueError, match="unknown quant"):
        port_caption.check_quant("fp8")


def test_eval_caption_int8w_matches_jax(driver, eval_runners):
    """``eval_caption(quant="int8w")`` (the weights JAX's predicate selects
    quantized, dequantized to bf16 for each decode): the decoded ids of
    every study and both score dicts equal JAX's int8w ones, and the count
    of quantized tensors is logged in JAX's terms."""
    _, _, (_, jtest), (_, ptest), jtok, ptok = driver
    jrun, prun = eval_runners
    jrec, prec = _Recording(jtok), _Recording(ptok)
    logs = {}
    for name, run in (("jax", jrun), ("port", prun)):
        logs[name] = _Lines()
        run.logger.addHandler(logs[name])
    try:
        want = jax_caption.eval_caption(jrun, jtest, jrec, batch_size=2,
                                        num_beams=3, quant="int8w")
        got = port_caption.eval_caption(prun, ptest, prec, batch_size=2,
                                        num_beams=3, quant="int8w")
    finally:
        for name, run in (("jax", jrun), ("port", prun)):
            run.logger.removeHandler(logs[name])
    assert len(prec.ids) == 5 and prec.ids == jrec.ids
    assert got == want
    said = [[m for m in logs[n].lines if m.startswith("int8w serving: ")]
            for n in ("jax", "port")]
    assert said[0] == said[1] and len(said[1]) == 1
    assert said[1][0] != "int8w serving: 0 tensors quantized"


class _Lines(logging.Handler):
    """Keeps the messages a logger emits."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# ---- the entry point --------------------------------------------------------------

def test_run_report_generation_cli_synthetic(tmp_path):
    """``python -m mvlt_tpu_torch.run_report_generation --dataset synthetic
    --tiny --device cpu``: one epoch, the test after it (greedy), a log,
    the metrics stream, a checkpoint; the scores printed."""
    out = tmp_path / "cap"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "mvlt_tpu_torch.run_report_generation",
         "--dataset", "synthetic", "--tiny", "--device", "cpu", "--epochs",
         "1", "--batch_size", "8", "--num_workers", "0", "--test_freq", "1",
         "--num_beams", "1", "--model_name", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(os.listdir(out))
    assert {"log.txt", "metrics.jsonl", "step_00000002"} <= names
    assert "epoch 0 eval: {'Bleu_1'" in (out / "log.txt").read_text()


def test_run_report_generation_iu_xray(tree, tmp_path):
    """``--dataset iu_xray --tiny --device cpu --pretrained <export>`` on a
    synthetic tree: two-view uint8 frames at the tiny size, one epoch, then
    ``--do_test`` with beam 2: the score dict; the train split's reports
    cleaned."""
    from mvlt_tpu_torch import run_report_generation as cli
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(tree["iu_xray"], data / "iu_xray")
    cfg = cli.build_config(cli.parse_args(["--tiny"]), WordPieceTokenizer(),
                           80)
    export = tmp_path / "export"
    ckpt_lib.save_pretrained(str(export), cfg, CaptionModel(cfg,
                                                            device="cpu"))
    argv = ["--dataset", "iu_xray", "--data_root", str(data), "--tiny",
            "--device", "cpu", "--epochs", "1", "--batch_size", "4",
            "--num_workers", "2", "--num_beams", "2", "--do_train",
            "--do_test", "--pretrained", str(export),
            "--model_name", str(tmp_path / "cap")]
    runner, out = cli.main(argv)
    assert runner.state.step == 4 and out["evals"] == []
    assert set(out["test"]) >= {"Bleu_1", "CIDEr", "r2gen_ROUGE_L"}
    train, test = cli.build_datasets(cli.parse_args(argv),
                                     WordPieceTokenizer(), 80, IMG)
    assert train[0]["image"].shape == (2, IMG, IMG, 3)
    assert train[0]["image"].dtype == np.uint8 and len(test) == 5
    assert train.examples[0]["report"].endswith(" .")


def test_run_report_generation_refusals(tmp_path):
    from mvlt_tpu_torch import run_report_generation as cli
    base = ["--dataset", "synthetic", "--tiny", "--epochs", "1",
            "--model_name", str(tmp_path / "x")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(base)
    # one process holds no (1, 2) mesh: JAX's build_mesh error (a
    # multi-device run is one process a device, under torchrun)
    with pytest.raises(ValueError, match="does not divide device count 1"):
        cli.main(base + ["--device", "cpu", "--model_parallel", "2"])
    # --quant int8w is no refusal any more: a tiny test on int8 weights
    runner, out = cli.main(base + ["--device", "cpu", "--quant", "int8w",
                                   "--do_test", "--num_beams", "1",
                                   "--num_workers", "0"])
    assert runner.state.step == 0 and {"Bleu_1", "CIDEr"} <= set(out["test"])
    assert "int8w serving: " in (tmp_path / "x" / "log.txt").read_text()
    with pytest.raises(SystemExit, match="--rgc_index"):
        cli.main(["--dataset", "rgc", "--tiny", "--device", "cpu",
                  "--model_name", str(tmp_path / "y")])
    with pytest.raises(SystemExit, match="does not contain 'train'"):
        cli._split_index_path("/a/train/idx.pkl", "test")
    assert cli._split_index_path("/a/train/train_idx.pkl", "test") == \
        "/a/train/test_idx.pkl"
