"""The port's retrieval driver against the JAX package's: ``AnnotationSource``
and ``RetrievalDataset`` (bitwise: both swaps, train pairs and the test
grid's items, two-view and single-view, uint8 and f32), the 1,000-draw
refusal of a degenerate source, ``train_retrieval``'s losses, the runner
signatures ``score_grid(runner, test_ds)`` / ``eval_retrieval``, and the
entry point ``python -m mvlt_tpu_torch.run_retrieval`` with its refusals.

The driver tests run JAX's ``tiny_config`` of ``for_retrieval`` (Swin 32
px, depths (1, 1), fusion 64 wide, 1 layer) with dropouts 0 in float32 on a
two-view 32-px IU X-Ray tree (``swap='image'``, as ``--iu_xray_root``
sets it). JAX trains and scores on its 8-device CPU mesh, the port on the
CPU: the per-step losses and the similarities agree within 1e-4, the labels
and the R@k are equal."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.data import datasets as jds
from mvlt_tpu.models.heads import RetrievalModel as JaxRetrieval
from mvlt_tpu.tasks import retrieval as jax_retrieval
from mvlt_tpu.tasks.common import TaskRunner as JaxRunner
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu.train import (create_train_state, make_optimizer,
                            shard_train_state)
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.data import datasets as pds
from mvlt_tpu_torch.models.heads import RetrievalModel
from mvlt_tpu_torch.tasks import retrieval as port_retrieval
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
IMG, L = 32, 16


def _same(a, b):
    """Two samples (nested dicts of arrays / scalars / strings) bitwise
    equal, dtypes too."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A seeded IU X-Ray tree: two 40-px views a study, 16 / 2 / 6."""
    root = tmp_path_factory.mktemp("iu")
    return pds.write_synthetic_iu_xray(
        str(root / "iu_xray"), {"train": 16, "val": 2, "test": 6},
        image_size=40, seed=2)


def _source(mod, root, split, two_view=True, normalize="host", size=IMG):
    return mod.AnnotationSource(os.path.join(root, "images"),
                                os.path.join(root, "annotation.json"), split,
                                two_view=two_view, image_size=size,
                                normalize=normalize)


@pytest.mark.parametrize("two_view", [True, False])
@pytest.mark.parametrize("normalize", ["host", "device"])
def test_annotation_source_is_bitwise_jax(tree, two_view, normalize):
    for split in ("train", "test"):
        port = _source(pds, tree, split, two_view, normalize, 224)
        want = _source(jds, tree, split, two_view, normalize, 224)
        assert len(port) == len(want)
        for i in (0, len(port) - 1):
            got = port[i]
            for x, y in zip(got, want[i]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
                assert np.asarray(x).dtype == np.asarray(y).dtype
            assert port.peek(i) == want.peek(i) == (got[1], got[3])
    shape = (224, 224, 3) if normalize == "device" else (3, 224, 224)
    assert got[0].shape == ((2,) if two_view else ()) + shape


@pytest.mark.parametrize("swap", ["either", "image"])
@pytest.mark.parametrize("source", ["synthetic", "iu_xray"])
def test_retrieval_dataset_is_bitwise_jax(tree, swap, source):
    """Train pairs over two epochs and every item of the virtual test grid
    (image i with caption j, label 1 on the diagonal or an equal
    ``cap_id``)."""
    def sets(mod, tok):
        if source == "synthetic":
            captions = [f"case {i % 5} lungs clear" for i in range(10)]
            src = mod.SyntheticSource(n=10, image_size=IMG, seed=3,
                                      captions=captions)
            test_src = src
        else:
            src = _source(mod, tree, "train")
            test_src = _source(mod, tree, "test")
        return (mod.RetrievalDataset(src, tok, L, "train", seed=5, swap=swap),
                mod.RetrievalDataset(test_src, tok, L, "test", seed=5))

    (ptrain, ptest), (jtrain, jtest) = (sets(pds, WordPieceTokenizer()),
                                        sets(jds, JaxTokenizer()))
    assert len(ptrain) == len(jtrain) and len(ptest) == len(jtest) \
        == ptest.img_num ** 2
    for epoch in (0, 1):
        for i in range(len(ptrain)):
            _same(ptrain.__getitem__(i, epoch), jtrain.__getitem__(i, epoch))
    for i in range(len(ptest)):
        _same(ptest[i], jtest[i])
    labels = [int(ptest[i]["label"]) for i in range(len(ptest))]
    assert sum(labels) >= ptest.img_num
    if swap == "image":
        for i in range(len(ptrain)):
            pair = ptrain[i]
            np.testing.assert_array_equal(pair["pos"]["caption"],
                                          pair["neg"]["caption"])


class _OneReport(pds.SyntheticSource):
    def peek(self, index):
        return "one report", 0


class _JaxOneReport(jds.SyntheticSource):
    def peek(self, index):
        return "one report", 0


def test_degenerate_source_raises_as_jax():
    for cls, mod, tok in ((_OneReport, pds, WordPieceTokenizer()),
                          (_JaxOneReport, jds, JaxTokenizer())):
        ds = mod.RetrievalDataset(cls(n=4, image_size=IMG), tok, L, "train")
        with pytest.raises(ValueError, match="1000 draws"):
            ds[0]


# ---- the driver --------------------------------------------------------------

def _driver_config(tok):
    cfg = jcfg.MVLTConfig.for_retrieval(max_length=L, lr=1e-3)
    cfg = jcfg.tiny_config(cfg).with_tokenizer(tok)
    return dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, num_hidden_layers=1, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))


def _sets(mod, tok, root):
    return (mod.RetrievalDataset(_source(mod, root, "train"), tok, L,
                                 "train", swap="image"),
            mod.RetrievalDataset(_source(mod, root, "test"), tok, L, "test"))


@pytest.fixture(scope="module")
def driver(tree):
    jtok, ptok = JaxTokenizer(), WordPieceTokenizer()
    cfg = _driver_config(jtok)
    jsets, psets = _sets(jds, jtok, tree), _sets(pds, ptok, tree)
    pos = jsets[0][0]["pos"]
    variables = jax.jit(JaxRetrieval(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(pos["image"][None]),
        jnp.asarray(pos["caption"][None]))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return cfg, {"params": params}, jsets, psets


def _runners(cfg, variables, tmp_path, batch=8, epochs=2):
    tc = dict(batch_size=batch, epochs=epochs, seed=0, log_every=1,
              num_workers=0)
    jrun = JaxRunner(JaxRetrieval(cfg), cfg, jcfg.TrainConfig(
        **tc, checkpoint_every_epochs=epochs + 1, mesh=jcfg.MeshConfig()),
        workdir=str(tmp_path / "jax"), name="jax-retrieval-parity")
    state = create_train_state(jrun.model, jax.tree.map(jnp.array, variables),
                               make_optimizer(cfg))
    jrun.state, jrun.shardings = shard_train_state(state, jrun.mesh)
    prun = TaskRunner(RetrievalModel, pcfg.MVLTConfig.from_json(cfg.to_json()),
                      pcfg.TrainConfig(**tc, checkpoint_every_epochs=epochs,
                                       bf16_compute=False),
                      workdir=str(tmp_path / "port"),
                      name="port-retrieval-parity", device="cpu")
    prun.init_state(pretrained_variables=params_from_flax(variables))
    return jrun, prun


def _metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def test_train_retrieval_matches_jax(driver, tmp_path):
    """``train_retrieval`` (2 epochs of 16 studies at 8 pairs, 16 rows a
    step, dropouts 0) from one parameter tree: the per-step losses within
    1e-4 and the accuracies equal; 16 samples logged a step."""
    cfg, variables, (jtrain, _), (ptrain, _) = driver
    jrun, prun = _runners(cfg, variables, tmp_path)
    jax_retrieval.train_retrieval(jrun, jtrain)
    port_retrieval.train_retrieval(prun, ptrain)
    jm, pm = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert len(jm) == len(pm) == 4
    np.testing.assert_allclose([m["loss"] for m in pm],
                               [m["loss"] for m in jm], rtol=0, atol=1e-4)
    assert [m["accuracy"] for m in pm] == [m["accuracy"] for m in jm]
    assert prun.state.step == 4
    assert "step_00000004" in os.listdir(tmp_path / "port")
    text = (tmp_path / "port" / "log.txt").read_text()
    assert "step 4:" in text


def test_score_grid_and_eval_retrieval_match_jax(driver, tmp_path):
    """``score_grid(runner, test_ds, batch_size)`` over the 6 test studies
    in chunks of 4 (the last one short in the port, zero-padded in JAX):
    similarities within 1e-4, labels equal; ``eval_retrieval``'s R@k
    equal."""
    cfg, variables, (_, jtest), (_, ptest) = driver
    jrun, prun = _runners(cfg, variables, tmp_path)
    want = jax_retrieval.score_grid(jrun, jtest, batch_size=4)
    got = port_retrieval.score_grid(prun, ptest, batch_size=4)
    assert got["similarities"].shape == (6, 6)
    np.testing.assert_allclose(got["similarities"], want["similarities"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert np.ptp(got["similarities"]) > 1e-3
    assert port_retrieval.eval_retrieval(prun, ptest, 4) == \
        jax_retrieval.eval_retrieval(jrun, jtest, 4)


# ---- the entry point -----------------------------------------------------------

def test_run_retrieval_cli_synthetic(tmp_path):
    """``python -m mvlt_tpu_torch.run_retrieval --synthetic --tiny --device
    cpu --do_train --do_test``: one epoch, ``eval.json`` with both
    directions' R@1 / 5 / 10, a log and a checkpoint."""
    out = tmp_path / "ret"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "mvlt_tpu_torch.run_retrieval", "--synthetic",
         "--tiny", "--device", "cpu", "--epochs", "1", "--batch_size", "8",
         "--num_workers", "0", "--do_train", "--do_test",
         "--model_name", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads((out / "eval.json").read_text())
    assert set(result) == {"i2t_retrieval", "t2i_retrieval"}
    assert set(result["i2t_retrieval"]) == {"R@1", "R@5", "R@10"}
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == result
    assert {"log.txt", "metrics.jsonl", "step_00000004"} <= \
        set(os.listdir(out))


def test_run_retrieval_iu_xray(tree, tmp_path):
    """``--iu_xray_root --tiny --device cpu``: the negatives swap the image
    (``--swap either`` given, 'image' taken), two-view uint8 frames at the
    tiny size through loader processes, 2 steps of 8 pairs, the 6 x 6 grid
    in ``eval.json``."""
    from mvlt_tpu_torch import run_retrieval as cli
    argv = ["--iu_xray_root", tree, "--tiny", "--device", "cpu", "--epochs",
            "1", "--batch_size", "8", "--num_workers", "2", "--swap",
            "either", "--do_train", "--do_test",
            "--model_name", str(tmp_path / "ret")]
    runner, result = cli.main(argv)
    assert runner.state.step == 2
    assert json.loads((tmp_path / "ret" / "eval.json").read_text()) == result
    args = cli.parse_args(argv)
    train, test = cli.build_sources(args, IMG)
    assert args.swap == "image" and len(test) == 6
    assert train[0][0].shape == (2, IMG, IMG, 3)
    assert train[0][0].dtype == np.uint8


def test_run_retrieval_refusals(tmp_path):
    from mvlt_tpu_torch import run_retrieval as cli
    base = ["--synthetic", "--tiny", "--epochs", "1", "--do_train",
            "--model_name", str(tmp_path / "x")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(base)
    # one process holds no (1, 2) mesh: JAX's build_mesh error (a
    # multi-device run is one process a device, under torchrun)
    with pytest.raises(ValueError, match="does not divide device count 1"):
        cli.main(base + ["--device", "cpu", "--model_parallel", "2"])
    with pytest.raises(SystemExit, match="nothing to do"):
        cli.main(["--synthetic", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no data source"):
        cli.main(["--do_test", "--device", "cpu", "--tiny",
                  "--model_name", str(tmp_path / "y")])
