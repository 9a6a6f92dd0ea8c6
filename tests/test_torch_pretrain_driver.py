"""The port's pretrain driver against the JAX package's: the transforms, the
pretrain sources and ``PretrainDataset`` (bitwise, every index over two
epochs), the device-side uint8 normalize, a uint8 image through the tiny
``PretrainModel``, ``train_pretrain`` on both packages from one parameter
tree, and the entry point ``python -m mvlt_tpu_torch.run_pretrain``.

``train_pretrain`` runs JAX's ``tiny_config`` of ``for_pretrain`` (Swin 32
px, embed 16, depths (1, 1); fusion 64 wide, 1 layer; ITM on, text 24) with
fusion dropouts 0 and DropPath 0, in float32 on both sides, b8 over 16
samples for 2 epochs (JAX's flips take both modes). JAX trains on its 8-device CPU mesh; its coin flips
are recorded from ``seq2seq_coin_flip`` and replayed into the port's (the
two generators differ by design). The per-step losses agree within 1e-4,
and so do the port's exported parameters and JAX's trained ones."""

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
from mvlt_tpu.models.backbones.adapter import \
    device_var_normalize as jax_normalize
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu.tasks import pretrain as jax_pretrain
from mvlt_tpu.tasks.common import TaskRunner as JaxRunner
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu.train import (create_train_state, make_optimizer,
                            shard_train_state)
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.data import datasets as pds
from mvlt_tpu_torch.data import transforms as pT
from mvlt_tpu_torch.models.backbones.adapter import device_var_normalize
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.tasks import pretrain as port_pretrain
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.utils import checkpoint as pckpt
from mvlt_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
IMG, N = 32, 24


def _port_config(cfg):
    return pcfg.MVLTConfig.from_json(cfg.to_json())


def _same(a, b):
    """Two samples (dicts of arrays / scalars) bitwise equal, dtypes too."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---- transforms ------------------------------------------------------------

def _frames(n=N, size=IMG, seed=0):
    frames, captions = pds.synthetic_pretrain_frames(n, size, seed)
    return frames, captions


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("fast", [False, True])
def test_image_loads_are_bitwise_jax(tmp_path, fmt, fast):
    """The u8 and f32 loads of seeded frames written as files (resized
    from 40 px, so the resize runs) equal JAX's bitwise; the f32 load is
    ``normalize_image_var`` of the u8 one, transposed."""
    frames, _ = _frames(3, 40)
    for i, f in enumerate(frames):
        path = str(tmp_path / f"{i}.img")
        Image.fromarray(f).save(path, format=fmt)
        u8 = pT.load_image_u8(path, IMG, fast=fast)
        want = jT.load_image_u8(path, IMG, fast=fast)
        assert u8.dtype == np.uint8 and u8.shape == (IMG, IMG, 3)
        np.testing.assert_array_equal(u8, want)
        f32 = pT.load_image_var_normalized(path, IMG, fast=fast)
        np.testing.assert_array_equal(
            f32, jT.load_image_var_normalized(path, IMG, fast=fast))
        np.testing.assert_array_equal(
            f32, pT.normalize_image_var(u8.astype(np.float32)
                                        .transpose(2, 0, 1)))


@pytest.mark.parametrize("length", [1, 4, 23, 60])
def test_masking_and_truncation_are_bitwise_jax(length):
    tok = WordPieceTokenizer()
    words = list(tok.vocab)[1000:1000 + length]
    vocab_words = list(tok.vocab.keys())
    for seed in range(5):
        got = pT.random_mask_word(words, tok.vocab, pT.sample_rng(seed, 1, 2),
                                  vocab_words)
        want = jT.random_mask_word(words, tok.vocab,
                                   jT.sample_rng(seed, 1, 2), vocab_words)
        assert got == want
        ids = tok.convert_tokens_to_ids(got[0])
        for max_length in (3, length, 40):
            for labels in (None, got[1]):
                a = pT.pad_truncate_preserve_end(ids, max_length, labels)
                b = jT.pad_truncate_preserve_end(ids, max_length, labels)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    a = pT.normalize_image_var(_frames(2)[0].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        a, jT.normalize_image_var(_frames(2)[0].transpose(0, 3, 1, 2)))


# ---- sources and PretrainDataset ---------------------------------------------

def _write_corpus(root: Path):
    """Every source's files from one seeded corpus: RGC pickles, a uint8
    cache, a ROCO split (one caption line without its image, one line
    without a tab) and a MedICaT folder."""
    frames, captions = _frames()
    out = pds.write_synthetic_pretrain(str(root), N, IMG, seed=0)
    base = root / "roco" / "train" / "radiology"
    with open(base / "captions.txt", "a") as f:
        f.write("ROCO_missing\tan image that is not there\n")
        f.write("a line without a tab\n")
    med = root / "medicat"
    (med / "figures").mkdir(parents=True)
    entries = []
    for i in range(N // 2):
        name = f"fig{i}.png"
        Image.fromarray(frames[i]).save(med / "figures" / f"pdf{i}_{name}")
        entries.append({"pdf_hash": f"pdf{i}", "fig_uri": name,
                        "s2_caption": captions[i]})
    (med / "medicat.json").write_text(json.dumps(entries))
    out["medicat_root"] = str(med)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus"))


def _sources(mod, kind, paths):
    if kind == "pickle":
        return mod.PickleSource(paths["rgc_index"])
    if kind == "roco":
        src = mod.ImageFolderSource.from_roco(paths["roco_root"])
        src.image_size, src.normalize = IMG, "device"
        return src
    if kind == "medicat":
        src = mod.ImageFolderSource.from_medicat(paths["medicat_root"])
        src.image_size = IMG
        return src
    if kind == "u8":
        return mod.U8CacheSource(paths["u8_cache"])
    if kind == "synthetic":
        return mod.SyntheticSource(n=N, image_size=IMG, seed=3)
    if kind == "concat":
        roco = mod.ImageFolderSource.from_roco(paths["roco_root"])
        roco.image_size, roco.normalize = IMG, "device"
        return mod.ConcatSource(mod.U8CacheSource(paths["u8_cache"]), roco)
    raise ValueError(kind)


def test_roco_scan_equals_jax_and_logs_the_skip(tmp_path, caplog):
    """The port's scan of a ROCO split writes the ``ROCO.json`` JAX's scan
    writes, skips the caption without an image with the same warning, and
    a second scan reads the cache."""
    paths = _write_corpus(tmp_path)
    cache = Path(paths["roco_root"]) / "train" / "radiology" / "ROCO.json"
    with caplog.at_level(logging.WARNING, logger="mvlt.data"):
        port = pds.ImageFolderSource.from_roco(paths["roco_root"])
    assert "skipped 1 entries with missing images" in caplog.text
    port_json = cache.read_text()
    cache.unlink()
    jax_src = jds.ImageFolderSource.from_roco(paths["roco_root"])
    assert cache.read_text() == port_json
    assert port.items == jax_src.items and len(port) == N
    assert pds.ImageFolderSource.from_roco(paths["roco_root"]).items == \
        port.items


@pytest.mark.parametrize("kind", ["pickle", "roco", "medicat", "u8",
                                  "synthetic", "concat"])
def test_pretrain_dataset_is_bitwise_jax(corpus, kind):
    """Every index over two epochs: the source's tuple and the
    ``PretrainDataset`` sample (image, masked ids, labels, ITM label) equal
    JAX's bitwise."""
    jsrc, psrc = _sources(jds, kind, corpus), _sources(pds, kind, corpus)
    assert len(jsrc) == len(psrc)
    for i in range(len(psrc)):
        a, b = psrc[i], jsrc[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype and a[1:] == b[1:]
    jtok, ptok = JaxTokenizer(), WordPieceTokenizer()
    jset = jds.PretrainDataset(jsrc, jtok, max_length=20, seed=5)
    pset = pds.PretrainDataset(psrc, ptok, max_length=20, seed=5)
    negatives = 0
    for epoch in range(2):
        for i in range(len(pset)):
            got = pset.__getitem__(i, epoch)
            _same(got, jset.__getitem__(i, epoch))
            negatives += int(got["itm_label"] == 0)
    assert 0 < negatives < 2 * len(pset)


class _OneCaption:
    """A degenerate source: four images of one report (one cap_id)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.zeros((3, 4, 4), np.float32), "the same report", i, 0


def test_degenerate_source_raises_as_jax():
    out = []
    for mod, tok in ((pds, WordPieceTokenizer()), (jds, JaxTokenizer())):
        ds = mod.PretrainDataset(_OneCaption(), tok, max_length=8)
        res = []
        for i in range(8):
            try:
                res.append(int(ds[i]["itm_label"]))
            except ValueError as e:
                res.append(str(e))
        out.append(res)
    assert out[0] == out[1]
    assert any("1000 draws" in str(r) for r in out[0])


# ---- uint8 input --------------------------------------------------------------

def _exact_normalize(frames):
    """(x - mean) / var of uint8 (B, H, W, 3) frames in float64, (B, 3, H,
    W): the value every f32 route rounds."""
    x = frames.astype(np.float64)
    mean = x.mean(axis=(-3, -2), keepdims=True)
    var = ((x - mean) ** 2).mean(axis=(-3, -2), keepdims=True)
    return ((x - mean) / var).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("size", [32, 48])
def test_device_var_normalize_matches_jax_and_the_host(size):
    """uint8 (B, H, W, 3) -> f32 (B, 3, H, W). The port's result is within
    1e-6 x max|out| of the float64 value. JAX's ``device_var_normalize``
    and the host's ``normalize_image_var`` sum in f32 in another order and
    sit 1.0e-6 to 2.2e-6 x max|out| from that value themselves (32 and 48
    px), so the port is held to each within 1e-6 x max|out| beyond that
    reference's own distance from the float64 value."""
    frames = _frames(4, size)[0]
    got = device_var_normalize(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (4, 3, size, size)
    got = got.numpy()
    exact = _exact_normalize(frames)
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-6 * scale
    jax_out = np.asarray(jax_normalize(jnp.asarray(frames)))
    host = pT.normalize_image_var(frames.transpose(0, 3, 1, 2))
    for ref in (jax_out, host):
        own = np.abs(ref - exact).max()
        assert np.abs(got - ref).max() <= own + 1e-6 * scale
    # the channels-last result is free to take back to NHWC
    assert device_var_normalize(torch.from_numpy(frames)).permute(
        0, 2, 3, 1).is_contiguous()


def _tiny_pretrain_config(itm=True, max_length=24, layers=1):
    cfg = jcfg.MVLTConfig.for_pretrain(itm_task=itm, max_length=max_length)
    cfg = jcfg.tiny_config(cfg).with_tokenizer(JaxTokenizer())
    return dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, num_hidden_layers=layers, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))


def _jax_variables(cfg, batch):
    args = [jnp.asarray(batch[k]) for k in ("image", "caption_masked",
                                            "caption_label", "itm_label")]
    return jax.jit(JaxPretrain(cfg).init)(jax.random.PRNGKey(0), *args)


@pytest.mark.parametrize("seq2seq", [False, True])
def test_uint8_pretrain_loss_matches_jax_and_the_host_input(corpus, seq2seq):
    """The tiny ``PretrainModel.loss`` on a uint8 batch of the cache equals
    JAX's on the same batch within 1e-4, and the port's on the
    host-normalized f32 batch within 1e-5."""
    cfg = _tiny_pretrain_config()
    src = pds.U8CacheSource(corpus["u8_cache"])
    ds = pds.PretrainDataset(src, WordPieceTokenizer(), max_length=24)
    batch = {k: np.stack([np.asarray(ds[i][k]) for i in range(4)])
             for k in ("image", "caption_masked", "caption_label",
                       "itm_label")}
    assert batch["image"].dtype == np.uint8
    variables = _jax_variables(cfg, batch)
    (jloss, jm), _ = JaxPretrain(cfg).apply(
        variables, *[jnp.asarray(batch[k]) for k in
                     ("image", "caption_masked", "caption_label",
                      "itm_label")], seq2seq=seq2seq, mutable=["batch_stats"])
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, variables)))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, m = model.loss(t["image"], t["caption_masked"],
                             t["caption_label"], t["itm_label"],
                             seq2seq=seq2seq, plain=True)
        host = torch.from_numpy(pT.normalize_image_var(
            batch["image"].transpose(0, 3, 1, 2)))
        loss_f32, _ = model.loss(host, t["caption_masked"],
                                 t["caption_label"], t["itm_label"],
                                 seq2seq=seq2seq, plain=True)
    for k in ("mlm_loss", "itm_loss", "loss"):
        assert abs(m[k].item() - float(jm[k])) <= 1e-4, k
    assert abs(loss.item() - loss_f32.item()) <= 1e-5


# ---- train_pretrain ------------------------------------------------------------

def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    return {k: [r[k] for r in rows] for k in ("mlm_loss", "itm_loss",
                                              "loss")}


def test_train_pretrain_matches_jax(tmp_path, monkeypatch):
    B, EPOCHS, SAMPLES = 8, 2, 16
    cfg = _tiny_pretrain_config()
    jset = jds.PretrainDataset(jds.SyntheticSource(n=SAMPLES, image_size=IMG),
                               JaxTokenizer(), max_length=24)
    pset = pds.PretrainDataset(pds.SyntheticSource(n=SAMPLES, image_size=IMG),
                               WordPieceTokenizer(), max_length=24)
    # the port saves and exports after the last epoch; JAX, whose sharded
    # checkpoint takes most of this test's time, neither saves nor exports:
    # the port's export is held to JAX's trained parameters
    tc = dict(batch_size=B, epochs=EPOCHS, seed=0, log_every=1,
              num_workers=0)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jrun = JaxRunner(JaxPretrain(cfg), cfg, jcfg.TrainConfig(
        **tc, checkpoint_every_epochs=EPOCHS + 1, mesh=jcfg.MeshConfig()),
        workdir=jdir, name="jax-pretrain-parity")
    sample = {k: np.asarray(v)[None] for k, v in jset[0].items()}
    variables = _jax_variables(cfg, sample)
    start = params_from_flax({"params": jax.tree.map(np.asarray,
                                                     variables["params"])})
    state = create_train_state(jrun.model, variables, make_optimizer(cfg))
    jrun.state, jrun.shardings = shard_train_state(state, jrun.mesh)
    prun = TaskRunner(PretrainModel, _port_config(cfg), pcfg.TrainConfig(
        **tc, checkpoint_every_epochs=EPOCHS, bf16_compute=False),
        workdir=pdir, name="port-pretrain-parity", device="cpu")
    prun.init_state(pretrained_variables=start)

    flips, coin = [], jax_pretrain.seq2seq_coin_flip

    def record(key):
        flips.append(coin(key))
        return flips[-1]

    monkeypatch.setattr(jax_pretrain, "seq2seq_coin_flip", record)
    jax_pretrain.train_pretrain(jrun, jset)
    replay = iter(flips)
    monkeypatch.setattr(port_pretrain, "seq2seq_coin_flip",
                        lambda generator: next(replay))
    port_pretrain.train_pretrain(prun, pset, export_dir=str(tmp_path / "pt"))

    steps = EPOCHS * (SAMPLES // B)
    assert len(flips) == steps and 0 < sum(flips) < steps
    assert next(replay, None) is None
    jl, pl = _losses(jdir), _losses(pdir)
    for k in jl:
        assert len(jl[k]) == len(pl[k]) == steps
        np.testing.assert_allclose(pl[k], jl[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert prun.state.step == steps
    # the port's checkpoint, its export and the numbered snapshot of the
    # last epoch
    assert f"step_{steps:08d}" in os.listdir(pdir)
    assert (tmp_path / f"pt_epoch{EPOCHS - 1}" / "model.pt").exists()
    pconf, psd = pckpt.load_pretrained(str(tmp_path / "pt"))
    assert pconf.to_json() == cfg.to_json()
    want = params_from_flax({"params": jax.tree.map(
        np.asarray, jax.device_get(jrun.state.params))})
    assert want.keys() == psd.keys()
    for k in want:
        np.testing.assert_allclose(psd[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_batch_mode_is_seeded_by_epoch_and_batch():
    """The flip of (epoch, batch) depends on the seed and those two alone:
    a resumed run flips what the run it resumes would have flipped."""
    tc = pcfg.TrainConfig(seed=3)
    a = [port_pretrain.batch_mode(tc, e, i) for e in range(3)
         for i in range(20)]
    b = [port_pretrain.batch_mode(tc, e, i) for e in range(3)
         for i in range(20)]
    assert a == b and 10 < sum(a) < 50
    other = [port_pretrain.batch_mode(pcfg.TrainConfig(seed=4), e, i)
             for e in range(3) for i in range(20)]
    assert other != a


# ---- the entry point -----------------------------------------------------------

def test_run_pretrain_cli_writes_checkpoints_and_exports(tmp_path):
    """``python -m mvlt_tpu_torch.run_pretrain --synthetic --tiny --device
    cpu --epochs 1`` trains one epoch (64 samples, 2 steps of b32) and writes
    its log, metrics, a checkpoint and both exports; the export merges into
    a fresh VQA runner, every shared tensor loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "mvlt_tpu_torch.run_pretrain", "--synthetic",
         "--tiny", "--device", "cpu", "--epochs", "1", "--num_workers", "0",
         "--model_name", str(tmp_path / "pt"),
         "--export_dir", str(tmp_path / "export")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(os.listdir(tmp_path / "pt"))
    assert {"log.txt", "metrics.jsonl", "step_00000002"} <= names
    for d in ("export", "export_epoch0"):
        assert {"config.json", "model.pt"} <= set(os.listdir(tmp_path / d))
    assert "epoch 0 done" in (tmp_path / "pt" / "log.txt").read_text()

    from mvlt_tpu_torch.models.heads import VQAModel
    cfg, sd = pckpt.load_pretrained(str(tmp_path / "export"))
    vqa_cfg = dataclasses.replace(cfg, result_num=4)
    runner = TaskRunner(VQAModel, vqa_cfg, pcfg.TrainConfig(), device="cpu",
                        name="vqa-from-export")
    lines = []
    runner.logger.info = lambda fmt, *a: lines.append(fmt % a)
    runner.init_state(pretrained_variables=sd)
    own = runner.model.state_dict()
    shared = [k for k in own if k in sd]
    assert all(torch.equal(own[k], sd[k]) for k in shared)
    assert len(shared) == len(own) - 2          # all but final_mlp
    assert lines and lines[-1].startswith("loaded ")


def test_run_pretrain_refusals(tmp_path):
    from mvlt_tpu_torch import run_pretrain
    base = ["--synthetic", "--tiny", "--epochs", "1",
            "--model_name", str(tmp_path / "x"),
            "--export_dir", str(tmp_path / "e")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_pretrain.main(base + ["--device", "cuda"])
    # one process holds no (1, 2) mesh: JAX's build_mesh error (a
    # multi-device run is one process a device, under torchrun)
    with pytest.raises(ValueError, match="does not divide device count 1"):
        run_pretrain.main(base + ["--device", "cpu", "--model_parallel", "2"])
    # --conv vit and linear run since they were ported; a conv that JAX
    # does not have is refused
    with pytest.raises(NotImplementedError, match="no such config.conv"):
        run_pretrain.main(base + ["--device", "cpu", "--conv", "vgg"])
    with pytest.raises(SystemExit, match="no data source"):
        run_pretrain.main(["--device", "cpu", "--model_name",
                           str(tmp_path / "y")])


def test_run_pretrain_build_source_keeps_one_image_layout(corpus):
    """ROCO alone decodes to uint8 for the device normalize; beside RGC
    pickles it decodes to f32 (a batch holds one layout; JAX's driver
    leaves ROCO on uint8 there), and so it does with --host_normalize."""
    from mvlt_tpu_torch import run_pretrain
    args = lambda *a: run_pretrain.parse_args(list(a))
    alone = run_pretrain.build_source(args("--roco_root", corpus["roco_root"]))
    assert alone.normalize == "device" and alone[0][0].dtype == np.uint8
    assert run_pretrain.build_source(args(
        "--roco_root", corpus["roco_root"], "--host_normalize")
    ).normalize == "host"
    mixed = run_pretrain.build_source(args("--rgc_index", corpus["rgc_index"],
                                           "--roco_root", corpus["roco_root"]))
    assert mixed.sources[1].normalize == "host"
    for i in (0, N):
        assert mixed[i][0].dtype == np.float32 and mixed[i][0].shape[0] == 3


def test_write_synthetic_pretrain_without_roco(tmp_path, corpus):
    """``roco=False`` writes the same RGC pickles and uint8 cache as the
    full corpus from the same seed, and no ROCO split."""
    out = pds.write_synthetic_pretrain(str(tmp_path), N, IMG, seed=0,
                                       roco=False)
    assert set(out) == {"rgc_index", "u8_cache"}
    assert not (tmp_path / "roco").exists()
    for kind in ("pickle", "u8"):
        a, b = _sources(pds, kind, out), _sources(pds, kind, corpus)
        assert len(a) == len(b) == N
        for i in range(N):
            np.testing.assert_array_equal(a[i][0], b[i][0])
            assert a[i][1:] == b[i][1:]
