"""The port's VQA driver against the JAX package's: ``_merge_pretrained``'s
counts, ``train_vqa`` on both packages from one parameter tree, the entry
point ``python -m mvlt_tpu_torch.run_vqa`` and its refusals.

``train_vqa`` runs JAX's ``tiny_config`` (Swin 32 px, embed 16, depths
(1, 1); fusion 64 wide, 2 layers) with fusion dropouts 0 and DropPath 0,
in float32 on both sides (the port's runner with ``bf16_compute=False``;
JAX's ``VQAModel`` computes in f32 by default), lr 1e-3 so that 2 epochs
move the answers. JAX trains on its 8-device CPU mesh (one sample a
shard, the loss normalized over the batch), the port on the CPU. The per-step losses
agree within 1e-4; the per-epoch valid accuracy, the best epoch and the
``test`` / ``test_final`` accuracies are equal, and so are the predictions
of the valid split after training."""

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

from mvlt_tpu import config as jcfg
from mvlt_tpu.data.datasets import MedVQADataset as JaxVQADataset
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu.tasks.common import TaskRunner as JaxRunner
from mvlt_tpu.tasks.common import _merge_pretrained as jax_merge
from mvlt_tpu.tasks.vqa import eval_vqa as jax_eval
from mvlt_tpu.tasks.vqa import train_vqa as jax_train
from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from mvlt_tpu.train import (create_train_state, make_optimizer,
                            shard_train_state)
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.data.datasets import MedVQADataset
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.tasks.common import TaskRunner, _merge_pretrained
from mvlt_tpu_torch.tasks.vqa import eval_vqa, train_vqa
from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
B, EPOCHS, LR = 8, 3, 3e-3


def _port_config(cfg):
    """The port's config with the same fields as a JAX one."""
    return pcfg.MVLTConfig.from_json(cfg.to_json())


def _jax_variables(cfg):
    """JAX's ``VQAModel`` variables under ``PRNGKey(0)``, as
    ``TaskRunner.init_state`` draws them, traced once under ``jax.jit``
    (eager flax init of the Swin takes about 20 s on the CPU)."""
    img = jnp.zeros((1, 3, 32, 32), jnp.float32)
    q = jnp.ones((1, 23), jnp.int32)
    return jax.jit(JaxVQA(cfg).init)(jax.random.PRNGKey(0), img, q)


def _jax_config(tok):
    cfg = jcfg.MVLTConfig.for_vqa(result_num=4, lr=LR)
    cfg = jcfg.tiny_config(cfg).with_tokenizer(tok)
    return dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, num_hidden_layers=1, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))


def _entries(n, seed):
    """Questions whose answer (0-3) depends on the words, over 8 images;
    OPEN / CLOSED alternating, one unanswerable question."""
    rng = np.random.default_rng(seed)
    words = ("lung", "heart", "liver", "brain")
    out = []
    for i in range(n):
        a = int(rng.integers(0, 4))
        out.append({"img_id": int(rng.integers(0, 8)),
                    "question": f"is the {words[a]} normal ?",
                    "label": None if i == 3 else a,
                    "answer_type": "OPEN" if i % 2 else "CLOSED"})
    return out


def _datasets(cls, tok):
    images = np.random.default_rng(0).normal(
        size=(8, 3, 32, 32)).astype(np.float32)
    out = []
    for n, seed in ((32, 1), (12, 2), (12, 3)):
        ds = cls.from_arrays(images, _entries(n, seed),
                             {str(i): i for i in range(4)})
        ds.tokenize(tok)
        out.append(ds)
    return out


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _valid_accs(lines):
    return [float(l.split()[-1]) for l in lines if "valid acc" in l]


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(l)["loss"] for l in f]


def test_merge_pretrained_counts_equal_jax():
    """A partial tree (the fusion encoder and the Swin patch embedding, one
    tensor of a wrong shape) merges the same count of leaves in both
    packages; the port's fused qkv counts as JAX's three Denses."""
    tok = JaxTokenizer()
    cfg = _jax_config(tok)
    variables = _jax_variables(cfg)
    params = jax.tree.map(np.asarray, variables["params"])
    partial = {"fusion": params["fusion"],
               "conv": {"backbone": {"patch_embed":
                                     params["conv"]["backbone"]["patch_embed"]}},
               "final_mlp": {"kernel": np.zeros((3, 3), np.float32)}}

    class _Log:
        def __init__(self):
            self.args = None

        def info(self, fmt, *args):
            self.args = args

    jlog, plog = _Log(), _Log()
    jax_merge(variables, {"params": partial}, jlog)
    model = VQAModel(_port_config(cfg))
    sd = params_from_flax({"params": {k: v for k, v in partial.items()
                                      if k != "final_mlp"}})
    sd["final_mlp.weight"] = torch.zeros(3, 3)
    used, total = _merge_pretrained(model, sd, plog)
    assert plog.args == (used, total) == jlog.args
    assert 0 < used < total
    got = model.state_dict()["fusion.layers.0.qkv.weight"]
    want = np.concatenate([params["fusion"]["layer_0"]["attention"][k]
                           ["kernel"].T for k in ("query", "key", "value")])
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_vqa_matches_jax(tmp_path):
    jtok, ptok = JaxTokenizer(), WordPieceTokenizer()
    cfg = _jax_config(jtok)
    jtrain, jvalid, jtest = _datasets(JaxVQADataset, jtok)
    ptrain, pvalid, ptest = _datasets(MedVQADataset, ptok)
    for a, b in zip((jtrain, jvalid, jtest), (ptrain, pvalid, ptest)):
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i]["question"], b[i]["question"])

    tc = dict(batch_size=B, epochs=EPOCHS, seed=0, log_every=1,
              num_workers=0)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jrun = JaxRunner(JaxVQA(cfg), cfg, jcfg.TrainConfig(
        **tc, mesh=jcfg.MeshConfig()), workdir=jdir, name="jax-vqa-parity")
    # init_state's body (tasks/common.py:104-110) on jitted variables
    variables = _jax_variables(cfg)
    start = params_from_flax({"params": jax.tree.map(np.asarray,
                                                     variables["params"])})
    state = create_train_state(jrun.model, variables, make_optimizer(cfg))
    jrun.state, jrun.shardings = shard_train_state(state, jrun.mesh)
    prun = TaskRunner(VQAModel, _port_config(cfg), pcfg.TrainConfig(
        **tc, bf16_compute=False), workdir=pdir, name="port-vqa-parity",
        device="cpu")
    prun.init_state(pretrained_variables=start)

    logs = {}
    for name in ("jax-vqa-parity", "port-vqa-parity"):
        logs[name] = _Lines()
        logging.getLogger(name).addHandler(logs[name])
    jbest = jax_train(jrun, jtrain, jvalid, jtest)
    pbest = train_vqa(prun, ptrain, pvalid, ptest)

    jl, pl = _losses(jdir), _losses(pdir)
    assert len(jl) == len(pl) == EPOCHS * (32 // B)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    assert jl[-1] < jl[0]
    assert _valid_accs(logs["port-vqa-parity"].lines) == \
        _valid_accs(logs["jax-vqa-parity"].lines)
    assert pbest == jbest, (pbest, jbest)
    assert set(pbest) == {"valid_acc", "epoch", "test_final", "test"}
    # predictions after training (the best-valid weights on both sides)
    jp, pp = tmp_path / "jax.json", tmp_path / "port.json"
    jax_eval(jrun, jvalid, B, predictions_path=str(jp))
    eval_vqa(prun, pvalid, B, predictions_path=str(pp))
    assert json.loads(pp.read_text()) == json.loads(jp.read_text())
    # both restored the best epoch's checkpoint
    assert prun.state.step == int(jrun.state.step) == \
        (jbest["epoch"] + 1) * (32 // B)


def test_run_vqa_cli_writes_results(tmp_path):
    """``python -m mvlt_tpu_torch.run_vqa --synthetic --tiny --device cpu``
    trains 2 epochs and writes ``results.json`` with JAX's keys, a log, the
    metrics stream and the best-valid checkpoint."""
    out = tmp_path / "vqa"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "mvlt_tpu_torch.run_vqa", "--synthetic",
         "--tiny", "--device", "cpu", "--epochs", "2", "--batch_size", "8",
         "--num_workers", "0", "--model_name", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads((out / "results.json").read_text())
    assert len(results) == 1
    assert set(results[0]) == {"valid_acc", "epoch", "test_final", "test"}
    for split in ("test", "test_final"):
        assert set(results[0][split]) == {"overall", "total", "correct",
                                          "open", "closed"}
        assert results[0][split]["total"] == 8
    names = os.listdir(out / "round0")
    assert {"log.txt", "metrics.jsonl"} <= set(names)
    assert any(n.startswith("step_") for n in names)
    assert "jax" not in proc.stdout


def test_runner_and_driver_refuse_what_the_port_lacks(tmp_path):
    cfg = pcfg.tiny_config(pcfg.MVLTConfig.for_vqa(result_num=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TaskRunner(VQAModel, cfg, pcfg.TrainConfig())
        from mvlt_tpu_torch import run_vqa
        with pytest.raises(RuntimeError, match="CUDA"):
            run_vqa.main(["--synthetic", "--tiny", "--model_name",
                          str(tmp_path / "x")])
    with pytest.raises(NotImplementedError, match="Multi-device"):
        TaskRunner(VQAModel, cfg, pcfg.TrainConfig(
            mesh=pcfg.MeshConfig(model_parallel=2)), device="cpu")


def test_eval_forward_of_f32_masters_feeds_k1_one_dtype(monkeypatch):
    """The driver's eval runs the serving forward of a model with f32
    master weights and bf16 compute (``TrainConfig.bf16_compute``) and the
    dataset's answer count. Walked on the meta device at Swin-S +
    BERT-base, b64, 222 answers: every product reaches ``gemm`` with
    operands, bias and residual in bf16 and contiguous dims that are
    multiples of 8, as K1 takes them (stage 4's half blocks once passed
    their f32 masters, and the answer head N = 222), and the counterparts
    run as often as in the flagship forward."""
    from mvlt_tpu_torch.flagship import flagship_vqa_config
    from mvlt_tpu_torch.ops import blocks

    calls, shapes, counts = [], [], {}
    gemm = blocks.PLAIN_OPS.gemm

    def checked(a, w, bias=None, **kw):
        res = kw.get("residual")
        calls.append((a.dtype, w.dtype, None if bias is None else bias.dtype,
                      None if res is None else res.dtype))
        shapes.append((a.shape[-1], w.shape[0]))
        return gemm(a, w, bias, **kw)

    monkeypatch.setattr(blocks.PLAIN_OPS, "gemm", checked)
    for name in ("swin_full_block", "window_block_attention",
                 "fused_mlp_preln", "fused_attn_ln", "fused_mlp_ln"):
        fn = getattr(blocks.PLAIN_OPS, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(blocks.PLAIN_OPS, name, counted)
    # a dataset's own answer count (len(ans2label)), not a multiple of 8
    cfg = dataclasses.replace(flagship_vqa_config(), result_num=222)
    model = VQAModel(cfg, dtype=torch.float32, device="meta",
                     compute_dtype=torch.bfloat16)
    image = torch.empty(64, 3, 224, 224, device="meta")
    question = torch.ones(64, 23, dtype=torch.int32, device="meta")
    _, logits = model(image, question, plain=True)
    assert logits.shape == (64, 222) and logits.dtype == torch.bfloat16
    # K1's contiguous dims are multiples of 8: the answer head is F.linear
    assert shapes and all(k % 8 == 0 and n % 8 == 0 for k, n in shapes)
    assert counts == {"swin_full_block": 22, "window_block_attention": 2,
                      "fused_mlp_preln": 2, "fused_attn_ln": 12,
                      "fused_mlp_ln": 12}
    assert calls and all(d in (None, torch.bfloat16)
                         for call in calls for d in call), set(calls)


def test_config_pieces_match_jax():
    """``TrainConfig`` and ``MeshConfig`` keep every field and default of
    JAX's; ``tiny_config``, ``for_vqa`` and ``to_json`` / ``from_json``
    give the same text for the same config."""
    assert dataclasses.asdict(pcfg.TrainConfig()) == \
        dataclasses.asdict(jcfg.TrainConfig())
    assert dataclasses.asdict(pcfg.MeshConfig(model_parallel=2)) == \
        dataclasses.asdict(jcfg.MeshConfig(model_parallel=2))
    for make in (lambda m: m.MVLTConfig.for_vqa(result_num=7, lr=1e-3),
                 lambda m: m.tiny_config(m.MVLTConfig.for_vqa()),
                 lambda m: m.MVLTConfig()):
        text = make(jcfg).to_json()
        assert make(pcfg).to_json() == text
        assert pcfg.MVLTConfig.from_json(text).to_json() == text
