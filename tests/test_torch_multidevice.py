"""The port's multi-device steps against the JAX package's on the same mesh,
on the CPU: gloo process groups of 2 and 4 spawned ranks (a ``file://``
store under a temporary directory, two torch threads a rank), JAX on the
virtual CPU devices of ``tests/conftest.py`` in the test process.

- The tiny pretrain step (``mvlt_tpu.flagship.tiny_pretrain_config``,
  dropouts 0) at DP 2, TP 2 and DP 2 x TP 2 against ``make_pretrain_step``
  on the same mesh, three steps in both mask modes: metrics and updated
  parameters within 1e-4, on a batch whose data shards carry different
  numbers of valid MLM labels (the case ``ops/layers.py:101-107`` exists
  for); the replicas bitwise equal.
- The linear-patch VQA step at DP 2 against JAX's GSPMD step: loss, the
  gradients (against ``jax.grad`` of the global batch), the BatchNorm
  running statistics and the updated parameters.
- Port against port: the global-norm clip under TP 2, and DP 2 with each
  rank replaying its rows of the one-process step's masks (dropout 0.1),
  against the one-process step; ``train_vqa`` at DP 2 on the tiny
  synthetic SLAKE against one process (losses and predictions).
- A checkpoint saved at mp = 2 restores at mp = 1 bitwise, and one saved
  at mp = 1 restores at mp = 2 bitwise.
- ``dryrun_multichip(4, device="cpu")`` ends with a finite loss.
- In-kernel attention dropout at TP 2: each rank's draws are bitwise its
  heads' slice of one process's.
- ``decode_reports`` / ``eval_vqa`` whose last batch is shorter than dp
  (a rank with no rows of it) at dp 2 and 4 against one process.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models.heads import PretrainModel, VQAModel
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.parallel import build_mesh, initialize_distributed, shard
from mvlt_tpu_torch.train.state import TrainState, make_optimizer
from mvlt_tpu_torch.train.steps import (make_pretrain_step, make_vqa_step,
                                        rank_rows, shard_train_state)
from mvlt_tpu_torch.utils import checkpoint as ckpt_lib

torch.set_num_threads(2)

B, L, IMG = 4, 8, 32
MODES = (False, True, False)
TOL = 1e-4


# ---------------------------------------------------------------------------
# the ranks (spawned; this module imports no JAX at its top)
# ---------------------------------------------------------------------------

def _model(cls, a):
    cfg = pcfg.MVLTConfig.from_json(a["cfg"])
    model = cls(cfg, dtype=torch.float32, device="cpu",
                compute_dtype=a.get("compute"))
    model.load_state_dict(a["sd"])
    return cfg, model


def _on_mesh(cls, a, clip=None):
    cfg, model = _model(cls, a)
    opt = make_optimizer(model, cfg, grad_clip_norm=clip)
    mesh = build_mesh(pcfg.MeshConfig(model_parallel=a["mp"]), device="cpu")
    state = shard_train_state(TrainState(model, opt), mesh)
    return state, mesh


def _mask_rows(masks, mesh, rows: int):
    """This data rank's rows of one step's recorded masks."""
    return [m if m.shape[0] != rows else rank_rows({"m": m.numpy()}, mesh)["m"]
            for m in masks]


def _pretrain_case(a, rank):
    state, mesh = _on_mesh(PretrainModel, a, a.get("clip"))
    step = make_pretrain_step(state.model, state.optimizer, mesh=mesh)
    metrics = []
    for i, seq2seq in enumerate(a["modes"]):
        if a.get("masks"):
            step.masks = DropoutMasks.replay(
                _mask_rows(a["masks"][i], mesh, len(a["batch"]["image"])))
        m = step(step.shard_batch(a["batch"]), seq2seq)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": shard.full_state_dict(state.model)}
    if a.get("save"):
        ckpt_lib.save_checkpoint(a["save"], state, step=len(a["modes"]),
                                 async_save=False)
        out["opt"] = shard.full_optimizer_state(state.optimizer, state.model)
    return out


def _vqa_case(a, rank):
    state, mesh = _on_mesh(VQAModel, a)
    step = make_vqa_step(state.model, state.optimizer, mesh=mesh)
    m = step(step.shard_batch(a["batch"]))
    model = state.model
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "params": shard.full_state_dict(model)}


def _restore_case(a, rank):
    """A one-device checkpoint restored into a TP model: its slices."""
    state, mesh = _on_mesh(PretrainModel, a)
    state, ok = ckpt_lib.restore_checkpoint(a["path"], state)
    full = torch.load(os.path.join(a["path"], "state.pt"), weights_only=True)
    want = shard.local_state_dict(state.model, full["model"])
    got = state.model.state_dict()
    same = ok and all(torch.equal(got[k], want[k]) for k in want)
    opt = state.optimizer.state_dict()["state"]
    want_opt = shard.local_optimizer_state(full["optimizer"],
                                           state.model)["state"]
    same_opt = all(torch.equal(opt[i][k], want_opt[i][k])
                   for i in want_opt for k in want_opt[i])
    return {"same": same, "same_opt": same_opt, "step": state.step,
            "split": len(shard.split_shardings(state.model))}


def _train_vqa_case(a, rank):
    from mvlt_tpu_torch.models.heads import VQAModel as Model
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.vqa import eval_vqa, train_vqa
    train, valid, test = _vqa_datasets()
    cfg = pcfg.MVLTConfig.from_json(a["cfg"])
    runner = TaskRunner(Model, cfg, pcfg.TrainConfig(**a["tc"]),
                        workdir=a["workdir"], device="cpu")
    runner.init_state()
    best = train_vqa(runner, train, valid, test, epochs=a["epochs"])
    eval_vqa(runner, test, 8, predictions_path=os.path.join(a["workdir"],
                                                            "preds.json"))
    return {"best": best}


def _adrop_case(a, rank):
    """The pretrain step with in-kernel attention dropout (bf16 compute):
    each TP rank keys the Philox draw of its heads by their global index.
    Every mask that K2 / K4's plain versions draw is recorded with the
    global index of its first head."""
    from mvlt_tpu_torch.ops import kernels
    plain, masks = kernels._adrop_mask, []

    def record(adrop, G, num_heads, N):
        m = plain(adrop, G, num_heads, N)
        masks.append((kernels.adrop_head0(adrop), m.clone()))
        return m

    os.environ["MVLT_KERNEL_DROPOUT"] = "1"
    kernels._adrop_mask = record
    try:
        state, mesh = _on_mesh(PretrainModel, a)
        step = make_pretrain_step(state.model, state.optimizer, mesh=mesh)
        step.masks = DropoutMasks(torch.Generator().manual_seed(5))
        m = step(step.shard_batch(a["batch"]), False)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "masks": masks}
    finally:
        kernels._adrop_mask = plain
        del os.environ["MVLT_KERNEL_DROPOUT"]


def _generate_case(a, rank):
    """Greedy and beam-2 report generation of a tiny ``CaptionModel`` (f32)
    on the mesh: the prefill and the cached decode on the rank's heads,
    the split vocabulary's logits gathered (or the word embedding's masked
    lookup, where the rule splits it)."""
    from mvlt_tpu_torch.models.generation import GenerationSpec, generate
    from mvlt_tpu_torch.models.heads import CaptionModel
    cfg = pcfg.MVLTConfig.from_json(a["cfg"])
    model = CaptionModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(a["sd"])
    if a["mp"] > 1:
        shard.apply_mesh_(model, build_mesh(
            pcfg.MeshConfig(model_parallel=a["mp"]), device="cpu"))
    image = torch.as_tensor(a["image"])
    out = {}
    for beams in (1, 2):
        spec = GenerationSpec.from_config(cfg, num_beams=beams)
        out[beams] = [t.clone() for t in generate(model, image, spec)]
    return out


def _eval_case(a, rank):
    """``decode_reports`` and ``score_grid`` on a runner over the world's
    mesh (f32): each data rank its rows, gathered in order. ``a`` may set
    the reports' batch size (``reports``), the grid's number of images
    (``grid_n``, 8 by default: ``--synthetic --tiny``'s test split) and add
    ``eval_vqa`` at a batch size (``vqa``)."""
    from mvlt_tpu_torch import run_report_generation as rg
    from mvlt_tpu_torch import run_retrieval as rr
    from mvlt_tpu_torch.data.datasets import RetrievalDataset, SyntheticSource
    from mvlt_tpu_torch.models.heads import CaptionModel, RetrievalModel
    from mvlt_tpu_torch.tasks.caption import decode_reports
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.retrieval import score_grid
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    tok = default_tokenizer(synthetic_ok=True)
    tc = pcfg.TrainConfig(bf16_compute=False, num_workers=0)
    args = rg.parse_args(["--dataset", "synthetic", "--tiny"])
    cfg = rg.build_config(args, tok, 12)
    runner = TaskRunner(CaptionModel, cfg, tc, device="cpu")
    runner.init_state()
    _, test = rg.build_datasets(args, tok, 12)
    out = {"reports": decode_reports(runner, test, tok,
                                     batch_size=a.get("reports", 6),
                                     num_beams=1)}
    if a.get("vqa"):
        from mvlt_tpu_torch.tasks.vqa import eval_vqa
        vqa = TaskRunner(VQAModel, pcfg.MVLTConfig.from_json(
            _tiny_vqa_config()), tc, device="cpu")
        vqa.init_state()
        out["vqa"] = eval_vqa(vqa, _vqa_datasets()[2], a["vqa"])
    args = rr.parse_args(["--synthetic", "--tiny"])
    runner = TaskRunner(RetrievalModel, rr.build_config(args, tok), tc,
                        device="cpu")
    runner.init_state()
    test = RetrievalDataset(SyntheticSource(n=a.get("grid_n", 8),
                                            image_size=32, seed=1), tok,
                            args.max_length, "test")
    out["grid"] = score_grid(runner, test, 3)
    return out


CASES = {"pretrain": _pretrain_case, "vqa": _vqa_case,
         "restore": _restore_case, "train_vqa": _train_vqa_case,
         "adrop": _adrop_case, "generate": _generate_case,
         "eval": _eval_case}


def _rank_main(rank, world, tmp):
    torch.set_num_threads(2)
    initialize_distributed(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        jobs = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = [CASES[kind](a, rank) for kind, a in jobs]
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world, jobs):
    """Run ``jobs`` [(case, args)] in order on ``world`` gloo ranks; returns
    each rank's list of results."""
    os.makedirs(tmp, exist_ok=True)
    torch.save(jobs, os.path.join(tmp, "in.pt"))
    mp.spawn(_rank_main, args=(world, str(tmp)), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _vqa_datasets():
    from mvlt_tpu_torch import run_vqa
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    args = run_vqa.parse_args(["--synthetic", "--tiny", "--device", "cpu"])
    tok = default_tokenizer(synthetic_ok=True)
    return run_vqa.build_datasets(args, tok)


# ---------------------------------------------------------------------------
# the JAX side (the test process)
# ---------------------------------------------------------------------------

def _jax_pretrain_config():
    from mvlt_tpu.flagship import tiny_pretrain_config
    return tiny_pretrain_config()          # fusion dropouts 0, DropPath 0


def _jax_vqa_config():
    from mvlt_tpu import config as jcfg
    cfg = jcfg.MVLTConfig.for_vqa(result_num=6)
    fusion = dataclasses.replace(
        cfg.fusion, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, vocab_size=300,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return dataclasses.replace(cfg, conv="linear", fusion=fusion, lr=1e-3)


def _pretrain_batch():
    """B = 4 rows whose halves carry 5 + 5 and 1 + 1 valid MLM labels."""
    rng = np.random.default_rng(3)
    label = np.full((B, L), -100)
    for b, n in enumerate((5, 5, 1, 1)):
        label[b, :n] = rng.integers(1, 400, n)
    return {"image": rng.normal(size=(B, 3, IMG, IMG)).astype(np.float32),
            "caption_masked": rng.integers(1, 400, (B, L)),
            "caption_label": label,
            "itm_label": rng.integers(0, 2, (B,))}


def _vqa_batch():
    rng = np.random.default_rng(4)
    return {"image": rng.normal(size=(B, 3, IMG, IMG)).astype(np.float32),
            "question": np.where(np.arange(L) < 6, rng.integers(
                1, 300, (B, L)), 0),
            "label": rng.integers(0, 6, (B,))}


def _perturb(tree, seed):
    import jax
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


def _jax_init(model, args):
    import jax
    v = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    out = {"params": _perturb(v["params"], 1)}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree.map(np.asarray, v["batch_stats"])
    return out


def _jax_steps(model, variables, make, batch, n, model_parallel, calls):
    """JAX's mesh step on ``n`` of the virtual devices: ``calls`` steps, each
    ``make(mesh, shardings, i)``. Returns (metrics, final variables)."""
    import jax
    from mvlt_tpu import config as jcfg
    from mvlt_tpu.parallel import build_mesh as jax_mesh
    from mvlt_tpu.train import (create_train_state, make_optimizer as jopt,
                                shard_train_state as jshard)
    mesh = jax_mesh(jcfg.MeshConfig(model_parallel=model_parallel),
                    devices=jax.devices()[:n])
    state = create_train_state(model, jax.tree.map(np.array, variables),
                               jopt(model.config))
    state, sh = jshard(state, mesh)
    metrics = []
    for i in range(calls):
        step = make(mesh, sh, i)
        state, m = step(state, step.shard_batch(batch),
                        jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"params": jax.tree.map(np.asarray, state.params)}
    out.update({k: jax.tree.map(np.asarray, v)
                for k, v in state.extra_variables.items()})
    return metrics, out


def _jax_pretrain(cfg, variables, batch, n, model_parallel):
    from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
    from mvlt_tpu.train import make_pretrain_step as jstep
    model = JaxPretrain(cfg)
    steps = {}                  # one program a mask mode, as JAX's loop

    def make(mesh, sh, i):
        if MODES[i] not in steps:
            steps[MODES[i]] = jstep(model, MODES[i], mesh=mesh,
                                    state_shardings=sh)
        return steps[MODES[i]]

    return _jax_steps(
        model, variables, make,
        {k: np.asarray(v, np.float32 if k == "image" else np.int32)
         for k, v in batch.items()}, n, model_parallel, len(MODES))


def _port_sd(variables):
    from mvlt_tpu_torch.utils.convert import params_from_flax
    return params_from_flax(variables)


def _close_sd(got, want, atol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=TOL, err_msg=k)


def _close_metrics(got, want):
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g, w)


# ---------------------------------------------------------------------------
# fixtures: one spawn a mesh shape, shared by its tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pretrain_inputs():
    import jax.numpy as jnp
    from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
    cfg = _jax_pretrain_config()
    batch = _pretrain_batch()
    args = [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32)
        for k in ("caption_masked", "caption_label", "itm_label")]
    variables = _jax_init(JaxPretrain(cfg), args)
    return cfg, variables, batch


def _port_one_process(cfg_json, sd, batch, modes, clip=None, masks=None,
                      rate=None):
    """The port's one-process steps (the reference of the port-only
    cases); ``rate`` sets the fusion dropouts and records the masks."""
    cfg = pcfg.MVLTConfig.from_json(cfg_json)
    model = PretrainModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    opt = make_optimizer(model, cfg, grad_clip_norm=clip)
    step = make_pretrain_step(model, opt)
    metrics, recorded = [], []
    for i, seq2seq in enumerate(modes):
        step.masks = DropoutMasks(torch.Generator().manual_seed(10 + i),
                                  record=True)
        m = step({k: torch.as_tensor(v) for k, v in batch.items()}, seq2seq)
        metrics.append({k: float(v) for k, v in m.items()})
        recorded.append(step.masks.recorded)
    return metrics, model.state_dict(), recorded


@pytest.fixture(scope="module")
def dp2(pretrain_inputs, tmp_path_factory):
    """World 2, mesh (2, 1): the pretrain step against JAX, the replayed
    masks, the linear-patch VQA step and ``train_vqa``."""
    import jax
    import jax.numpy as jnp
    from mvlt_tpu.models.heads import VQAModel as JaxVQA
    from mvlt_tpu.train import make_vqa_step as jvqa
    cfg, variables, batch = pretrain_inputs
    cfg_json, sd = cfg.to_json(), _port_sd(variables)
    want = _jax_pretrain(cfg, variables, batch, 2, 1)
    # the port's one-process step with dropout 0.1, its masks recorded
    drop = pcfg.MVLTConfig.from_json(cfg_json)
    drop = dataclasses.replace(drop, fusion=dataclasses.replace(
        drop.fusion, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1)).to_json()
    one = _port_one_process(drop, sd, batch, MODES)
    # the linear-patch VQA step
    vcfg = _jax_vqa_config()
    vbatch = _vqa_batch()
    jm = JaxVQA(vcfg)
    vargs = (jnp.asarray(vbatch["image"]),
             jnp.asarray(vbatch["question"], jnp.int32))
    vvars = _jax_init(jm, vargs)
    jbatch = {"image": np.asarray(vbatch["image"]),
              "question": np.asarray(vbatch["question"], np.int32),
              "label": np.asarray(vbatch["label"], np.int32)}

    def loss_fn(params):
        (loss, _), _ = jm.apply(
            dict(vvars, params=params), *vargs,
            jnp.asarray(jbatch["label"]), method=JaxVQA.loss,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return loss

    vgrads = jax.jit(jax.grad(loss_fn))(vvars["params"])
    vwant = _jax_steps(jm, vvars, lambda mesh, sh, i: jvqa(
        jm, mesh=mesh, state_shardings=sh), jbatch, 2, 1, 1)
    # train_vqa, one process
    tc = dict(batch_size=8, epochs=2, seed=0, num_workers=0,
              bf16_compute=False, log_every=1)
    tcfg = _tiny_vqa_config()
    tmp = tmp_path_factory.mktemp("dp2")
    one_vqa = _train_vqa_case({"cfg": tcfg, "tc": tc, "epochs": 2,
                               "workdir": str(tmp / "one")}, 0)
    jobs = [("pretrain", {"cfg": cfg_json, "sd": sd, "batch": batch,
                          "modes": MODES, "mp": 1}),
            ("pretrain", {"cfg": drop, "sd": sd, "batch": batch,
                          "modes": MODES, "mp": 1, "masks": one[2]}),
            ("vqa", {"cfg": _port_config_json(vcfg), "sd": _port_sd(vvars),
                     "batch": vbatch, "mp": 1}),
            ("train_vqa", {"cfg": tcfg, "tc": tc, "epochs": 2,
                           "workdir": str(tmp / "dp")}),
            ("eval", {}),
            ("eval", _SHORT_TAIL[2])]
    got = _spawn(tmp / "run", 2, jobs)
    return {"want": want, "one": one, "vgrads": vgrads, "vwant": vwant,
            "one_vqa": one_vqa, "got": got, "tmp": tmp,
            "one_eval": _eval_case({}, 0),
            "one_tail": _eval_case(_SHORT_TAIL[2], 0)}


# eval batch sizes whose last batch is shorter than dp (16 reports, 8 VQA
# questions): at dp 2 tails of 1 row, at dp 4 tails of 3 rows; and grids of
# fewer images than dp
_SHORT_TAIL = {2: {"reports": 5, "vqa": 7, "grid_n": 1},
               4: {"reports": 13, "vqa": 5, "grid_n": 3}}


def _port_config_json(cfg):
    return cfg.to_json()


def _tiny_vqa_config():
    """The ``--synthetic --tiny`` VQA config of ``run_vqa`` with dropouts 0
    (a data rank's masks are its own by design)."""
    from mvlt_tpu_torch import run_vqa
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    args = run_vqa.parse_args(["--synthetic", "--tiny", "--device", "cpu",
                               "--lr", "1e-3"])
    cfg = run_vqa.build_config(args, default_tokenizer(synthetic_ok=True), 4)
    return dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).to_json()


@pytest.fixture(scope="module")
def tp2(pretrain_inputs, tmp_path_factory):
    """World 2, mesh (1, 2): the pretrain step against JAX, the clip, and
    the checkpoints both ways."""
    cfg, variables, batch = pretrain_inputs
    cfg_json, sd = cfg.to_json(), _port_sd(variables)
    want = _jax_pretrain(cfg, variables, batch, 2, 2)
    clip_one = _port_one_process(cfg_json, sd, batch, MODES[:2], clip=0.05)
    tmp = tmp_path_factory.mktemp("tp2")
    # a one-device checkpoint after one step, for the mp = 2 restore
    pcfg_ = pcfg.MVLTConfig.from_json(cfg_json)
    model = PretrainModel(pcfg_, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    state = TrainState(model, make_optimizer(model, pcfg_))
    step = make_pretrain_step(model, state.optimizer)
    step({k: torch.as_tensor(v) for k, v in batch.items()}, False)
    state.step = 1
    one_ck = ckpt_lib.save_checkpoint(str(tmp / "one_ck"), state,
                                      async_save=False)
    adrop = _adrop_config(cfg_json)
    adrop_one = _adrop_case({"cfg": adrop, "sd": sd, "batch": batch,
                             "mp": 1, "compute": torch.bfloat16}, 0)
    jobs = [("pretrain", {"cfg": cfg_json, "sd": sd, "batch": batch,
                          "modes": MODES, "mp": 2,
                          "save": str(tmp / "tp_ck")}),
            ("adrop", {"cfg": adrop, "sd": sd, "batch": batch, "mp": 2,
                       "compute": torch.bfloat16}),
            ("pretrain", {"cfg": cfg_json, "sd": sd, "batch": batch,
                          "modes": MODES[:2], "mp": 2, "clip": 0.05}),
            ("restore", {"cfg": cfg_json, "sd": sd, "mp": 2,
                         "path": one_ck})]
    gen = [_generate_inputs(vocab) for vocab in (512, 511)]
    jobs += [("generate", dict(g, mp=2)) for g in gen]
    gen_one = [_generate_case(dict(g, mp=1), 0) for g in gen]
    got = _spawn(tmp / "run", 2, jobs)
    return {"want": want, "clip_one": clip_one, "got": got, "tmp": tmp,
            "cfg": cfg_json, "sd": sd, "adrop_one": adrop_one,
            "gen_one": gen_one}


def _generate_inputs(vocab: int):
    """A tiny caption model (f32 masters, seeded) whose vocabulary splits
    the MLM decoder at mp = 2 (512) or the word embedding's 512 rows (511),
    and three images."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.models.heads import CaptionModel
    cfg = pcfg.tiny_config(pcfg.MVLTConfig.for_caption(max_length=6))
    cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, vocab_size=vocab, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), eos_token_id=3, sep_token_id=2,
        cls_token_id=1, mask_token_id=4, pad_token_id=0)
    model = CaptionModel(cfg, dtype=torch.float32, device="cpu")
    flagship.init_seeded_(model, 3)
    image = np.random.default_rng(7).normal(
        size=(3, 3, IMG, IMG)).astype(np.float32)
    return {"cfg": cfg.to_json(), "sd": model.state_dict(), "image": image}


def _adrop_config(cfg_json):
    """The tiny pretrain config with attention dropout 0.1 computing in
    bf16 (where the in-kernel dropout gate opens)."""
    cfg = pcfg.MVLTConfig.from_json(cfg_json)
    return dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, attention_probs_dropout_prob=0.1)).to_json()


@pytest.fixture(scope="module")
def dp2tp2(pretrain_inputs, tmp_path_factory):
    """World 4, mesh (2, 2): the pretrain step against JAX; and the eval
    drivers at dp 4 with tails of 3 rows."""
    cfg, variables, batch = pretrain_inputs
    want = _jax_pretrain(cfg, variables, batch, 4, 2)
    got = _spawn(tmp_path_factory.mktemp("dp2tp2"), 4, [
        ("pretrain", {"cfg": cfg.to_json(), "sd": _port_sd(variables),
                      "batch": batch, "modes": MODES, "mp": 2}),
        ("eval", _SHORT_TAIL[4])])
    return want, got, _eval_case(_SHORT_TAIL[4], 0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["dp2", "tp2", "dp2tp2"])
def test_pretrain_step_matches_jax_on_the_mesh(mesh, request):
    """Three steps (bidirectional, seq2seq, bidirectional) of the tiny
    pretrain step: MLM / ITM / total loss and the updated parameters within
    1e-4 of JAX's step on the same mesh; the shards' valid-label counts
    differ (5 + 5 against 1 + 1)."""
    res = request.getfixturevalue(mesh)
    if mesh == "dp2tp2":
        (want_m, want_v), got = res[:2]
    else:
        (want_m, want_v), got = res["want"], res["got"]
    ranks = [r[0] for r in got]
    _close_metrics(ranks[0]["metrics"], want_m)
    _close_sd(ranks[0]["params"], _port_sd(want_v))


@pytest.mark.parametrize("mesh", ["dp2", "tp2", "dp2tp2"])
def test_mesh_replicas_stay_bitwise_equal(mesh, request):
    """Every rank's gathered parameters are bitwise equal after the three
    steps (the data group's gradient sum in a fixed order; the model
    group's replicated tensors computed alike)."""
    res = request.getfixturevalue(mesh)
    got = res[1] if mesh == "dp2tp2" else res["got"]
    first = got[0][0]["params"]
    for r in got[1:]:
        for k, v in r[0]["params"].items():
            assert torch.equal(v, first[k]), k
        assert r[0]["metrics"] == got[0][0]["metrics"]


def test_dp2_replayed_masks_match_one_process(dp2):
    """DP 2 with fusion dropout 0.1, each rank replaying its rows of the
    one-process step's masks: the losses and the parameters of the port's
    one-process step within 1e-4 (the plumbing of the masks)."""
    one_metrics, one_sd, _ = dp2["one"]
    got = dp2["got"][0][1]
    _close_metrics(got["metrics"], one_metrics)
    _close_sd(got["params"], one_sd)


def test_dp2_linear_patch_vqa_matches_jax_gspmd(dp2):
    """The linear-patch VQA step at DP 2 (BatchNorm on the global batch's
    moments): loss and updated parameters against JAX's GSPMD step, every
    gradient within 1e-4 x max|grad| of ``jax.grad`` on the global batch,
    the running statistics within 1e-4 and equal on both ranks."""
    want_m, want_v = dp2["vwant"]
    ranks = [r[2] for r in dp2["got"]]
    got = ranks[0]
    assert abs(got["metrics"]["loss"] - want_m[0]["loss"]) <= TOL
    assert abs(got["metrics"]["accuracy"] - want_m[0]["accuracy"]) <= TOL
    _close_sd(got["params"], _port_sd(want_v))
    gsd = _port_sd({"params": dp2["vgrads"]})
    top = max(float(v.abs().max()) for v in gsd.values())
    for k, w in gsd.items():
        err = float((got["grads"][k] - w).abs().max())
        if k == "conv.backbone.proj.bias":     # 0 in exact arithmetic
            assert err <= 1e-6 * top, k
            continue
        assert err <= TOL * max(float(w.abs().max()), 1e-12), (k, err)
    stats = want_v["batch_stats"]["conv"]["backbone"]["bn"]
    bn = "conv.backbone.bn."
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(got["buffers"][bn + ours].numpy(),
                                   np.asarray(stats[theirs]), atol=TOL,
                                   rtol=0)
        assert torch.equal(got["buffers"][bn + ours],
                           ranks[1]["buffers"][bn + ours])


def test_train_vqa_dp2_matches_one_process(dp2):
    """``train_vqa`` at DP 2 (two epochs of the tiny synthetic SLAKE, batch
    8, f32, dropouts 0): every logged loss within 1e-4 of one process's,
    and the same accuracies and test predictions."""
    tmp = dp2["tmp"]

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    one, dp = losses(tmp / "one"), losses(tmp / "dp")
    assert len(one) == len(dp) > 0
    np.testing.assert_allclose(dp, one, atol=TOL, rtol=TOL)
    want, got = dp2["one_vqa"]["best"], dp2["got"][0][3]["best"]
    assert got["epoch"] == want["epoch"]
    for split in ("test", "test_final"):
        assert got[split]["correct"] == want[split]["correct"]
    with open(tmp / "one" / "preds.json") as f, \
            open(tmp / "dp" / "preds.json") as g:
        assert json.load(f) == json.load(g)


def test_global_norm_clip_under_tp2_matches_one_process(tp2):
    """``grad_clip_norm`` 0.05 (clipping every step) at TP 2: the split
    tensors' squares summed over the model group, the replicated ones
    counted once, so the losses and parameters after two steps equal one
    process's within 1e-4."""
    one_metrics, one_sd, _ = tp2["clip_one"]
    got = tp2["got"][0][2]
    _close_metrics(got["metrics"], one_metrics)
    _close_sd(got["params"], one_sd)


def test_checkpoint_saved_at_mp2_restores_at_mp1_bitwise(tp2):
    """The TP 2 ranks' save (split tensors and AdamW moments gathered,
    world rank 0 writing) restores into a one-device model and optimizer
    bitwise equal to what the ranks held."""
    got = tp2["got"][0][0]
    cfg = pcfg.MVLTConfig.from_json(tp2["cfg"])
    model = PretrainModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(tp2["sd"])
    state = TrainState(model, make_optimizer(model, cfg))
    state, ok = ckpt_lib.restore_checkpoint(str(tp2["tmp"] / "tp_ck"), state)
    assert ok and state.step == len(MODES)
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["params"][k]), k
    opt = state.optimizer.state_dict()["state"]
    for i, st in got["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(opt[i][k], v), (i, k)


def test_checkpoint_saved_at_mp1_restores_at_mp2_bitwise(tp2):
    """A one-device checkpoint restored at TP 2: every rank's parameters
    and AdamW moments are bitwise the slices of the saved tensors."""
    for r in tp2["got"]:
        res = r[3]
        assert res["same"] and res["same_opt"] and res["step"] == 1
        assert res["split"] > 0


def test_dryrun_multichip_on_four_cpu_ranks():
    """``dryrun_multichip(4, device='cpu')``: the tiny pretrain step over a
    (2, 2) mesh and over (4, 1), gloo; a finite loss."""
    from mvlt_tpu_torch.flagship import dryrun_multichip
    loss = dryrun_multichip(4, device="cpu")
    assert np.isfinite(loss)


def test_in_kernel_dropout_under_tp2_matches_one_process(tp2):
    """``MVLT_KERNEL_DROPOUT`` at TP 2 (bf16 compute, attention dropout
    0.1): through ``EncoderLayer`` and the TP rows, each rank's K2 / K4
    draws are bitwise its heads' slice of one process's draws (first head
    at the rank's global index, in every layer, forward and backward), and
    the step's losses equal one process's within the bf16 bar of the card
    (``LOSS_BAR`` 1e-2 relative)."""
    want = tp2["adrop_one"]
    assert want["masks"] and all(h0 == 0 for h0, _ in want["masks"])
    for rank, r in enumerate(tp2["got"]):
        got = r[1]
        for k, w in want["metrics"].items():
            assert abs(got["metrics"][k] - w) <= 1e-2 * abs(w), (k, got, w)
        assert len(got["masks"]) == len(want["masks"])
        for (h0, m), (_, full) in zip(got["masks"], want["masks"]):
            nh = m.shape[1]
            assert nh * 2 == full.shape[1] and h0 == rank * nh
            assert torch.equal(m, full[:, h0:h0 + nh])


def test_run_vqa_under_torchrun_on_two_cpu_ranks(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m mvlt_tpu_torch.run_vqa
    --device cpu``: the driver reads torchrun's environment, trains on a
    (2, 1) gloo mesh and world rank 0 alone writes ``results.json``."""
    import subprocess
    import sys
    from pathlib import Path
    out = tmp_path / "vqa"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "mvlt_tpu_torch.run_vqa",
         "--synthetic", "--tiny", "--device", "cpu", "--epochs", "1",
         "--batch_size", "8", "--num_workers", "0",
         "--model_name", str(out)],
        cwd=Path(__file__).resolve().parents[1], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads((out / "results.json").read_text())
    assert len(results) == 1 and results[0]["epoch"] == 0
    assert "round 0: " in (out / "round0" / "log.txt").read_text()


def test_generation_under_tp2_matches_one_process(tp2):
    """Greedy and beam-2 decoding at TP 2 (the prefill and the cached decode
    on the rank's heads, a cache of those heads, the row-parallel out and
    fc2 with *g*): the same ids and scores within 1e-5 as one process, with
    the MLM decoder's vocabulary split (512) and with the word embedding's
    rows split instead (511: 512 rows)."""
    for i, want in enumerate(tp2["gen_one"]):
        for r in tp2["got"]:
            got = r[4 + i]
            for beams in (1, 2):
                ids_g, ids_w = got[beams][0], want[beams][0]
                assert torch.equal(ids_g, ids_w), (i, beams)
                for g, w in zip(got[beams][1:], want[beams][1:]):
                    if g.is_floating_point():
                        torch.testing.assert_close(g, w, atol=1e-5,
                                                   rtol=1e-5)
                    else:
                        assert torch.equal(g, w)


def test_dp2_decode_reports_and_score_grid_gather_in_order(dp2):
    """``decode_reports`` (16 reports in batches of 6: blocks of 3 and a
    tail of 4 cut 2 + 2) and ``score_grid`` (8 x 8 in chunks of 3) at DP
    2: every rank returns one process's reports, ids and grid."""
    want = dp2["one_eval"]
    for r in dp2["got"]:
        got = r[4]
        assert got["reports"] == want["reports"]
        np.testing.assert_allclose(got["grid"]["similarities"],
                                   want["grid"]["similarities"],
                                   atol=1e-6, rtol=0)
        assert np.array_equal(got["grid"]["labels"], want["grid"]["labels"])


@pytest.mark.parametrize("dp", [2, 4])
def test_eval_with_a_tail_shorter_than_dp_gathers_in_order(dp, request):
    """``decode_reports`` and ``eval_vqa`` whose last batch is shorter than
    dp (1 row at dp 2, 3 rows at dp 4), so that a rank's block of it is
    empty, and ``score_grid`` on fewer images than dp (1, 3): that rank
    joins the gather with no rows, and every rank returns one process's
    reports, accuracy and grid."""
    if dp == 2:
        res = request.getfixturevalue("dp2")
        want, ranks = res["one_tail"], [r[5] for r in res["got"]]
    else:
        _, got, want = request.getfixturevalue("dp2tp2")
        ranks = [r[1] for r in got]
    assert len(ranks) == dp
    for got in ranks:
        assert got["reports"] == want["reports"]
        assert got["vqa"] == want["vqa"]
        assert got["grid"]["similarities"].shape == (dp - 1, dp - 1)
        np.testing.assert_allclose(got["grid"]["similarities"],
                                   want["grid"]["similarities"],
                                   atol=1e-6, rtol=0)
