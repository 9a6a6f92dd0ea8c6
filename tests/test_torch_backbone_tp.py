"""Tensor parallelism of the Swin and ViT backbones against the JAX
package's GSPMD step on the same mesh, on the CPU: gloo ranks spawned as in
``tests/test_torch_multidevice.py`` (whose rank helpers this module reuses),
one spawn a world shared by its cases; JAX on the virtual CPU devices of
``tests/conftest.py`` in the test process.

- The tiny Swin pretrain step (``tiny_pretrain_config``: heads 2 / 4) at TP
  4 against ``make_pretrain_step`` on a (1, 4) mesh: stage 1's attention
  half is held whole (2 heads), its MLP split; stage 2 splits on 1 head a
  rank. Three steps in both mask modes: metrics and updated parameters
  within 1e-4, the replicas bitwise equal.
- A tiny ViT pretrain step at TP 2 against JAX on a (1, 2) mesh, the same
  checks on one step.
- Port against port at TP 2: the Swin 'xla' route with attention dropout,
  hidden dropout and DropPath, each rank replaying the one-process step's
  masks (a rank keeps its heads of the attention draw and its columns of
  the GELU's); and each rank's TP forms of rows 1, 6 and 7 (forward and
  VJP) and of the serving routes (whole block, the wide halves, Swin-B's
  plain route) against the same rows on the whole weights in that rank.

The two spawns start first and run beside JAX's programs. Worker time:
about 55 s on one process (the JAX inits and steps ~45 s, the ranks beside
them).
"""

import dataclasses
import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_multidevice as md
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.parallel import build_mesh, initialize_distributed, shard
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_pretrain_step

torch.set_num_threads(2)

TOL = md.TOL


# ---------------------------------------------------------------------------
# the ranks (spawned; no JAX imports at the top)
# ---------------------------------------------------------------------------

def _swin_route(impl: str):
    """Every Swin block built on ``attn_impl=impl`` (the adapter passes no
    option, as in JAX)."""
    from mvlt_tpu_torch.models.backbones import adapter, swin
    return mock.patch.object(adapter, "SwinTransformer", functools.partial(
        swin.SwinTransformer, attn_impl=impl))


def _route_case(a, rank):
    """The pretrain step on ``a['impl']`` (md._pretrain_case's contract)."""
    with _swin_route(a["impl"]):
        return md._pretrain_case(a, rank)


def _gates(halves: bool, fit: bool, admit: bool):
    """The serving gates of the wide routes, forced at the tiny widths:
    stage 2 (C = 32) wide, its halves fitting or not, row 7 admitted or
    not."""
    from mvlt_tpu_torch.models.backbones import swin
    return [mock.patch.object(swin, "uses_half_blocks",
                              lambda d: halves and d >= 32),
            mock.patch.object(swin, "half_weights_fit", lambda d: fit),
            mock.patch.object(swin, "attn_half_admits",
                              lambda *a, **k: admit)]


def _rows_case(a, rank):
    """In each rank: rows 1, 6 and 7 with ``tp=`` on the rank's shards of
    random weights (forward, and the VJP wrt x and every weight, gathered)
    against the same rows on the whole weights; and the tiny Swin
    backbone's serving features on each wide route under TP against one
    device's. Returns the worst error over max|reference| of each."""
    from mvlt_tpu_torch import flagship
    from mvlt_tpu_torch.ops import blocks
    from mvlt_tpu_torch.parallel import partition
    from mvlt_tpu_torch.parallel.shard import TP
    torch.manual_seed(0)
    mesh = build_mesh(pcfg.MeshConfig(model_parallel=a["mp"]), device="cpu")
    tp = TP(mesh.model_group, mesh.model_rank, mesh.mp)
    r, n = mesh.model_rank, mesh.mp
    BW, N, C, nH = 4, 16, 32, 4
    x = torch.randn(BW, N, C)
    w = {"wqkv": torch.randn(3 * C, C) * 0.2, "bqkv": torch.randn(3 * C),
         "wproj": torch.randn(C, C) * 0.2, "bproj": torch.randn(C),
         "ln_s": torch.rand(C) + 0.5, "ln_b": torch.randn(C),
         "w1": torch.randn(4 * C, C) * 0.2, "b1": torch.randn(4 * C),
         "w2": torch.randn(C, 4 * C) * 0.2, "b2": torch.randn(C)}
    bias = torch.randn(2, nH, N, N)
    qkv_s = partition.Shard((None, "model"), 0, 3)
    col, row = partition.Shard((None, "model"), 0), \
        partition.Shard(("model", None), 1)
    cut = {"wqkv": qkv_s, "bqkv": qkv_s, "wproj": row, "w1": col, "b1": col,
           "w2": row}
    local = {k: partition.local_shard(v, cut[k], r, n) if k in cut else v
             for k, v in w.items()}
    hb = bias[:, r * nH // n:(r + 1) * nH // n].contiguous()
    P = blocks.PLAIN_OPS
    sc = (C // nH) ** -0.5

    def rows(ws, b, kw, h):
        return {
            "row 1": lambda x: P.window_block_attention(
                x, ws["wqkv"], ws["bqkv"], ws["wproj"], ws["bproj"], b, sc,
                h, residual=x, **kw),
            "row 6": lambda x: P.fused_mlp_preln(
                x, ws["ln_s"], ws["ln_b"], ws["w1"], ws["b1"], ws["w2"],
                ws["b2"], **kw),
            "row 7": lambda x: P.swin_attn_half(
                x, ws["ln_s"], ws["ln_b"], ws["wqkv"], ws["bqkv"],
                ws["wproj"], ws["bproj"], b, sc, h, **kw)}

    def run(fn, ws, b):
        xs = x.clone().requires_grad_(True)
        ws = {k: v.clone().requires_grad_(True) for k, v in ws.items()}
        b = b.clone().requires_grad_(True)
        y = fn(ws, b)(xs)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        return y.detach(), xs.grad, {k: v.grad for k, v in ws.items()
                                     if v.grad is not None}, b.grad

    out = {}
    for name in ("row 1", "row 6", "row 7"):
        want = run(lambda ws, b: rows(ws, b, {}, nH)[name], w, bias)
        got = run(lambda ws, b: rows(ws, b, {"tp": tp}, nH // n)[name],
                  local, hb)
        errs = [float((got[0] - want[0]).abs().max() / want[0].abs().max()),
                float((got[1] - want[1]).abs().max() / want[1].abs().max())]
        for k, g in got[2].items():
            g = partition.full_tensor(g, cut[k], mesh.model_group) \
                if k in cut else g
            errs.append(float((g - want[2][k]).abs().max()
                              / want[2][k].abs().max()))
        if want[3] is not None:
            wb = want[3][:, r * nH // n:(r + 1) * nH // n]
            errs.append(float((got[3] - wb).abs().max() / wb.abs().max()))
        out[name] = max(errs)
    # the serving routes of the tiny Swin backbone
    cfg = flagship.tiny_pretrain_config()
    img = torch.randn(2, 3, 32, 32)
    one = PretrainModel(cfg, dtype=torch.float32, device="cpu")
    flagship.init_seeded_(one, 1)
    split = PretrainModel(cfg, dtype=torch.float32, device="cpu")
    split.load_state_dict(one.state_dict())
    shard.apply_mesh_(split, mesh)
    for halves, fit, admit in ((False, True, False), (True, True, True),
                               (True, True, False), (True, False, False)):
        gates = _gates(halves, fit, admit)
        for g in gates:
            g.start()
        try:
            with torch.no_grad():
                want = one.conv(img, blocks.KERNEL_OPS)
                got = split.conv(img, blocks.KERNEL_OPS)
        finally:
            for g in gates:
                g.stop()
        out[f"serving {halves, fit, admit}"] = float(
            (got - want).abs().max() / want.abs().max())
    return out


CASES = dict(md.CASES, route=_route_case, rows=_rows_case)


def _rank_main(rank, world, tmp):
    torch.set_num_threads(2)
    initialize_distributed(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        jobs = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = [CASES[kind](a, rank) for kind, a in jobs]
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start(tmp, world, jobs):
    """Start ``jobs`` [(case, args)] on ``world`` gloo ranks; returns a
    function that waits for them and gives each rank's list of results."""
    os.makedirs(tmp, exist_ok=True)
    torch.save(jobs, os.path.join(tmp, "in.pt"))
    ctx = mp.spawn(_rank_main, args=(world, str(tmp)), nprocs=world,
                   join=False)

    def results():
        while not ctx.join():
            pass
        return [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(world)]
    return results


# ---------------------------------------------------------------------------
# the JAX side and the fixtures
# ---------------------------------------------------------------------------

def _jax_vit_config():
    """The tiny pretrain config on a tiny ViT (4 heads, dropouts 0)."""
    from mvlt_tpu import config as jcfg
    from mvlt_tpu.flagship import tiny_pretrain_config
    return dataclasses.replace(
        tiny_pretrain_config(), conv="vit",
        vit=jcfg.ViTConfig(image_size=md.IMG, patch_size=8, num_layers=2,
                           num_heads=4, hidden_dim=32, mlp_dim=64))


def _inputs(cfg):
    import jax.numpy as jnp
    from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
    batch = md._pretrain_batch()
    args = [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32)
        for k in ("caption_masked", "caption_label", "itm_label")]
    return md._jax_init(JaxPretrain(cfg), args), batch


def _dropout_config(cfg_json):
    """The tiny Swin with hidden and attention dropout 0.1 and DropPath
    0.3: every block on JAX's plain route."""
    cfg = pcfg.MVLTConfig.from_json(cfg_json)
    return dataclasses.replace(cfg, swin=dataclasses.replace(
        cfg.swin, drop_rate=0.1, attn_drop_rate=0.1,
        drop_path_rate=0.3)).to_json()


def _one_process(cfg_json, sd, batch, impl):
    """The port's one-process steps on ``impl``, masks recorded."""
    with _swin_route(impl):
        cfg = pcfg.MVLTConfig.from_json(cfg_json)
        model = PretrainModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    step = make_pretrain_step(model, make_optimizer(model, cfg))
    metrics, recorded = [], []
    for i, seq2seq in enumerate(md.MODES):
        step.masks = DropoutMasks(torch.Generator().manual_seed(10 + i),
                                  record=True)
        m = step({k: torch.as_tensor(v) for k, v in batch.items()}, seq2seq)
        metrics.append({k: float(v) for k, v in m.items()})
        recorded.append(step.masks.recorded)
    return metrics, model.state_dict(), recorded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started before JAX's steps run beside them: world 4,
    mesh (1, 4), the tiny Swin step; world 2, mesh (1, 2), the tiny ViT
    step, the Swin 'xla' route with dropout and the rows."""
    from mvlt_tpu.flagship import tiny_pretrain_config
    cfg = tiny_pretrain_config()
    svars, batch = _inputs(cfg)
    vcfg = _jax_vit_config()
    vvars, _ = _inputs(vcfg)
    sd = md._port_sd(svars)
    drop = _dropout_config(cfg.to_json())
    one = _one_process(drop, sd, batch, "xla")
    tmp = tmp_path_factory.mktemp("backbone_tp")
    tp4 = _start(tmp / "tp4", 4, [
        ("pretrain", {"cfg": cfg.to_json(), "sd": sd, "batch": batch,
                      "modes": md.MODES, "mp": 4})])
    tp2 = _start(tmp / "tp2", 2, [
        ("pretrain", {"cfg": pcfg.MVLTConfig.from_json(
            vcfg.to_json()).to_json(), "sd": md._port_sd(vvars),
            "batch": batch, "modes": md.MODES[:1], "mp": 2}),
        ("route", {"cfg": drop, "sd": sd, "batch": batch, "modes": md.MODES,
                   "mp": 2, "masks": one[2], "impl": "xla"}),
        ("rows", {"mp": 2})])
    want4 = md._jax_pretrain(cfg, svars, batch, 4, 4)
    want2 = _jax_pretrain_once(vcfg, vvars, batch)
    return {"tp4": (want4, tp4()), "tp2": {"want": want2, "one": one,
                                           "got": tp2()}}


def _jax_pretrain_once(cfg, variables, batch):
    """JAX's step on a (1, 2) mesh, one bidirectional step."""
    from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
    from mvlt_tpu.train import make_pretrain_step as jstep
    model = JaxPretrain(cfg)
    return md._jax_steps(
        model, variables,
        lambda mesh, sh, i: jstep(model, md.MODES[0], mesh=mesh,
                                  state_shardings=sh),
        {k: np.asarray(v, np.float32 if k == "image" else np.int32)
         for k, v in batch.items()}, 2, 2, 1)


@pytest.fixture(scope="module")
def tp4(runs):
    return runs["tp4"]


@pytest.fixture(scope="module")
def tp2(runs):
    return runs["tp2"]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _same_on_every_rank(got, index):
    first = got[0][index]
    for r in got[1:]:
        for k, v in r[index]["params"].items():
            assert torch.equal(v, first["params"][k]), k
        assert r[index]["metrics"] == first["metrics"]


def test_swin_tp4_matches_jax_with_stage_one_held(tp4):
    """The tiny Swin step at TP 4 (stage 1's 2 heads held whole, its MLP
    split; stage 2 on one head a rank): three steps in both mask modes,
    metrics and updated parameters within 1e-4 of JAX's GSPMD step on a (1,
    4) mesh; every rank's gathered parameters bitwise equal."""
    (want_m, want_v), got = tp4
    md._close_metrics(got[0][0]["metrics"], want_m)
    md._close_sd(got[0][0]["params"], md._port_sd(want_v))
    _same_on_every_rank(got, 0)


def test_vit_tp2_matches_jax(tp2):
    """A tiny ViT pretrain step (4 heads, 2 blocks) at TP 2: qkv and
    ``mlp_fc1`` column-parallel, ``out`` and ``mlp_fc2`` row-parallel;
    metrics and updated parameters after one step within 1e-4 of JAX's
    step on a (1, 2) mesh, the replicas bitwise equal."""
    want_m, want_v = tp2["want"]
    got = tp2["got"]
    md._close_metrics(got[0][0]["metrics"], want_m)
    md._close_sd(got[0][0]["params"], md._port_sd(want_v))
    _same_on_every_rank(got, 0)


def test_swin_xla_route_with_attention_dropout_tp2_matches_one_process(tp2):
    """The Swin 'xla' route with attention dropout 0.1, hidden dropout 0.1
    and DropPath 0.3 at TP 2, each rank replaying the one-process step's
    masks (its heads of each attention draw, its columns of each GELU
    draw): losses and parameters within 1e-4 of one process's."""
    one_metrics, one_sd, _ = tp2["one"]
    got = tp2["got"]
    md._close_metrics(got[0][1]["metrics"], one_metrics)
    md._close_sd(got[0][1]["params"], one_sd)
    _same_on_every_rank(got, 1)


@pytest.mark.parametrize("row", ["row 1", "row 6", "row 7", "serving"])
def test_swin_rows_tp_forms_match_the_whole_weights(tp2, row):
    """Rows 1, 6 and 7 with ``tp=`` on a rank's shards (K2 on its heads,
    the f32 partials summed, the bias once): the output, the input
    gradient, every weight's gradient (gathered) and the bias patterns'
    gradient of the rank's heads within 1e-5 x max|reference| of the rows
    on the whole weights; and the tiny Swin backbone served under TP on
    each route (whole block; the wide halves with and without row 7; the
    plain route Swin-B's stage 4 takes) within 1e-5 of one device."""
    for r in tp2["got"]:
        errs = {k: v for k, v in r[2].items() if k.startswith(row)}
        assert errs and all(v <= 1e-5 for v in errs.values()), errs
