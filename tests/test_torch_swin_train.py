"""The port's pretrain train step on the Swin backbone against the JAX
package, on the same weights (through ``pretrain_params_from_flax``), the
same inputs from a numpy seed and the same DropPath and dropout masks: a
tiny Swin (``swin_tiny_test`` with ``depths=(2, 2)`` and DropPath 0.3, so
stage 1 has a shifted block with 4 window patterns and stage 2 is a single
window, as Swin-S stage 4 is) + a 2-layer fusion encoder of the Swin's
width (no ``resnet_fc``, as at Swin-S), fusion dropouts 0.1, both mask
modes.

JAX runs three routes of the same math: its XLA route (flax ``DropPath``
drawing (B, 1, 1) masks), its kernel route (``SwinTransformer`` patched to
``attn_impl='interpret_full'``: the dp / save Pallas kernels in interpret
mode and their stored backward, drawing (B,) masks) and its wide-stage
route (``'interpret_half'``, against the port with stage 2 on its half
route). ``jax.random.bernoulli`` is replaced by a draw from a numpy
generator that keeps each mask in call order (the backbone's DropPath
draws first, then the fusion's); the port replays that list, each DropPath
mask as the (B,) draw it takes. float32 throughout: the loss, every
gradient (relative-position tables included; 1e-4 x max|grad| per tensor)
and three AdamW steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.backbones import swin as jswin
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_pretrain_step
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax

torch.set_num_threads(2)

B, L, IMG = 2, 7, 32
KEYS = ("image", "caption_masked", "caption_label", "itm_label")


def _jax_config():
    cfg = jcfg.MVLTConfig.for_pretrain(itm_task=True, mlm_gather_k=4)
    return dataclasses.replace(
        cfg, conv="swin",
        swin=dataclasses.replace(jcfg.swin_tiny_test(), depths=(2, 2),
                                 drop_path_rate=0.3),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, vocab_size=300))


def _port_config(cfg):
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


def _batch():
    batch = flagship.example_pretrain_batch(B, L, seed=3, image_size=IMG,
                                            vocab=300)
    return {k: v.numpy() for k, v in batch.items()}


def _inject_masks(monkeypatch, seed):
    """Patch ``jax.random.bernoulli`` to draw from numpy; returns the list
    the masks are appended to, in call order."""
    rng, drawn = np.random.default_rng(seed), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = rng.random(tuple(shape)) < p
        drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def _replay(drawn):
    """The port's mask source for JAX's draws: a DropPath mask, (B, 1, 1)
    on JAX's XLA route, is the port's (B,) draw."""
    return DropoutMasks.replay(m.reshape(B) if m.shape in ((B, 1, 1), (B,))
                               else m for m in drawn)


def _jax_route(monkeypatch, route):
    """Route JAX's Swin blocks: 'xla' (its CPU default), or the kernel
    routes in interpret mode; the adapter reads the class at setup."""
    if route != "xla":
        impl = "interpret_half" if route == "half" else "interpret_full"
        monkeypatch.setattr(jswin, "SwinTransformer", functools.partial(
            jswin.SwinTransformer, attn_impl=impl))
    if route == "half":
        # the port: stage 2 (C = 16) on the half route, stage 1 whole
        monkeypatch.setattr(pswin, "uses_half_blocks", lambda dim: dim >= 16)


def _jax_args(batch):
    return [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in KEYS[1:]]


@pytest.fixture(scope="module")
def tiny():
    cfg = _jax_config()
    batch = _batch()
    variables = jax.jit(JaxPretrain(cfg).init)(jax.random.PRNGKey(0),
                                               *_jax_args(batch))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return cfg, {"params": params}, batch


def _port_model(cfg, variables):
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))  # strict
    return model


@pytest.mark.parametrize("route,seq2seq", [
    ("xla", False), ("xla", True), ("interpret_full", False),
    ("interpret_full", True), ("half", False)])
def test_loss_and_grads_match_jax(tiny, route, seq2seq, monkeypatch):
    cfg, variables, batch = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    _jax_route(monkeypatch, route)
    drawn = _inject_masks(monkeypatch, 7)
    jmodel = JaxPretrain(cfg)

    def loss_fn(params):
        return jmodel.apply({"params": params}, *_jax_args(batch),
                            seq2seq=seq2seq, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (want_loss, want_m), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    # DropPath: blocks 1-3 (rates 0.1, 0.2, 0.3) two draws each, block 0
    # none; then per fusion layer amask, attention hmask, MLP hmask
    S = 1 + 16 + 1 + L
    dp_shape = (B,) if route != "xla" else (B, 1, 1)
    assert [m.shape for m in drawn] == [dp_shape] * 6 + [
        (B, 2, S, S), (B, S, 16), (B, S, 16)] * 2
    model = _port_model(cfg, variables)
    counts = [getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    loss, metrics = model.loss(
        *(torch.from_numpy(batch[k]) for k in KEYS), seq2seq=seq2seq,
        masks=_replay(drawn))
    loss.backward()
    assert counts == [getattr(f, c) for f in blocks.COUNTERPARTS
                      for c in blocks.COUNTS]           # CPU: nothing counted
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-5, name
    want = pretrain_params_from_flax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert any(".relative_position_bias_table" in n for n in got)
    unused = "mlm_head_bidir." if seq2seq else "mlm_head_seq2seq."
    for name, p in got.items():
        w = want[name].numpy()
        if name.startswith(unused):
            assert p.grad is None and not w.any(), name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_three_steps_match_jax_step(tiny, monkeypatch):
    """Three ``make_pretrain_step`` steps in the modes bidirectional,
    seq2seq, bidirectional against the JAX step (XLA route), each with the
    masks JAX took: the losses within 1e-4, then every parameter within
    3e-4 (about 2 lr a step, see test_torch_train.py)."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_pretrain_step as jax_pretrain_step

    cfg, variables, batch = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    drawn = _inject_masks(monkeypatch, 8)
    jmodel = JaxPretrain(cfg)
    state = create_train_state(jmodel, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    jbatch = dict(zip(KEYS, _jax_args(batch)))

    model = _port_model(cfg, variables)
    step = make_pretrain_step(model, make_optimizer(model, model.config))
    tbatch = {k: torch.from_numpy(batch[k]) for k in KEYS}
    for i, seq2seq in enumerate((False, True, False)):
        drawn.clear()
        state, jm = jax_pretrain_step(jmodel, seq2seq)(
            state, jbatch, jax.random.PRNGKey(i))
        step.masks = _replay(drawn)
        pm = step(tbatch, seq2seq)
        for name in ("loss", "mlm_loss", "itm_loss"):
            assert abs(float(pm[name]) - float(jm[name])) <= 1e-4, (i, name)

    want = pretrain_params_from_flax({"params": state.params})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        err = float(np.abs(value.numpy() - want[name].numpy()).max())
        assert err <= 3e-4, (name, err)


def test_flagship_swin_pretrain_config_is_the_bench_model():
    """``flagship_swin_pretrain_config`` is the model that
    ``bench.py:measure_pretrain_step`` trains: ``flagship_vqa_config()``
    with ITM on and text length 80 (Swin-S, DropPath 0.3, fusion dropouts
    0.1)."""
    from mvlt_tpu.flagship import flagship_vqa_config
    want = dataclasses.replace(flagship_vqa_config(), itm_task=True,
                               max_length=80)
    got = flagship.flagship_swin_pretrain_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.conv, got.swin.depths, got.swin.drop_path_rate,
            got.fusion.hidden_dropout_prob) == ("swin", (2, 2, 18, 2), 0.3,
                                                0.1)
    assert got.swin.num_features == got.fusion.hidden_size   # no resnet_fc


def test_build_swin_pretrain_train_step_on_cpu_counts_nothing(tiny):
    """``build_swin_pretrain_train_step`` at the tiny size on the CPU (plain
    versions) with DropPath and dropout: finite losses that fall at a
    learning rate of 1e-3, and no CUDA launch counted."""
    cfg = dataclasses.replace(_port_config(tiny[0]), lr=1e-3)
    before = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    step, batch = flagship.build_swin_pretrain_train_step(
        batch=B, text_len=L, device="cpu", compute_dtype=torch.float32,
        config=cfg, image_size=IMG)
    assert step.model.conv.resnet_fc is None
    losses = [float(step(batch, s)["loss"]) for s in (False, False, False)]
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    after = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    assert before == after


def test_build_swin_pretrain_train_step_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.build_swin_pretrain_train_step(batch=1, device="cuda")


def test_swin_training_without_a_mask_source_raises(tiny):
    model = _port_model(*tiny[:2])
    batch = tiny[2]
    with pytest.raises(ValueError, match="DropPath"):
        model.loss(*(torch.from_numpy(batch[k]) for k in KEYS))


class _KeepAll(DropoutMasks):
    """A mask source for the meta device: every unit kept."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def test_swin_pretrain_routing_counts_on_meta_device(monkeypatch):
    """The Swin-S pretrain step of record (b32, text 80) walked forward and
    backward on the meta device, which allocates and computes nothing: each
    counterpart is called as often as the JAX training path calls its TPU
    kernel. Forward: 11 whole blocks and 11 shifted ones (stages 1-3), 2
    half blocks with their attention cores (stage 4), 12 + 12 masked
    fusion halves; backward: 24 of each Swin backward piece, 12 + 12 of the
    fusion's. Every parameter but the other mode's MLM head gets a grad."""
    counts = {}
    suffix = {"launches": "", "shift_launches": "_shift",
              "train_launches": "_train",
              "train_shift_launches": "_train_shift"}

    def counted(name, fn):
        count = (blocks._full_block_count if name == "swin_full_block"
                 else blocks._shift_count)

        def call(x, *args, **kw):
            key = name + suffix[count(x, args, kw)]
            counts[key] = counts.get(key, 0) + 1
            return fn(x, *args, **kw)
        return call

    for fn in blocks.COUNTERPARTS:
        name = fn.__name__
        monkeypatch.setattr(blocks.PLAIN_OPS, name,
                            counted(name, getattr(blocks.PLAIN_OPS, name)))
    cfg = flagship.flagship_swin_pretrain_config()
    model = PretrainModel(cfg, dtype=torch.float32, device="meta",
                          compute_dtype=torch.bfloat16)
    n, text = 32, 80
    args = (torch.empty(n, 3, 224, 224, device="meta"),
            torch.ones(n, text, dtype=torch.long, device="meta"),
            torch.full((n, text), -100, dtype=torch.long, device="meta"),
            torch.zeros(n, dtype=torch.long, device="meta"))
    loss, _ = model.loss(*args, plain=True, masks=_KeepAll())
    assert counts == {"swin_full_block_train": 11,
                      "swin_full_block_train_shift": 11,
                      "swin_half_block": 2, "attention_core": 2,
                      "fused_attn_ln_masked": 12, "fused_mlp_ln_masked": 12}
    counts.clear()
    loss.backward()
    assert counts == {"swin_mlp_half_bwd": 24, "attention_core_bwd": 24,
                      "swin_qkv_tail_bwd": 24, "seq_attention_core_bwd": 12,
                      "mlp_ln_half_bwd": 12}
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith("mlm_head_seq2seq."), name
