"""The port's ``CaptionModel`` and its train step against the JAX package,
on the same weights (through ``caption_params_from_flax``), the same inputs
from a numpy seed and the same DropPath and dropout masks, in float32.

The model is the tiny Swin of ``test_torch_swin_train.py`` (DropPath 0.3)
and a 2-layer fusion encoder of its width over a 300-word vocabulary,
``for_caption`` (fusion dropouts 0.1), ``mlm_gather_k`` 4. JAX runs its CPU
route (XLA); ``jax.random.bernoulli`` draws from numpy and keeps each mask
in call order (the backbone's DropPath first, then each fusion layer's),
and the port replays that list. Training logits in both learning
strategies, the loss and every gradient (1e-4 x max|grad| per tensor) in
'unilm' (gather-k) and 'normal' (full logits), and three
``make_caption_step`` steps (losses and parameters within 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.heads import CaptionModel as JaxCaption
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.heads import CaptionModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_caption_step
from mvlt_tpu_torch.utils.convert import caption_params_from_flax

torch.set_num_threads(2)

B, L, IMG = 2, 7, 32
S = 1 + 16 + 1 + L
KEYS = ("image", "caption", "mlm_labels")


def _jax_config():
    cfg = jcfg.MVLTConfig.for_caption(max_length=L, mlm_gather_k=4)
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


def _batch(strategy):
    batch = flagship.example_caption_batch(B, L, seed=3, image_size=IMG,
                                           vocab=300,
                                           learning_strategy=strategy)
    return {k: v.numpy() for k, v in batch.items()}


def _jax_args(batch):
    return [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in KEYS[1:]]


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
    """JAX's XLA route draws each DropPath mask as (B, 1, 1); the port takes
    it as its (B,) draw."""
    return DropoutMasks.replay(m.reshape(B) if m.shape == (B, 1, 1) else m
                               for m in drawn)


@pytest.fixture(scope="module")
def tiny():
    cfg = _jax_config()
    batch = _batch("unilm")
    variables = jax.jit(JaxCaption(cfg).init)(jax.random.PRNGKey(0),
                                              *_jax_args(batch)[:2])
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return cfg, {"params": params}


def _port_model(cfg, variables):
    model = CaptionModel(_port_config(cfg), device="cpu")
    model.load_state_dict(caption_params_from_flax(variables))    # strict
    return model


def test_params_from_flax_maps_the_caption_tree(tiny):
    """Every leaf of the flax tree (backbone, fusion with its pooler,
    ``mlm_head_seq2seq``) lands on one port parameter, and every port
    parameter gets one."""
    cfg, variables = tiny
    sd = caption_params_from_flax(variables)
    leaves = jax.tree_util.tree_leaves(variables["params"])
    fused = 3 * cfg.fusion.num_hidden_layers * 2     # q / k / v into qkv
    assert len(sd) == len(leaves) - fused + fused // 3
    assert set(sd) == set(_port_model(cfg, variables).state_dict())
    assert {"fusion.pooler.weight", "mlm_head_seq2seq.decoder.weight",
            "mlm_head_seq2seq.transform.transform_layernorm.weight"} <= set(sd)


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_training_logits_match_jax(tiny, strategy):
    """``CaptionModel.__call__`` (deterministic): the per-position logits
    of 'unilm' and the shifted ones of 'normal' ([SEP] predicts the first
    token), within 1e-4."""
    cfg, variables = tiny
    batch = _batch(strategy)
    want = jax.jit(lambda v, im, c: JaxCaption(cfg).apply(
        v, im, c, strategy))(variables, *_jax_args(batch)[:2])
    got = _port_model(cfg, variables)(
        torch.from_numpy(batch["image"]), torch.from_numpy(batch["caption"]),
        strategy)
    assert got.shape == (B, L, 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_loss_and_grads_match_jax_with_dropout(tiny, strategy, monkeypatch):
    cfg, variables = tiny
    batch = _batch(strategy)
    drawn = _inject_masks(monkeypatch, 7)
    jmodel = JaxCaption(cfg)

    def loss_fn(params):
        return jmodel.apply({"params": params}, *_jax_args(batch), strategy,
                            deterministic=False, method=jmodel.loss,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (want_loss, want_logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    # DropPath: blocks 1-3 two draws each (block 0's rate is 0); then per
    # fusion layer the attention mask, the attention and MLP hidden masks
    assert [m.shape for m in drawn] == [(B, 1, 1)] * 6 + [
        (B, 2, S, S), (B, S, 16), (B, S, 16)] * 2
    model = _port_model(cfg, variables)
    loss, logits = model.loss(*(torch.from_numpy(batch[k]) for k in KEYS),
                              strategy, masks=_replay(drawn))
    loss.backward()
    # 'unilm' projects the gathered label positions only
    assert logits.shape == ((B, 4, 300) if strategy == "unilm"
                            else (B, L, 300)) == want_logits.shape
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want = caption_params_from_flax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].numpy()
        if name.startswith("fusion.pooler."):
            assert p.grad is None and not w.any(), name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_three_caption_steps_match_jax_step(tiny, strategy, monkeypatch):
    """Three ``make_caption_step`` steps against JAX's, each with the masks
    JAX took (drawn once, when its step was traced): the losses within
    1e-4, then every parameter (the pooler's too, moved by weight decay
    alone) within 1e-4."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_caption_step as jax_caption_step

    cfg, variables = tiny
    batch = _batch(strategy)
    drawn = _inject_masks(monkeypatch, 8)
    jmodel = JaxCaption(cfg)
    state = create_train_state(jmodel, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    jbatch = dict(zip(KEYS, _jax_args(batch)))
    jstep = jax_caption_step(jmodel, strategy)
    model = _port_model(cfg, variables)
    step = make_caption_step(model, make_optimizer(model, model.config),
                             learning_strategy=strategy)
    tbatch = {k: torch.from_numpy(batch[k]) for k in KEYS}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        # the compiled step holds the masks drawn while it was traced
        assert len(drawn) == 6 + 3 * 2
        step.masks = _replay(drawn)
        pm = step(tbatch)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-4, i
    want = caption_params_from_flax({"params": state.params})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        err = float(np.abs(value.numpy() - want[name].numpy()).max())
        assert err <= 1e-4, (name, err)


def test_flagship_caption_config_is_for_caption_at_mimic_cxr():
    """``flagship_caption_config`` is JAX's ``for_caption(max_length=150)``
    with Swin-S: fusion dropouts 0.1, DropPath 0.3, lr 1e-5, is_decoder,
    S = 1 + 49 + 1 + 150 = 201."""
    want = jcfg.MVLTConfig.for_caption(max_length=150, conv="swin",
                                       swin=jcfg.swin_small())
    got = flagship.flagship_caption_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.swin.depths, got.swin.drop_path_rate, got.lr,
            got.fusion.hidden_dropout_prob, got.fusion.vocab_size,
            got.is_decoder) == ((2, 2, 18, 2), 0.3, 1e-5, 0.1, 30522, True)
    assert dataclasses.asdict(pcfg.MVLTConfig.for_caption()) == \
        dataclasses.asdict(jcfg.MVLTConfig.for_caption())


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_example_caption_batch(strategy):
    """Reports of 5..L tokens ending in eos with zero padding; 'unilm'
    labels 1..10 masked positions per report, 'normal' every real token."""
    b = flagship.example_caption_batch(6, 40, seed=2,
                                       image_size=IMG,
                                       learning_strategy=strategy)
    assert b["image"].shape == (6, 3, IMG, IMG)
    cap, lab = b["caption"], b["mlm_labels"]
    assert cap.shape == lab.shape == (6, 40) and cap.dtype == torch.int64
    for row, labels in zip(cap, lab):
        n = int((row > 0).sum())
        assert n >= 5 and (row[n:] == 0).all() and (row[:n] > 0).all()
        valid = labels != -100
        if strategy == "unilm":
            assert 1 <= int(valid.sum()) <= 10 and not valid[n:].any()
        else:
            assert row[n - 1] == 104 and torch.equal(labels[:n], row[:n])
            assert not valid[n:].any()


def test_build_caption_train_step_on_cpu_counts_nothing(tiny):
    """``build_caption_train_step`` at the tiny size on the CPU (plain
    versions): finite losses that fall at a learning rate of 1e-3, and no
    CUDA launch counted; without CUDA, ``device='cuda'`` raises."""
    cfg = dataclasses.replace(_port_config(tiny[0]), lr=1e-3)
    before = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    step, batch = flagship.build_caption_train_step(
        batch=B, text_len=L, device="cpu", compute_dtype=torch.float32,
        config=cfg, image_size=IMG)
    losses = [float(step(batch)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    after = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    assert before == after
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flagship.build_caption_train_step(batch=1, device="cuda")


class _KeepAll(DropoutMasks):
    """A mask source for the meta device: every unit kept."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def test_caption_step_routing_counts_on_meta_device(monkeypatch):
    """The caption step at the flagship config (Swin-S + BERT-base, b32,
    text 150: S = 201, 'unilm') walked forward and backward on the meta
    device: the counterparts run as in the Swin-S pretrain step in seq2seq
    mode (11 + 11 whole blocks and 2 half blocks forward, 24 of each Swin
    backward piece, 12 + 12 masked fusion halves and their backwards).
    Every parameter but the fusion pooler's gets a gradient."""
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
    cfg = flagship.flagship_caption_config()
    model = CaptionModel(cfg, dtype=torch.float32, device="meta",
                         compute_dtype=torch.bfloat16)
    n, text = 32, 150
    loss, logits = model.loss(
        torch.empty(n, 3, 224, 224, device="meta"),
        torch.ones(n, text, dtype=torch.long, device="meta"),
        torch.full((n, text), -100, dtype=torch.long, device="meta"),
        plain=True, masks=_KeepAll())
    assert logits.shape == (n, cfg.mlm_gather_k, 30522)
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
        assert (p.grad is None) == name.startswith("fusion.pooler."), name
