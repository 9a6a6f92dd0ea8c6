"""The port's MLM+ITM pretrain train step against the JAX package, on the
same weights (through ``pretrain_params_from_flax``), the same inputs from a
numpy seed and the same dropout masks: a tiny ResNet (``layers=(1, 1),
width=8``) + ``resnet_fc`` + a 2-layer fusion encoder, fusion dropouts 0.1,
both mask modes, the JAX side on its fused encoder
(``MVLT_FORCE_FUSED_ENCODER=1``: the masked Pallas kernels in interpret
mode and their store-residual VJPs).

Masks. ``jax.random.bernoulli`` (which ``fusion.py:153,158,256`` and flax's
``Dropout`` call) is replaced by a draw from a numpy generator that keeps
each mask, in call order; the port replays that list through
``DropoutMasks.replay``. JAX then runs under ``jit``: the patched function
runs while the step is traced, so each step is built anew to take its own
masks. float32 throughout: the loss, every gradient (1e-4 x max|grad| per
tensor) and three AdamW steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu.ops import layers as jlayers
from mvlt_tpu.ops import masks as jmasks
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.ops import blocks, kernels, masks
from mvlt_tpu_torch.ops.layers import DropoutMasks, gather_label_positions
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_pretrain_step, seq2seq_coin_flip
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax

torch.set_num_threads(2)

B, L, IMG = 3, 9, 32
KEYS = ("image", "caption_masked", "caption_label", "itm_label")


def _jax_config():
    cfg = jcfg.MVLTConfig.for_pretrain(itm_task=True, mlm_gather_k=4)
    return dataclasses.replace(
        cfg, conv="resnet50", resnet=jcfg.ResNetConfig(layers=(1, 1), width=8),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, vocab_size=300))


def _port_config(cfg):
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


def _batch():
    """A seeded batch; sample 0 carries 5 labels, one more than
    ``mlm_gather_k``, so the gather drops one."""
    batch = flagship.example_pretrain_batch(B, L, seed=1, image_size=IMG,
                                            vocab=300)
    batch["caption_label"][0, :5] = torch.tensor([11, 12, 13, 14, 15])
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


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


def _jax_args(batch):
    return [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in KEYS[1:]]


@pytest.fixture(scope="module")
def tiny():
    cfg = _jax_config()
    batch = _batch()
    variables = JaxPretrain(cfg).init(jax.random.PRNGKey(0),
                                      *_jax_args(batch))
    variables = {"params": _perturb(variables["params"], 1),
                 "batch_stats": jax.tree.map(np.asarray,
                                             variables["batch_stats"])}
    return cfg, variables, batch


def _port_model(cfg, variables):
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))
    return model


@pytest.mark.parametrize("seq2seq", [False, True])
def test_loss_and_grads_match_jax_with_dropout(tiny, seq2seq, monkeypatch):
    cfg, variables, batch = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    drawn = _inject_masks(monkeypatch, 7)
    jmodel = JaxPretrain(cfg)

    def loss_fn(params):
        (loss, metrics), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *_jax_args(batch), seq2seq=seq2seq, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(3)}, mutable=["batch_stats"])
        return loss, metrics

    (want_loss, want_m), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    # per layer: amask (B, nH, S, S), the attention and the MLP hmask
    S = 1 + 16 + 1 + L
    assert [m.shape for m in drawn] == [(B, 4, S, S), (B, S, 32),
                                        (B, S, 32)] * 2
    model = _port_model(cfg, variables)
    loss, metrics = model.loss(
        *(torch.from_numpy(batch[k]) for k in KEYS), seq2seq=seq2seq,
        masks=DropoutMasks.replay(drawn))
    loss.backward()
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-5, name
    want = pretrain_params_from_flax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
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
    seq2seq, bidirectional against the JAX step (mesh None), each with the
    masks JAX took: the losses within 1e-4, then every parameter within
    3e-4 (about 2 lr a step, see test_torch_train.py) and the BatchNorm
    running statistics within 1e-4 x max|value|."""
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
        # a new jitted step per call: tracing it draws this step's masks
        state, jm = jax_pretrain_step(jmodel, seq2seq)(
            state, jbatch, jax.random.PRNGKey(i))
        step.masks = DropoutMasks.replay(drawn)
        pm = step(tbatch, seq2seq)
        for name in ("loss", "mlm_loss", "itm_loss"):
            assert abs(float(pm[name]) - float(jm[name])) <= 1e-4, (i, name)

    want = pretrain_params_from_flax({
        "params": state.params,
        "batch_stats": state.extra_variables["batch_stats"]})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        w = want[name].numpy()
        err = float(np.abs(value.numpy() - w).max())
        if name.endswith(("running_mean", "running_var")):
            assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), name
        else:
            assert err <= 3e-4, (name, err)


def test_pretrain_tree_maps_every_leaf_once(tiny):
    cfg, variables, _ = tiny
    sd = pretrain_params_from_flax(variables)
    model = PretrainModel(_port_config(cfg), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)                                  # strict
    assert tuple(sd["mlm_head_bidir.decoder.weight"].shape) == (300, 32)
    assert "mlm_head_seq2seq.transform.transform_layernorm.weight" in sd
    assert tuple(sd["itm_mlp.weight"].shape) == (2, 32)
    bad = {"params": dict(variables["params"], extra={"kernel": np.ones(2)}),
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        pretrain_params_from_flax(bad)


@pytest.mark.parametrize("batch,obj_end,total", [(2, 5, 9), (3, 17, 27),
                                                 (1, 0, 4)])
def test_seq2seq_mask_and_bias_match_jax(batch, obj_end, total):
    want = np.asarray(jmasks.seq2seq_fusion_mask(batch, obj_end, total))
    got = masks.seq2seq_fusion_mask(batch, obj_end, total)
    np.testing.assert_array_equal(got.numpy(), want)
    # padded text keys stay visible: the mask has no text-padding input
    assert got[:, -1].all()
    bias = masks.mask_to_bias(got)
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(jmasks.mask_to_bias(jnp.asarray(want)))[:, 0])
    with pytest.raises(ValueError):
        masks.mask_to_bias(got[None])


@pytest.mark.parametrize("k", [2, 4, 16])
def test_gather_label_positions_matches_jax(k):
    """Ties (every valid label sorts equal) keep their original order; a
    sample with more valid labels than k drops the last ones, one with none
    gathers ignored positions only; k above L takes L."""
    rng = np.random.default_rng(4)
    labels = np.full((4, 7), -100)
    labels[0, [1, 3, 4, 6]] = [5, 6, 7, 8]
    labels[1, [0, 2]] = [9, 9]
    labels[3, :] = np.arange(7)
    hidden = rng.normal(size=(4, 7, 5)).astype(np.float32)
    want_h, want_l = jlayers.gather_label_positions(
        jnp.asarray(hidden), jnp.asarray(labels), k)
    got_h, got_l = gather_label_positions(torch.from_numpy(hidden),
                                          torch.from_numpy(labels), k)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert got_l.shape == (4, min(k, 7))


def test_dropout_masks_draw_scale_and_replay():
    gen = torch.Generator().manual_seed(0)
    src = DropoutMasks(gen, record=True)
    m = src.scaled(0.9, (64, 64), torch.bfloat16, "cpu")
    assert set(m.unique().tolist()) == {0.0, 1.109375}     # 1/0.9 in bf16
    keep = (m > 0).float().mean().item()
    assert 0.85 < keep < 0.95
    b = src.draw(0.5, (3, 5), "cpu")
    assert b.dtype == torch.bool and len(src.recorded) == 2
    again = DropoutMasks(torch.Generator().manual_seed(0))
    assert torch.equal(again.scaled(0.9, (64, 64), torch.bfloat16, "cpu"), m)
    rep = DropoutMasks.replay(src.recorded)
    assert torch.equal(rep.draw(0.9, (64, 64), "cpu"), m > 0)
    with pytest.raises(ValueError, match="replayed mask"):
        rep.draw(0.5, (5, 3), "cpu")
    with pytest.raises(RuntimeError, match="no recorded"):
        rep.draw(0.5, (3, 5), "cpu")


def test_seq2seq_coin_flip_is_seeded():
    flips = [seq2seq_coin_flip(torch.Generator().manual_seed(5))
             for _ in range(3)]
    assert len(set(flips)) == 1
    gen = torch.Generator().manual_seed(1)
    seq = [seq2seq_coin_flip(gen) for _ in range(40)]
    assert all(isinstance(f, bool) for f in seq) and 5 < sum(seq) < 35


def test_example_pretrain_batch_masks_as_the_pipeline():
    batch = flagship.example_pretrain_batch(16, 80, seed=2)
    cap, lab = batch["caption_masked"], batch["caption_label"]
    assert batch["image"].shape == (16, 3, 224, 224)
    lengths = (cap > 0).sum(1)
    assert (lengths >= 5).all() and (lengths <= 80).all()
    for row, labels, n in zip(cap, lab, lengths):
        assert (row[:n] > 0).all() and (row[n:] == 0).all()
        valid = labels != -100
        assert valid.sum() == min(10, max(1, round(int(n) * 0.2)))
        assert not valid[n:].any()
    assert set(batch["itm_label"].tolist()) <= {0, 1}
    assert (cap == 103).any()                            # [MASK]


def test_flagship_pretrain_config_matches_for_pretrain():
    cfg = flagship.flagship_pretrain_config()
    assert (cfg.conv, cfg.resnet.layers, cfg.itm_task, cfg.mlm_task,
            cfg.max_length, cfg.mlm_gather_k) == (
        "resnet101", (3, 4, 23, 3), True, True, 80, 16)
    assert cfg.fusion.hidden_dropout_prob == 0.1
    assert cfg.fusion.attention_probs_dropout_prob == 0.1


def test_build_pretrain_train_step_on_cpu_counts_nothing():
    """``build_pretrain_train_step`` at a tiny size on the CPU (plain
    versions), alternating mask modes: finite losses that fall (at a
    learning rate of 1e-3, so that three steps outrun the dropout noise),
    and no CUDA launch counted."""
    cfg = dataclasses.replace(_port_config(_jax_config()), lr=1e-3)
    before = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    step, batch = flagship.build_pretrain_train_step(
        batch=B, text_len=L, device="cpu", compute_dtype=torch.float32,
        config=cfg, image_size=IMG)
    losses = [float(step(batch, s)["loss"])
              for s in (False, True, False, True)]
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    after = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    assert before == after


def test_build_pretrain_train_step_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.build_pretrain_train_step(batch=1, device="cuda")
