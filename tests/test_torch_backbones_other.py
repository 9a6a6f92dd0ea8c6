"""The port's task models on its other backbones against the JAX package:
``VQAModel``, ``PretrainModel`` (both mask modes) and ``RetrievalModel`` on
ViT-B/16 (``conv='vit'``, 32 wide under a 48-wide fusion encoder: through
``resnet_fc``) and on the linear patch (``conv='linear'``, as wide as the
fusion encoder: no ``resnet_fc``), loaded with a strict ``load_state_dict``
of JAX's tree; the converter's round trip, bitwise, for both trees; and the
merge log's leaf count. The backbones alone, Swin-B's route, the refusals
and a driver run are in ``test_torch_backbone_modules.py``.

Inputs are numpy arrays from a seed, at a tiny size (ViT: hidden 32, 2
layers, 4 heads, image 32, patch 8, MLP 64; the linear patch 16 px), every
parameter perturbed so that its mapping shows. float32 throughout: logits
and losses within 1e-4, gradients within 1e-4 x max|grad| per tensor, the
BatchNorm running buffers within 1e-6, the round trip bitwise. Dropout
masks are JAX's draws replayed to the port (``jax.random.bernoulli``
patched to draw from numpy, as ``test_torch_pretrain.py`` does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu.models.heads import RetrievalModel as JaxRetrieval
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.heads import (PretrainModel, RetrievalModel,
                                         VQAModel)
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils import convert

torch.set_num_threads(2)

VIT = jcfg.ViTConfig(image_size=32, patch_size=8, num_layers=2, num_heads=4,
                     hidden_dim=32, mlp_dim=64)
B, L, IMG = 3, 7, 32


def _port_config(cfg):
    return pcfg.MVLTConfig.from_json(cfg.to_json())


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


def _stats(tree, seed):
    """BatchNorm statistics moved off their init (mean 0, var 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + np.abs(
        rng.normal(0.0, 0.2, np.shape(a))).astype(np.float32), tree)


def _inject_masks(monkeypatch, seed):
    rng, drawn = np.random.default_rng(seed), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = rng.random(tuple(shape)) < p
        drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-4)


def _grads_close(model, want_sd, skip=()):
    """Every port gradient within 1e-4 x max|JAX grad| of its tensor. The
    linear patch's conv bias, which a BatchNorm on batch statistics follows,
    has a gradient of 0 in exact arithmetic: both sides must leave it below
    1e-6 x the largest gradient of the model."""
    got = dict(model.named_parameters())
    assert set(got) == set(want_sd)
    top = max(float(np.abs(w.numpy()).max()) for w in want_sd.values())
    for name, p in got.items():
        w = want_sd[name].numpy()
        if name.startswith(skip):
            assert p.grad is None and not w.any(), name
            continue
        if name == "conv.backbone.proj.bias" and "conv.backbone.bn.weight" \
                in got:
            assert max(float(np.abs(w).max()),
                       float(p.grad.abs().max())) <= 1e-6 * top, name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# the task models on the new backbones
# ---------------------------------------------------------------------------

def _fusion(cfg, hidden=48):
    return dataclasses.replace(
        cfg.fusion, hidden_size=hidden, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=2 * hidden, vocab_size=300)


def _jax_config(task, conv):
    """A tiny config of ``task`` on ``conv``: the ViT above (32 wide, so a
    48-wide fusion encoder takes it through ``resnet_fc``) or the linear
    patch (as wide as the fusion encoder: no ``resnet_fc``)."""
    cfg = {"vqa": jcfg.MVLTConfig.for_vqa(result_num=10),
           "pretrain": jcfg.MVLTConfig.for_pretrain(itm_task=True,
                                                    mlm_gather_k=4),
           "retrieval": jcfg.MVLTConfig.for_retrieval()}[task]
    return dataclasses.replace(cfg, conv=conv, vit=VIT, fusion=_fusion(cfg))


def _inputs(seed=0):
    batch = flagship.example_pretrain_batch(B, L, seed=seed, image_size=IMG,
                                            vocab=300)
    return {k: v.numpy() for k, v in batch.items()}


def _init(jmodel, *args):
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)
    out = {"params": _perturb(v["params"], 1)}
    if "batch_stats" in v:
        out["batch_stats"] = _stats(v["batch_stats"], 2)
    return out


def _load(model_cls, cfg, variables):
    model = model_cls(_port_config(cfg), dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.params_from_flax(variables))   # strict
    return model


@pytest.mark.parametrize("conv", ["vit", "linear"])
def test_vqa_logits_and_loss_match_jax(conv, monkeypatch):
    """``VQAModel`` on ``conv``: the serving logits, then the training loss
    (fusion dropouts 0.1 on JAX's masks; the linear patch's BN on batch
    statistics) with its gradients and the running buffers it moves."""
    cfg = _jax_config("vqa", conv)
    batch = _inputs()
    image = jnp.asarray(batch["image"])
    question = jnp.asarray(batch["caption_masked"], jnp.int32)
    label = batch["itm_label"] * 3
    jm = JaxVQA(cfg)
    variables = _init(jm, image, question)
    _, want = jm.apply(variables, image, question)
    model = _load(VQAModel, cfg, variables)
    assert (model.conv.resnet_fc is None) == (conv == "linear")
    _, got = model(torch.from_numpy(batch["image"]),
                   torch.from_numpy(batch["caption_masked"]))
    assert got.shape == (B, 10)
    _close(got, want)

    drawn = _inject_masks(monkeypatch, 5)

    def loss_fn(params):
        v = dict(variables, params=params)
        (loss, _), mut = jm.apply(
            v, image, question, jnp.asarray(label, jnp.int32),
            method=JaxVQA.loss, rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"]) if "batch_stats" in v else (
            jm.apply(v, image, question, jnp.asarray(label, jnp.int32),
                     method=JaxVQA.loss,
                     rngs={"dropout": jax.random.PRNGKey(1)}), {})
        return loss, mut

    (want_loss, mutated), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    loss, _ = model.loss(torch.from_numpy(batch["image"]),
                         torch.from_numpy(batch["caption_masked"]),
                         torch.from_numpy(label),
                         masks=DropoutMasks.replay(drawn))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-4
    _grads_close(model, convert.params_from_flax({"params": grads}))
    if conv == "linear":
        bn = model.conv.backbone.bn
        stats = mutated["batch_stats"]["conv"]["backbone"]["bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("conv", ["vit", "linear"])
@pytest.mark.parametrize("seq2seq", [False, True])
def test_pretrain_loss_and_grads_match_jax(conv, seq2seq, monkeypatch):
    """``PretrainModel`` (MLM + ITM, fusion dropouts 0.1) on ``conv`` in
    both mask modes, on JAX's masks replayed: the three losses within 1e-4
    and every gradient within 1e-4 x max|grad|."""
    cfg = _jax_config("pretrain", conv)
    batch = _inputs(1)
    keys = ("image", "caption_masked", "caption_label", "itm_label")
    args = [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in keys[1:]]
    jm = JaxPretrain(cfg)
    variables = _init(jm, *args)
    drawn = _inject_masks(monkeypatch, 7)

    def loss_fn(params):
        out = jm.apply(dict(variables, params=params), *args, seq2seq=seq2seq,
                       deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(3)},
                       mutable=["batch_stats"])
        (loss, metrics), _ = out
        return loss, metrics

    (_, want_m), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    S = 1 + (16 if conv == "vit" else 4) + 1 + L
    assert [m.shape for m in drawn] == [(B, 4, S, S), (B, S, 48),
                                        (B, S, 48)] * 2
    model = _load(PretrainModel, cfg, variables)
    loss, metrics = model.loss(*(torch.from_numpy(batch[k]) for k in keys),
                               seq2seq=seq2seq,
                               masks=DropoutMasks.replay(drawn))
    loss.backward()
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-4, name
    _grads_close(model, convert.params_from_flax({"params": grads}),
                 skip=("mlm_head_bidir." if seq2seq else "mlm_head_seq2seq."))


@pytest.mark.parametrize("conv", ["vit", "linear"])
def test_retrieval_logits_and_loss_match_jax(conv, monkeypatch):
    """``RetrievalModel`` on ``conv``: the 2-way match logits, and the loss
    on ``cat(pos, neg)``-shaped rows with attention dropout 0.1 on JAX's
    masks."""
    cfg = _jax_config("retrieval", conv)
    batch = _inputs(2)
    image = jnp.asarray(batch["image"])
    caption = jnp.asarray(batch["caption_masked"], jnp.int32)
    label = batch["itm_label"]
    jm = JaxRetrieval(cfg)
    variables = _init(jm, image, caption)
    want = jm.apply(variables, image, caption)
    model = _load(RetrievalModel, cfg, variables)
    got = model(torch.from_numpy(batch["image"]),
                torch.from_numpy(batch["caption_masked"]))
    _close(got, want[0] if isinstance(want, tuple) else want)

    drawn = _inject_masks(monkeypatch, 11)
    mutable = ["batch_stats"] if "batch_stats" in variables else False
    out = jm.apply(variables, image, caption, jnp.asarray(label, jnp.int32),
                   method=JaxRetrieval.loss,
                   rngs={"dropout": jax.random.PRNGKey(2)}, mutable=mutable)
    want_loss = (out[0] if mutable else out)[0]
    loss, _ = model.loss(torch.from_numpy(batch["image"]),
                         torch.from_numpy(batch["caption_masked"]),
                         torch.from_numpy(label),
                         masks=DropoutMasks.replay(drawn))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-4


@pytest.mark.parametrize("conv", ["vit", "linear"])
def test_round_trip_is_bitwise(conv):
    """flax -> port -> flax gives every leaf back bitwise: the ViT's
    ``DenseGeneral`` q / k / v / out through the fused ``qkv`` and ``out``,
    the linear patch's conv and its ``batch_stats``."""
    cfg = _jax_config("vqa", conv)
    batch = _inputs()
    variables = _init(JaxVQA(cfg), jnp.asarray(batch["image"]),
                      jnp.asarray(batch["caption_masked"], jnp.int32))
    sd = _load(VQAModel, cfg, variables).state_dict()
    back = convert.params_to_flax(sd, variables)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_merge_counts_the_vit_qkv_as_three_leaves():
    """``TaskRunner``'s merge log counts JAX's leaves: a ViT block's fused
    ``qkv`` weight and bias stand for three each, as the fusion's do."""
    from mvlt_tpu_torch.tasks.common import flax_leaves
    cfg = _jax_config("vqa", "vit")
    batch = _inputs()
    variables = _init(JaxVQA(cfg), jnp.asarray(batch["image"]),
                      jnp.asarray(batch["caption_masked"], jnp.int32))
    model = VQAModel(_port_config(cfg))
    assert sum(flax_leaves(n) for n in model.state_dict()) == \
        len(jax.tree.leaves(variables))


@pytest.mark.parametrize("conv", ["vit", "linear"])
def test_retrieval_grid_matches_the_model_per_pair(conv):
    """The N x N grid on ``conv`` (the backbone once per image, the fusion
    over each caption chunk on ``expand``-ed features) against the full
    model's P(match) per pair."""
    cfg = _port_config(_jax_config("retrieval", conv))
    grid, (images, captions, cap_ids) = flagship.build_retrieval_grid(
        n=4, text_len=L, batch_size=3, dtype=torch.float32, device="cpu",
        config=cfg, image_size=IMG)
    out = grid(images, captions, cap_ids)
    sims = out["similarities"]
    assert sims.shape == (4, 4)
    for i in range(4):
        want = grid.model.score(images[i:i + 1].expand(4, -1, -1, -1),
                                captions).numpy()
        np.testing.assert_allclose(sims[i], want, atol=1e-5, rtol=0)
