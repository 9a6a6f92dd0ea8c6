"""Rematerialisation in the port (``MVLTConfig.remat_backbone`` /
``remat_fusion``: ``ops.layers.rematerialized`` around each Swin block and
each fusion layer) against JAX's ``nn.remat`` and against the port without
it.

- The tiny Swin pretrain model of ``test_torch_swin_train.py`` (DropPath
  0.3, fusion dropouts 0.1) with each flag and both: the loss and every
  gradient against JAX's remat model within 1e-4 (x max|grad| per tensor),
  on JAX's masks replayed; JAX's remat draws each mask once, and so does
  the port.
- The port with remat against without, both mask modes: equal losses,
  gradients within 1e-6 x max, the recompute ran (each block / layer's
  forward twice), a replayed list consumed exactly as without remat and a
  recording source recording the same draws.
- In-kernel attention dropout (``MVLT_KERNEL_DROPOUT``, bf16 compute): one
  seed a layer with remat as without, the same loss and gradients.
- A decode with ``remat_fusion`` runs and equals the one without
  (``tests/test_remat.py:49``); ViT / ResNet / the linear patch with
  ``remat_backbone`` train exactly as without it (JAX remats only Swin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models import fusion as pfusion
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import CaptionModel, PretrainModel, VQAModel
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax

torch.set_num_threads(2)

B, L, IMG = 2, 7, 32
KEYS = ("image", "caption_masked", "caption_label", "itm_label")
FLAGS = {"backbone": dict(remat_backbone=True),
         "fusion": dict(remat_fusion=True),
         "both": dict(remat_backbone=True, remat_fusion=True)}


def _jax_config(**remat):
    cfg = jcfg.MVLTConfig.for_pretrain(itm_task=True, mlm_gather_k=4)
    return dataclasses.replace(
        cfg, conv="swin",
        swin=dataclasses.replace(jcfg.swin_tiny_test(), depths=(2, 2),
                                 drop_path_rate=0.3),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, vocab_size=300),
        **remat)


def _port_config(cfg):
    return pcfg.MVLTConfig.from_json(cfg.to_json())


def _batch():
    batch = flagship.example_pretrain_batch(B, L, seed=3, image_size=IMG,
                                            vocab=300)
    return {k: v.numpy() for k, v in batch.items()}


def _inject_masks(monkeypatch, seed):
    rng, drawn = np.random.default_rng(seed), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = rng.random(tuple(shape)) < p
        drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


@pytest.fixture(scope="module")
def tiny():
    cfg = _jax_config()
    batch = _batch()
    args = [jnp.asarray(batch["image"])] + [jnp.asarray(batch[k], jnp.int32)
                                            for k in KEYS[1:]]
    variables = jax.jit(JaxPretrain(cfg).init)(jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return {"params": params}, batch


def _port_model(cfg, variables):
    model = PretrainModel(_port_config(cfg), device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))   # strict
    return model


def _port_loss(model, batch, masks, seq2seq):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(*(torch.from_numpy(batch[k]) for k in KEYS),
                         seq2seq=seq2seq, masks=masks)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


class _Calls:
    """Counts the forwards of Swin blocks and fusion layers."""

    def __init__(self, monkeypatch):
        self.n = {"block": 0, "layer": 0}
        for what, cls in (("block", pswin.SwinBlock),
                          ("layer", pfusion.EncoderLayer)):
            monkeypatch.setattr(cls, "forward", self._wrap(what, cls.forward))

    def _wrap(self, what, forward):
        def counted(module, *a, **kw):
            self.n[what] += 1
            return forward(module, *a, **kw)
        return counted


@pytest.mark.parametrize("flags,seq2seq", [("backbone", False),
                                           ("fusion", True),
                                           ("both", False), ("both", True)])
def test_remat_matches_jax_remat(tiny, flags, seq2seq, monkeypatch):
    variables, batch = tiny
    cfg = _jax_config(**FLAGS[flags])
    drawn = _inject_masks(monkeypatch, 7)
    jmodel = JaxPretrain(cfg)
    args = [jnp.asarray(batch["image"])] + [jnp.asarray(batch[k], jnp.int32)
                                            for k in KEYS[1:]]

    def loss_fn(params):
        return jmodel.apply({"params": params}, *args, seq2seq=seq2seq,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    S = 1 + 16 + 1 + L
    assert [m.shape for m in drawn] == [(B, 1, 1)] * 6 + [
        (B, 2, S, S), (B, S, 16), (B, S, 16)] * 2    # each drawn once
    model = _port_model(cfg, variables)
    calls = _Calls(monkeypatch)
    masks = DropoutMasks.replay(m.reshape(B) if m.shape == (B, 1, 1) else m
                                for m in drawn)
    loss, got = _port_loss(model, batch, masks, seq2seq)
    assert next(masks._replay, None) is None
    assert calls.n == {"block": 4 * (1 + ("fusion" != flags)),
                       "layer": 2 * (1 + ("backbone" != flags))}
    assert abs(loss - float(want_loss)) <= 1e-5 * max(1.0, abs(loss))
    want = pretrain_params_from_flax({"params": grads})
    unused = "mlm_head_bidir." if seq2seq else "mlm_head_seq2seq."
    for name, g in got.items():
        w = want[name].numpy()
        if name.startswith(unused):
            assert g is None and not w.any(), name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("seq2seq", [False, True])
def test_remat_equals_no_remat(tiny, seq2seq, monkeypatch):
    """Both flags against none, on one recorded mask list: equal losses,
    gradients within 1e-6 x max|grad|; the remat run's recording source
    records the same draws as the first run's, and its replay consumes the
    list exactly; every block and layer ran twice."""
    variables, batch = tiny
    plain = _port_model(_jax_config(), variables)
    rem = _port_model(_jax_config(**FLAGS["both"]), variables)
    assert rem.conv.backbone.remat and rem.fusion.remat
    first = DropoutMasks(torch.Generator().manual_seed(5), record=True)
    want_loss, want = _port_loss(plain, batch, first, seq2seq)
    again = DropoutMasks(torch.Generator().manual_seed(5), record=True)
    calls = _Calls(monkeypatch)
    loss, got = _port_loss(rem, batch, again, seq2seq)
    assert calls.n == {"block": 8, "layer": 4}
    assert len(again.recorded) == len(first.recorded) == 6 + 3 * 2
    assert all(torch.equal(a, b) for a, b in zip(again.recorded,
                                                 first.recorded))
    replay = DropoutMasks.replay(first.recorded)
    loss2, got2 = _port_loss(rem, batch, replay, seq2seq)
    assert next(replay._replay, None) is None
    assert loss == loss2 == want_loss
    for name, w in want.items():
        if w is None:
            assert got[name] is None and got2[name] is None, name
            continue
        bar = 1e-6 * max(float(w.abs().max()), 1e-12)
        for g in (got[name], got2[name]):
            assert float((g - w).abs().max()) <= bar, name


def test_remat_replay_running_dry_raises(tiny):
    """A replayed list one mask short fails in the forward, as without
    remat: the recompute never takes a mask of its own."""
    variables, batch = tiny
    model = _port_model(_jax_config(**FLAGS["both"]), variables)
    rec = DropoutMasks(torch.Generator().manual_seed(5), record=True)
    _port_loss(model, batch, rec, False)
    with pytest.raises(RuntimeError, match="left to replay"):
        _port_loss(model, batch, DropoutMasks.replay(rec.recorded[:-1]),
                   False)


def test_kernel_dropout_seed_drawn_once_per_layer(tiny, monkeypatch):
    """``MVLT_KERNEL_DROPOUT=1`` with bf16 compute: the fusion layers draw
    a (2,) seed in place of the attention mask; with ``remat_fusion`` each
    layer draws it once, the recompute reuses it, and the loss and
    gradients equal the run without remat on the same draws."""
    monkeypatch.setenv("MVLT_KERNEL_DROPOUT", "1")
    variables, batch = tiny
    runs = {}
    for name, flags in (("off", {}), ("on", FLAGS["fusion"])):
        model = PretrainModel(_port_config(_jax_config(**flags)),
                              device="cpu", compute_dtype=torch.bfloat16)
        model.load_state_dict(pretrain_params_from_flax(variables))
        src = DropoutMasks(torch.Generator().manual_seed(9), record=True)
        runs[name] = (_port_loss(model, batch, src, True), src.recorded)
    (want_loss, want), drawn = runs["off"]
    (loss, got), drawn_on = runs["on"]
    seeds = [t for t in drawn_on if t.dtype == torch.int32]
    assert len(seeds) == 2 and all(t.shape == (2,) for t in seeds)
    assert len(drawn_on) == len(drawn)
    assert all(torch.equal(a, b) for a, b in zip(drawn_on, drawn))
    assert loss == want_loss
    for name, w in want.items():
        if w is not None:
            torch.testing.assert_close(got[name], w, rtol=0, atol=0)


def test_remat_decode_runs():
    """Greedy and beam decodes of a caption model with ``remat_fusion``
    (no autograd: the layers run as they are) equal the ones without."""
    base = jcfg.MVLTConfig(
        conv="linear", is_decoder=True, max_length=6, cls_token_id=3,
        sep_token_id=4, eos_token_id=5, mask_token_id=6, pad_token_id=0,
        fusion=jcfg.FusionConfig(hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=64,
                                 vocab_size=64, max_position_embeddings=64))
    gen, image = flagship.build_caption_generate(
        batch=2, num_beams=2, max_length=6, dtype=torch.float32, device="cpu",
        config=_port_config(dataclasses.replace(base, remat_fusion=True)),
        image_size=IMG)
    ref, _ = flagship.build_caption_generate(
        batch=2, num_beams=2, max_length=6, dtype=torch.float32, device="cpu",
        config=_port_config(base), image_size=IMG)
    assert gen.model.fusion.remat and not ref.model.fusion.remat
    for kw in ({}, {"num_beams": 1}):
        a, b = gen(image, **kw), ref(image, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.isfinite(a[-1]).all()


@pytest.mark.parametrize("conv", ["vit", "resnet50", "linear"])
def test_remat_backbone_leaves_other_backbones(conv):
    """JAX remats only the Swin blocks: on the other backbones the flag
    changes nothing, and the VQA loss and gradients equal the run
    without it."""
    extra = {"vit": dict(vit=pcfg.ViTConfig(image_size=IMG, num_layers=2,
                                            num_heads=2, hidden_dim=32,
                                            mlp_dim=64)),
             "resnet50": dict(resnet=pcfg.ResNetConfig(layers=(1, 1),
                                                       width=8))}
    cfg = pcfg.MVLTConfig(
        conv=conv, result_num=4, cls_token_id=3, sep_token_id=4,
        eos_token_id=5, mask_token_id=6,
        fusion=pcfg.FusionConfig(hidden_size=32, num_hidden_layers=1,
                                 num_attention_heads=4, intermediate_size=64,
                                 vocab_size=64, max_position_embeddings=64),
        **extra.get(conv, {}))
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.normal(size=(2, 3, IMG, IMG))
                             .astype(np.float32))
    question = torch.from_numpy(rng.integers(1, 64, (2, 5)))
    label = torch.tensor([1, 3])
    out = []
    for remat in (False, True):
        model = VQAModel(dataclasses.replace(cfg, remat_backbone=remat),
                         device="cpu")
        flagship.init_seeded_(model, 0)
        loss, _ = model.loss(image, question, label)
        loss.backward()
        out.append((loss, {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
