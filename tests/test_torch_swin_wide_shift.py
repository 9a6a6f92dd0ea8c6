"""Shifted wide Swin stages and ``ape=True`` in the port, against the JAX
package on the same numpy inputs (Pallas kernels in interpret mode).

- A width-768 Swin block (24 heads) on a 14 x 14 map, window 7, shift 3
  (Swin-S stage 4 at 448), serving: against JAX's ``interpret_half`` route
  (``_fused_half_blocks``: the map rolled, the shift mask in the bias,
  ``swin_attn_half`` falling back to LN1 + ``_block_kernel`` and
  ``fused_mlp_preln``) and against JAX's ``auto`` route on the CPU (its plain
  route). The port serves it on row 1 + row 6 with the roll.
- The same with window 8 on a 16 x 16 map (shift 4, merged N = 128, P = 2),
  where JAX's ``swin_attn_half`` runs ``_attn_half_kernel`` (its fallback
  patched to raise) and the port row 7.
- A width-1024 shifted block (Swin-B's stage 4 at 448), served on JAX's plain
  route: LN1 -> roll -> row 1 (+x) -> LN2 -> ``Mlp``.
- The width-768 shifted block in training: ``swin_half_block`` (row 18)
  with the shift gather, against the VJP of JAX's ``interpret_half``
  training route (``_fused_half_train``), every input's gradient.
- A tiny Swin VQA model with ``ape=True``: logits, the loss and every
  gradient, the absolute position table's included, against JAX; and in
  bf16 near JAX's bf16.
- The routing of Swin-S @448 serving and of its step on the meta device.

float32 agrees to 1e-4 x max|ref| per tensor; the bf16 test states its bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import MVLTConfig, SwinConfig
from mvlt_tpu.models.backbones import swin as jswin
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu.ops import pallas_attn
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import PretrainModel, VQAModel
from mvlt_tpu_torch.ops import blocks
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils.convert import params_from_flax, vqa_params_from_flax
from test_torch_attn_impl import _count_plain_ops, _only

torch.set_num_threads(2)

SERVING_ROWS = ("swin_attn_half", "window_block_attention",
                "fused_mlp_preln", "swin_full_block")


def _close(got, want, tol=1e-4, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _perturb(tree, seed, std=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, std, np.shape(a)).astype(np.float32), tree)


def _block_pair(C, heads, res, window, shift, seed, impl):
    """(JAX ``SwinBlock`` on ``impl``, perturbed flax variables, the port's
    block holding them, x (1, res * res, C))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, res * res, C)).astype(np.float32)
    jblock = jswin.SwinBlock(dim=C, input_resolution=(res, res),
                             num_heads=heads, window_size=window,
                             shift_size=shift, attn_impl=impl)
    variables = _perturb(jax.jit(jblock.init)(jax.random.PRNGKey(seed),
                                              jnp.asarray(x)), seed + 1)
    sd = params_from_flax({"conv": {"backbone": {
        "layers_0_blocks_0": variables["params"]}}})
    pre = "conv.backbone.stages.0.0."
    block = pswin.SwinBlock(C, (res, res), heads, window, shift, 4.0, True,
                            None, dtype=torch.float32, device="cpu")
    block.load_state_dict({k[len(pre):]: v for k, v in sd.items()})
    assert block.shift == shift and block.window == window
    return jblock, variables, block, x


# (C, heads, map, window, shift, the rows the port serves it on)
SHIFTED = {
    "w768_win7": (768, 24, 14, 7, 3,
                  {"window_block_attention": 1, "fused_mlp_preln": 1}),
    "w768_win8": (768, 24, 16, 8, 4,
                  {"swin_attn_half": 1, "fused_mlp_preln": 1}),
    "w1024_win7": (1024, 32, 14, 7, 3, {"window_block_attention": 1}),
}


@pytest.mark.parametrize("case", list(SHIFTED))
def test_shifted_wide_block_serves_as_jax(case, monkeypatch):
    """The shifted wide block's serving output against JAX's half-block
    Pallas route in interpret mode (width 768: at window 7 its
    ``swin_attn_half`` falls back, at window 8 it runs its own kernel,
    checked by patching the other way to raise) and against JAX's plain
    route on the CPU (all three); the port takes the rows JAX's route
    would."""
    C, heads, res, window, shift, rows = SHIFTED[case]
    jblock, variables, block, x = _block_pair(C, heads, res, window, shift,
                                              7, "auto")
    wants = [jblock.apply(variables, jnp.asarray(x))]
    if C == 768:
        fallback = pallas_attn._block_forward_with_ln_fallback
        took = []

        def spy(*a):
            took.append(1)
            if "swin_attn_half" in rows:
                raise AssertionError("JAX fell back where the port runs "
                                     "row 7")
            return fallback(*a)
        monkeypatch.setattr(pallas_attn, "_block_forward_with_ln_fallback",
                            spy)
        half = jswin.SwinBlock(dim=C, input_resolution=(res, res),
                               num_heads=heads, window_size=window,
                               shift_size=shift, attn_impl="interpret_half")
        wants.append(half.apply(variables, jnp.asarray(x)))
        assert bool(took) == ("swin_attn_half" not in rows)
        monkeypatch.undo()
    assert pswin.uses_half_blocks(C)
    counts = _count_plain_ops(monkeypatch)
    with torch.no_grad():
        got = block(torch.from_numpy(x), blocks.PLAIN_OPS)
    assert _only(counts, SERVING_ROWS) == rows
    for want in wants:
        _close(got, want, what=case)


def test_shifted_wide_block_trains_as_jax_half_train():
    """The width-768 shifted block in training: the port's
    ``swin_half_block`` with the shift gather (row 18; rows 19 / 21 inside)
    against ``jax.vjp`` of JAX's ``interpret_half`` training route
    (``_fused_half_train``: roll, ``swin_half_block`` with the shifted bias,
    roll back). The gradients of x, of every block parameter and of the
    relative-position table."""
    C, heads, res, window, shift = 768, 24, 14, 7, 3
    jblock, variables, block, x = _block_pair(C, heads, res, window, shift,
                                              11, "interpret_half")
    cot = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def f(params, xx):
        return jblock.apply({"params": params}, xx, deterministic=False)

    want, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    calls = {}
    real = blocks.PLAIN_OPS.swin_half_block

    def spy(*a, **kw):
        calls["shift_spec"] = kw.get("shift_spec")
        return real(*a, **kw)
    plain = type(blocks.PLAIN_OPS)(**{**vars(blocks.PLAIN_OPS),
                                      "swin_half_block": spy})
    got = block(xt, plain)
    assert calls["shift_spec"] == (res, res, window, shift)
    _close(got, want, what="forward")
    got.backward(torch.from_numpy(cot))
    _close(xt.grad, gx, what="dx")
    want_g = params_from_flax({"conv": {"backbone": {
        "layers_0_blocks_0": gp}}})
    pre = "conv.backbone.stages.0.0."
    for name, p in block.named_parameters():
        _close(p.grad, want_g[pre + name].numpy(), what=name)


# --- ape ----------------------------------------------------------------------

SWIN_APE = SwinConfig(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                      num_heads=(2, 4), window_size=4, drop_path_rate=0.0,
                      ape=True)


def _ape_config() -> MVLTConfig:
    cfg = MVLTConfig.for_vqa(result_num=10)
    return dataclasses.replace(
        cfg, conv="swin", swin=SWIN_APE,
        fusion=dataclasses.replace(cfg.fusion, hidden_size=48,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   intermediate_size=96, vocab_size=300,
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0))


def _port_cfg(cfg):
    from mvlt_tpu_torch.config import MVLTConfig as PortConfig
    return PortConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def ape():
    """(config, perturbed flax variables, image, question, label)."""
    cfg = _ape_config()
    rng = np.random.default_rng(21)
    image = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    question = rng.integers(1, 300, size=(2, 7))
    question[0, 4:] = 0
    label = np.array([3, 7])
    variables = jax.jit(JaxVQA(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(image),
        jnp.asarray(question, jnp.int32))
    variables = _perturb(variables, 22)
    table = variables["params"]["conv"]["backbone"]["absolute_pos_embed"]
    assert table.shape == (1, 64, 32)
    return cfg, variables, image, question, label


def test_ape_logits_loss_and_grads_match_jax(ape):
    """The tiny Swin VQA model with ``ape=True``: f32 logits (the port's
    serving route), then the training loss and every gradient through the
    port's training route (the absolute position table's, the
    relative-position tables' and the fusion's) against ``jax.grad`` of
    JAX's loss; the tree loads strictly."""
    cfg, variables, image, question, label = ape
    jm = JaxVQA(cfg)
    args = (jnp.asarray(image), jnp.asarray(question, jnp.int32))
    _, want_logits = jax.jit(jm.apply)(variables, *args)

    def loss_fn(params):
        return jm.apply({"params": params}, *args,
                        jnp.asarray(label, jnp.int32), deterministic=True,
                        method=JaxVQA.loss)

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model = VQAModel(_port_cfg(cfg), dtype=torch.float32, device="cpu")
    model.load_state_dict(vqa_params_from_flax(variables))        # strict
    assert model.conv.backbone.absolute_pos_embed.shape == (1, 64, 32)
    with torch.no_grad():
        _, logits = model(torch.from_numpy(image), torch.from_numpy(question))
    _close(logits, want_logits, what="logits")
    loss, _ = model.loss(torch.from_numpy(image), torch.from_numpy(question),
                         torch.from_numpy(label), plain=True)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    loss.backward()
    want = vqa_params_from_flax({"params": grads})
    assert "conv.backbone.absolute_pos_embed" in want
    for name, p in model.named_parameters():
        _close(p.grad, want[name].numpy(), what=name)


def test_ape_bf16_logits_near_jax_bf16(ape):
    """Both packages in bf16 from the same f32 weights. JAX adds the f32
    table to the bf16 embedding, so its Swin residual stream is f32 from
    there on; the port rounds the sum to bf16 once and keeps its stream in
    the compute dtype. Bar: 1e-2 absolute on logits of magnitude ~0.5, as
    ``test_torch_model.py`` bounds the bf16 forward without ``ape``."""
    cfg, variables, image, question, _ = ape
    _, want = jax.jit(JaxVQA(cfg, dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(image), jnp.asarray(question, jnp.int32))
    model = VQAModel(_port_cfg(cfg), dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(vqa_params_from_flax(variables))
    with torch.no_grad():
        _, got = model(torch.from_numpy(image), torch.from_numpy(question))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2,
                               rtol=0)


# --- Swin-S @448 on the meta device ---------------------------------------------

def test_swin_s_448_routing_on_meta(monkeypatch):
    """Swin-S @448 (window 7) serving at b8, walked on the meta device: the
    maps are 112 / 56 / 28 / 14, stage 4 has 4 windows an image and its
    second block is shifted; each TPU-kernel counterpart runs as often as
    at 224 (11 / 11 whole blocks, 2 + 2 halves), stage 4's shifted block on
    row 1 with P = nW = 4 patterns; the logits are (8, 224) over S = 221.
    The step of record at 448 runs ``swin_half_block`` twice, once with the
    shift gather."""
    cfg = flagship.flagship_swin448_vqa_config()
    model = VQAModel(cfg, dtype=torch.bfloat16, device="meta")
    stage4 = model.conv.backbone.stages[3]
    assert [(b.window, b.shift) for b in stage4] == [(7, 0), (7, 3)]
    assert stage4[1].attention_bias().shape == (4, 24, 49, 49)
    counts = _count_plain_ops(monkeypatch)
    patterns = []
    real = blocks.PLAIN_OPS.window_block_attention

    def spy(x, *a, **kw):
        patterns.append(a[4].shape[0])
        return real(x, *a, **kw)
    monkeypatch.setattr(blocks.PLAIN_OPS, "window_block_attention", spy)
    image = torch.empty(8, 3, 448, 448, device="meta")
    question = torch.ones(8, 23, dtype=torch.long, device="meta")
    with torch.no_grad():
        _, logits = model(image, question, plain=True)
    assert logits.shape == (8, 224)
    assert _only(counts, SERVING_ROWS + ("fused_attn_ln", "fused_mlp_ln")) \
        == {"swin_full_block": 22, "window_block_attention": 2,
            "fused_mlp_preln": 2, "fused_attn_ln": 12, "fused_mlp_ln": 12}
    assert patterns == [1, 4]

    step_cfg = flagship.flagship_swin448_pretrain_config()
    pm = PretrainModel(step_cfg, dtype=torch.float32, device="meta",
                       compute_dtype=torch.bfloat16)
    specs = []
    real_half = blocks.PLAIN_OPS.swin_half_block

    def half(*a, **kw):
        specs.append(kw.get("shift_spec"))
        return real_half(*a, **kw)
    monkeypatch.setattr(blocks.PLAIN_OPS, "swin_half_block", half)
    batch = {"image": torch.empty(2, 3, 448, 448, device="meta"),
             "caption_masked": torch.ones(2, 80, dtype=torch.long,
                                          device="meta"),
             "caption_label": torch.ones(2, 80, dtype=torch.long,
                                         device="meta"),
             "itm_label": torch.ones(2, dtype=torch.long, device="meta")}
    gen = torch.Generator(device="cpu").manual_seed(0)
    masks = _MetaMasks(gen)
    loss, _ = pm.loss(*(batch[k] for k in ("image", "caption_masked",
                                           "caption_label", "itm_label")),
                      plain=True, masks=masks)
    assert specs == [None, (14, 14, 7, 3)]


class _MetaMasks(DropoutMasks):
    """Keep-all masks on the meta device (the draws are not read there)."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)

    def seed(self, device):
        return torch.zeros(2, dtype=torch.int32, device=device)
