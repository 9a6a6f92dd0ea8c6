"""The port's VQA slice as a whole against the JAX package, on the same
weights (through ``vqa_params_from_flax``) and the same inputs.

The tiny config crosses every structural case of the flagship path: a
shifted (SW-MSA) block, a patch merge, a stage whose map equals the window
(shift dropped, one window), a backbone width that differs from the fusion
width (``resnet_fc``), and padded question tokens. float32 logits and
features must agree to 1e-4.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import MVLTConfig, SwinConfig
from mvlt_tpu.models.backbones.swin import SwinTransformer as JaxSwin
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu_torch.flagship import flagship_vqa_config, init_seeded_
from mvlt_tpu_torch.models import heads
from mvlt_tpu_torch.models.backbones import swin as port_swin
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.ops import blocks
from mvlt_tpu_torch.utils.convert import vqa_params_from_flax

torch.set_num_threads(2)

SWIN = SwinConfig(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                  num_heads=(2, 4), window_size=4, drop_path_rate=0.0)


def tiny_config() -> MVLTConfig:
    cfg = MVLTConfig.for_vqa(result_num=10)
    return dataclasses.replace(
        cfg, conv="swin", swin=SWIN,
        fusion=dataclasses.replace(cfg.fusion, hidden_size=48,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   intermediate_size=96, vocab_size=300))


def _perturb(tree, seed):
    """Every leaf + normal(0, 0.05): LN gammas / betas and biases become
    non-trivial, so each parameter's mapping shows in the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    question = rng.integers(1, 300, size=(2, 7))
    question[0, 4:] = 0                      # padded question tokens
    return image, question


@pytest.fixture(scope="module")
def tiny():
    """(config, perturbed flax variables, image, question, JAX XLA logits)."""
    cfg = tiny_config()
    image, question = _inputs()
    model = JaxVQA(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(image),
                           jnp.asarray(question, jnp.int32))
    variables = _perturb(variables, 1)
    _, logits = model.apply(variables, jnp.asarray(image),
                            jnp.asarray(question, jnp.int32))
    return cfg, variables, image, question, np.asarray(logits)


def _port(cfg, variables, dtype=torch.float32):
    model = VQAModel(cfg, dtype=dtype)
    model.load_state_dict(vqa_params_from_flax(variables))
    return model


def _port_logits(model, image, question, plain=False):
    _, logits = model(torch.from_numpy(image), torch.from_numpy(question),
                      plain=plain)
    return logits.float().numpy()


@pytest.mark.parametrize("plain", [False, True])
def test_vqa_logits_match_jax_xla(tiny, plain):
    cfg, variables, image, question, want = tiny
    got = _port_logits(_port(cfg, variables), image, question, plain)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_vqa_logits_match_jax_fused_encoder(tiny, monkeypatch):
    """JAX with its BERT layers on the Pallas kernels in interpret mode
    (``fused_attn_ln`` / ``fused_mlp_ln``)."""
    cfg, variables, image, question, _ = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    _, want = JaxVQA(cfg).apply(variables, jnp.asarray(image),
                                jnp.asarray(question, jnp.int32))
    got = _port_logits(_port(cfg, variables), image, question)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_vqa_logits_half_block_route(tiny, monkeypatch):
    """The stage-4 route (LN1 -> window_block_attention (+x) ->
    fused_mlp_preln) on the last stage, whose map equals the window, as at
    Swin-S 224."""
    cfg, variables, image, question, want = tiny
    monkeypatch.setattr(port_swin, "uses_half_blocks", lambda dim: dim >= 64)
    got = _port_logits(_port(cfg, variables), image, question)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_half_block_route_refuses_a_shifted_block(tiny, monkeypatch):
    """A shifted block on the half route (stage 1 here: an 8 x 8 map,
    window 4, shift 2; Swin-S stage 4 at 448) was refused until the wide
    routes took the roll. It is served now as JAX's
    ``_fused_half_blocks`` serves it: the map rolled around the partition,
    the shift mask in the bias; the logits match JAX's in f32."""
    cfg, variables, image, question, want = tiny
    monkeypatch.setattr(port_swin, "uses_half_blocks", lambda dim: True)
    got = _port_logits(_port(cfg, variables), image, question)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["interpret_full", "interpret_half"])
def test_swin_features_match_jax_interpret_kernels(monkeypatch, impl):
    """Backbone features against JAX running its whole-block
    (``_full_kernel`` / ``_full_shift_kernel``) or half-block
    (``swin_attn_half`` / ``fused_mlp_preln``) Pallas kernels in interpret
    mode; the port takes the matching route. The half route runs unshifted
    blocks only (one per stage), as on the flagship."""
    rng = np.random.default_rng(2)
    image = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    swin = SWIN if impl == "interpret_full" else dataclasses.replace(
        SWIN, depths=(1, 1))
    jmodel = JaxSwin(swin, attn_impl=impl)
    params = _perturb(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(image)),
                      4)
    want = jmodel.apply(params, jnp.asarray(image))
    if impl == "interpret_half":
        monkeypatch.setattr(port_swin, "uses_half_blocks", lambda dim: True)
    sd = vqa_params_from_flax({"conv": {"backbone": params["params"]}})
    model = port_swin.SwinTransformer(swin, dtype=torch.float32, device="cpu")
    model.load_state_dict({k[len("conv.backbone."):]: v
                           for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(image), blocks.PLAIN_OPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_vqa_bf16_logits_near_jax_bf16(tiny):
    """Both packages in bf16 from the same f32 weights. The JAX XLA path and
    the port round at different places (the port keeps LN in f32 and rounds
    once per kernel). Bar: 1e-2 absolute on logits of magnitude ~0.3; the
    gap is ~3e-3, as large as the JAX bf16 path's own gap from its f32
    logits."""
    cfg, variables, image, question, _ = tiny
    _, want = JaxVQA(cfg, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(image), jnp.asarray(question, jnp.int32))
    got = _port_logits(_port(cfg, variables, torch.bfloat16), image, question)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-2,
                               rtol=0)


def _counting_ops(counts):
    def counted(name, fn):
        def call(x, *args, **kw):
            key = name + ("_shift" if kw.get("shift_spec") is not None else "")
            counts[key] = counts.get(key, 0) + 1
            return fn(x, *args, **kw)
        return call
    return SimpleNamespace(**{k: counted(k, v)
                              for k, v in vars(blocks.PLAIN_OPS).items()})


def test_flagship_routing_counts_on_meta_device(monkeypatch):
    """The flagship forward (Swin-S @224 + BERT-base, b8, 23 question
    tokens) walked on the meta device, which allocates and computes nothing:
    each TPU-kernel counterpart is called as often as the JAX path calls its
    kernel (11 / 11 / 2 / 2 / 12 / 12), and the logits come out (8, 224)."""
    counts = {}
    monkeypatch.setattr(heads, "PLAIN_OPS", _counting_ops(counts))
    model = VQAModel(flagship_vqa_config(), dtype=torch.bfloat16,
                     device="meta")
    image = torch.empty(8, 3, 224, 224, device="meta")
    question = torch.ones(8, 23, dtype=torch.long, device="meta")
    _, logits = model(image, question, plain=True)
    assert logits.shape == (8, 224) and logits.dtype == torch.bfloat16
    assert {k: v for k, v in counts.items()
            if k not in ("gemm", "layernorm")} == {
        "swin_full_block": 11, "swin_full_block_shift": 11,
        "window_block_attention": 2, "fused_mlp_preln": 2,
        "fused_attn_ln": 12, "fused_mlp_ln": 12}


def test_stage4_shift_is_dropped_when_map_equals_window():
    """Swin-S stage 4 (7x7 map, window 7) has no shift and one window, and
    is the only stage routed through the half blocks."""
    cfg = flagship_vqa_config().swin
    model = port_swin.SwinTransformer(cfg, dtype=torch.bfloat16, device="meta")
    for i, stage in enumerate(model.stages):
        for j, block in enumerate(stage):
            assert block.window == 7
            assert block.shift == (0 if i == 3 or j % 2 == 0 else 3)
            assert port_swin.uses_half_blocks(block.dim) == (i == 3)


def test_adapter_refusals_name_their_roadmap_items():
    """ViT training with dropout was the adapter's last refusal of a
    ROADMAP.md queue-A item ('Other backbones'); it now trains: with a mask
    source the ViT draws its masks (here the attention dropout's one (1, 1,
    N, N) mask a block), without one it is deterministic. A conv that JAX does not have is refused. Two-view
    images, float or
    uint8, were refused ('Adapter inputs') until the caption driver: each
    view now goes through its own backbone call, and the tokens of view 0
    come first."""
    from mvlt_tpu_torch.config import MVLTConfig as PortConfig
    from mvlt_tpu_torch.config import SwinConfig as PortSwin
    from mvlt_tpu_torch.config import ViTConfig as PortViT
    from mvlt_tpu_torch.models.backbones.adapter import VisualAdapter
    from mvlt_tpu_torch.ops.blocks import PLAIN_OPS
    cfg = PortConfig.for_vqa(result_num=10)
    vit = VisualAdapter(dataclasses.replace(
        cfg, conv="vit", vit=PortViT(image_size=32, patch_size=8,
                                     num_layers=1, num_heads=2, hidden_dim=16,
                                     mlp_dim=32, attention_dropout=0.1)),
        dtype=torch.float32, device="cpu")
    init_seeded_(vit)
    from mvlt_tpu_torch.ops.layers import DropoutMasks
    masks = DropoutMasks(torch.Generator().manual_seed(0), record=True)
    image = torch.randn(1, 3, 32, 32, generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        dropped = vit(image, PLAIN_OPS, train=True, masks=masks)
        served = vit(image, PLAIN_OPS, train=True)
    # attention_dropout 0.1, dropout 0: one layer's (1, 1, N, N) mask
    assert [tuple(m.shape) for m in masks.recorded] == [(1, 1, 17, 17)]
    assert dropped.shape == served.shape == (1, 16, 768)
    assert not torch.equal(dropped, served)
    with pytest.raises(NotImplementedError, match="no such config.conv"):
        VisualAdapter(dataclasses.replace(cfg, conv="vgg"),
                      dtype=torch.float32, device="cpu")
    swin = PortSwin(img_size=32, patch_size=4, embed_dim=32, depths=(2, 2),
                    num_heads=(2, 4), window_size=4, drop_path_rate=0.0)
    adapter = VisualAdapter(dataclasses.replace(cfg, conv="swin", swin=swin),
                            dtype=torch.float32, device="cpu")
    init_seeded_(adapter)
    gen = torch.Generator().manual_seed(0)
    for image in (torch.randn(2, 2, 3, 32, 32, generator=gen),
                  torch.randint(0, 256, (2, 2, 32, 32, 3), generator=gen,
                                dtype=torch.uint8)):
        with torch.no_grad():
            tokens = adapter(image, PLAIN_OPS)
            views = [adapter(image[:, v], PLAIN_OPS) for v in (0, 1)]
        assert tokens.shape == (2, 32, 768)
        torch.testing.assert_close(tokens, torch.cat(views, 1), rtol=0,
                                   atol=0)
