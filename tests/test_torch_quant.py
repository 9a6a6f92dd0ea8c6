"""The port's weight-only int8 serving (``mvlt_tpu_torch/ops/quant.py``)
against the JAX package's (``mvlt_tpu/ops/quant.py``): ``quantize_int8`` /
``dequantize_int8`` bitwise on seeded arrays with a zero column and exact
half-way values; for each backbone ('swin', 'vit', 'linear', 'resnet50')
the set of quantized tensors, every int8 tensor and every scale bitwise
against JAX's ``quantize_tree`` mapped onto the port's names (the fusion's
fused q / k / v as JAX's three kernels concatenated, ViT-B/16's 3-D
attention kernels left out, the embeddings on their hidden axis), the count
and ``quantized_bytes``; the int8w caption decode (beam 2) token for token
against JAX's int8w decode, and the int8w VQA logits within 1e-4.

The models are tiny and float32, with every width that should quantize at
64 or more (JAX's predicate takes 2-D leaves with both dims >= 64). As in
JAX's ``eval_caption``, the weights are dequantized to bf16 and the model
computes in its own dtype (f32 here: the bf16 values promote exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.generation import GenerationSpec as JaxSpec
from mvlt_tpu.models.generation import generate as jax_generate
from mvlt_tpu.models.heads import CaptionModel as JaxCaption
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu.ops import quant as jquant
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models import generation as pgen
from mvlt_tpu_torch.models.heads import CaptionModel, VQAModel
from mvlt_tpu_torch.ops import quant
from mvlt_tpu_torch.utils.convert import _port_name, params_from_flax

torch.set_num_threads(2)

IMG = 32
FUSION = jcfg.FusionConfig(vocab_size=128, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=128, max_position_embeddings=64)
BACKBONES = {
    "swin": dict(swin=jcfg.SwinConfig(img_size=IMG, patch_size=4,
                                      embed_dim=32, depths=(2, 2),
                                      num_heads=(2, 4), window_size=4,
                                      drop_path_rate=0.0)),
    "vit": dict(vit=jcfg.ViTConfig(image_size=IMG, patch_size=16,
                                   num_layers=2, num_heads=2, hidden_dim=64,
                                   mlp_dim=128)),
    "linear": {},
    "resnet50": dict(resnet=jcfg.ResNetConfig(layers=(1, 1), width=16)),
}


def _jax_config(conv):
    return jcfg.MVLTConfig(fusion=FUSION, conv=conv, is_decoder=True,
                           max_length=6, cls_token_id=3, sep_token_id=4,
                           eos_token_id=5, mask_token_id=6, pad_token_id=0,
                           result_num=8, **BACKBONES[conv])


def _port_config(cfg):
    return pcfg.MVLTConfig.from_json(cfg.to_json())


def _image(seed, n=2):
    return np.random.default_rng(seed).normal(
        size=(n, 3, IMG, IMG)).astype(np.float32)


@pytest.fixture(scope="module", params=list(BACKBONES))
def caption(request):
    """(conv, JAX config, variables, port model) of one backbone."""
    cfg = _jax_config(request.param)
    variables = jax.jit(JaxCaption(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(_image(0)),
        jnp.ones((2, 5), jnp.int32))
    variables = jax.tree.map(np.asarray, variables)
    model = CaptionModel(_port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(variables))          # strict
    return request.param, cfg, variables, model


def test_quantize_int8_is_bitwise_jax():
    """Seeded arrays of several scales, a zero column, and a column whose
    amax is 127 (scale 1) holding exact half-way values, which both round
    half to even."""
    rng = np.random.default_rng(0)
    arrays = [(rng.normal(size=s) * rng.uniform(0.01, 3)).astype(np.float32)
              for s in ((64, 64), (300, 128), (128, 65), (7, 3, 96))]
    w = rng.normal(size=(16, 8)).astype(np.float32)
    w[:, 2] = 0.0
    w[:, 5] = [127.0, -127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, 126.5,
               -126.5, 63.5, 0.0, 4.5, -4.5, 5.5]
    arrays.append(w)
    for a in arrays:
        jq, js = jquant.quantize_int8(jnp.asarray(a))
        q, s = quant.quantize_int8(torch.from_numpy(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            got = quant.dequantize_int8(q, s, dtype=dtype).float().numpy()
            want = np.asarray(jquant.dequantize_int8(jq, js, jdtype),
                              np.float32)
            np.testing.assert_array_equal(got, want)
        # the channel axis anywhere: dim 0 of the transposed array
        qt, st = quant.quantize_int8(torch.from_numpy(a.T.copy()), axis=0)
        np.testing.assert_array_equal(qt.numpy().T, np.asarray(jq))
        np.testing.assert_array_equal(st.numpy(), np.asarray(js))
    assert (quant.quantize_int8(torch.from_numpy(w))[0][:, 5].tolist()
            == np.asarray(jquant.quantize_int8(jnp.asarray(w))[0])[:, 5]
            .tolist())
    assert not quant.dequantize_int8(
        *quant.quantize_int8(torch.zeros(64, 64)), dtype=torch.float32).any()


def _jax_qtree_on_port_names(qtree):
    """JAX's quantized leaves as {port name: (int8 (port layout), scale)},
    a fused q / k / v concatenated in query, key, value order."""
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict) and jquant._INT8 in v:
                flat[p] = v
            elif isinstance(v, dict):
                walk(v, p)
    walk(qtree, "")
    parts = {}
    for path, leaf in flat.items():
        key, slot, is_kernel = _port_name(path)
        q = np.asarray(leaf[jquant._INT8])
        s = np.asarray(leaf[jquant._SCALE])
        assert q.ndim == 2
        if is_kernel:
            q = q.T
        parts.setdefault(key, {})[slot or 0] = (q, s)
    return {key: (np.concatenate([g[i][0] for i in sorted(g)], axis=0),
                  np.concatenate([g[i][1] for i in sorted(g)]))
            for key, g in parts.items()}


def test_quantize_tree_is_bitwise_jax(caption):
    conv, cfg, variables, model = caption
    jtree, jcount = jquant.quantize_tree(
        jax.tree.map(jnp.asarray, variables["params"]))
    want = _jax_qtree_on_port_names(jtree)
    qtree, count = quant.quantize_tree(dict(model.named_parameters()),
                                       model.config)
    assert set(qtree) == set(want)
    assert count == jcount
    for name, t in qtree.items():
        np.testing.assert_array_equal(t.q.numpy(), want[name][0],
                                      err_msg=name)
        np.testing.assert_array_equal(t.scale.numpy(), want[name][1],
                                      err_msg=name)
    assert quant.quantized_bytes(qtree) == jquant.quantized_bytes(jtree)
    assert "fusion.word_embeddings" in qtree
    assert qtree["fusion.word_embeddings"].scale.shape == (64,)
    assert "fusion.layers.0.qkv.weight" in qtree
    assert "fusion.token_type_embeddings" not in qtree
    if conv == "vit":
        vit = {n for n in qtree if n.startswith("conv.backbone.")}
        assert vit == {"conv.backbone.patch_proj.weight"} | {
            f"conv.backbone.blocks.{i}.mlp_fc{j}.weight"
            for i in range(2) for j in (1, 2)}
    if conv == "swin":
        assert "conv.backbone.stages.1.0.qkv.weight" in qtree
        assert not any(".relative_position_bias_table" in n for n in qtree)


def test_dequantized_swaps_and_restores(caption):
    """Within ``dequantized`` every quantized parameter is its bf16
    dequantized value; afterwards the model holds its own parameters
    again, the same objects."""
    _, _, _, model = caption
    qtree, _ = quant.quantize_tree(dict(model.named_parameters()),
                                   model.config)
    before = dict(model.named_parameters())
    deq = quant.dequantize_tree(qtree)
    with quant.dequantized(model, qtree):
        inside = dict(model.named_parameters())
        for name, t in inside.items():
            if name in qtree:
                assert t.dtype == torch.bfloat16
                assert torch.equal(t, deq[name])
            else:
                assert t is before[name]
    after = dict(model.named_parameters())
    assert all(after[n] is before[n] for n in before)


def test_int8w_decode_matches_jax():
    """Beam-2 decode on the int8 weights (dequantized to bf16, computed in
    f32) token for token against JAX's (``tests/test_quant.py``'s model),
    and its scores within 1e-4; the int8w VQA logits within 1e-4."""
    cfg = _jax_config("linear")
    img = _image(2)
    txt = np.ones((2, 5), np.int32)
    jcap = JaxCaption(cfg)
    cvars = jax.jit(jcap.init)(jax.random.PRNGKey(0), jnp.asarray(img),
                               jnp.asarray(txt))
    jspec = JaxSpec.from_config(cfg, num_beams=2)
    cq, _ = jquant.quantize_tree(cvars["params"])

    @jax.jit
    def quant_decode(qp, image):
        return jax_generate(jcap, dict(cvars,
                                       params=jquant.dequantize_tree(qp)),
                            image, jspec)

    want = [np.asarray(a) for a in quant_decode(cq, jnp.asarray(img))]
    model = CaptionModel(_port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, cvars)))
    qtree, _ = quant.quantize_tree(dict(model.named_parameters()),
                                   model.config)
    pspec = pgen.GenerationSpec(**dataclasses.asdict(jspec))
    with quant.dequantized(model, qtree):
        got = pgen.generate(model, torch.from_numpy(img), pspec)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-4, rtol=0)

    jvqa = JaxVQA(cfg)
    vvars = jax.jit(jvqa.init)(jax.random.PRNGKey(1), jnp.asarray(img),
                               jnp.asarray(txt))
    vq, _ = jquant.quantize_tree(vvars["params"])
    _, want_logits = jax.jit(lambda qp, im, t: jvqa.apply(
        dict(vvars, params=jquant.dequantize_tree(qp)), im, t))(
        vq, jnp.asarray(img), jnp.asarray(txt))
    vqa = VQAModel(_port_config(cfg), device="cpu")
    vqa.load_state_dict(params_from_flax(jax.tree.map(np.asarray, vvars)))
    vtree, _ = quant.quantize_tree(dict(vqa.named_parameters()), vqa.config)
    with quant.dequantized(vqa, vtree):
        _, logits = vqa(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    _, full = vqa(torch.from_numpy(img), torch.from_numpy(txt))
    assert not torch.equal(full, logits)     # the int8 weights were served


def test_default_predicate_is_jax():
    """``default_predicate`` is JAX's on JAX-layout shapes, and a fused
    q / k / v is quantized as JAX's three kernels or not at all."""
    for shape in ((64, 64), (63, 64), (64, 3, 64), (128,), (30522, 64),
                  (48, 96)):
        assert quant.default_predicate(shape) == jquant.default_predicate(
            (), jnp.zeros(shape))
    cfg = _port_config(_jax_config("linear"))
    # a fused q / k / v of 3 x 63 rows is JAX's three (64, 63) kernels:
    # left out, as each of them is
    assert quant.quantize_tree({"fusion.layers.0.qkv.weight":
                                torch.zeros(3 * 63, 64)}, cfg) == ({}, 0)
    qtree, n = quant.quantize_tree({"fusion.layers.0.qkv.weight":
                                    torch.zeros(3 * 64, 64)}, cfg)
    assert n == 3 and qtree["fusion.layers.0.qkv.weight"].scale.shape == (
        3 * 64,)
