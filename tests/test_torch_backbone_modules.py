"""The port's other backbones as modules against the JAX package, HF and
the JAX package's routing: ViT-B/16 (``models/backbones/vit.py``) forward
and gradients against JAX's ``ViT`` and HF's ``ViTModel`` (through
``vit_from_hf``), the HF layout through ``--backbone_ckpt``'s bootstrap, the
linear patch (``models/backbones/linear_patch.py``) in eval and training
with its BatchNorm's running buffers; Swin-B's serving route (stage 4 at C
= 1024 on row 1, walked on ``meta``, and its math against JAX's plain
route); the refusals (a fusion sequence beyond K2 / K4's N <= 288 on a CUDA
device, ViT training with dropout); and one driver run, ``train_vqa`` on
the linear patch against JAX's. The task models on both backbones are in
``test_torch_backbones_other.py``.

Inputs are numpy arrays from a seed, at a tiny size (ViT: hidden 32, 2
layers, 4 heads, image 32, patch 8, MLP 64), every parameter perturbed so
that its mapping shows. float32 throughout: outputs within 1e-4, gradients
within 1e-4 x max|grad| per tensor, the running buffers within 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.backbones.linear_patch import LinearPatch as JaxLinear
from mvlt_tpu.models.backbones.vit import ViT as JaxViT
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu.utils import convert as jconvert
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models import heads
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.backbones.adapter import VisualAdapter
from mvlt_tpu_torch.models.backbones.linear_patch import LinearPatch
from mvlt_tpu_torch.models.backbones.vit import ViT
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.blocks import PLAIN_OPS
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils import convert
from mvlt_tpu_torch.utils.bootstrap import convert_backbone

torch.set_num_threads(2)

VIT = jcfg.ViTConfig(image_size=32, patch_size=8, num_layers=2, num_heads=4,
                     hidden_dim=32, mlp_dim=64)
IMG = 32


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


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the backbones alone
# ---------------------------------------------------------------------------

def _vit_pair(seed=0):
    """(JAX ViT, perturbed flax variables, port ViT holding them, NHWC
    image)."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jm = JaxViT(VIT)
    variables = _perturb(jm.init(jax.random.PRNGKey(seed),
                                 jnp.asarray(image)), seed + 1)
    sd = convert.params_from_flax({"conv": {"backbone": variables["params"]}})
    pm = ViT(pcfg.ViTConfig(**dataclasses.asdict(VIT)), dtype=torch.float32,
             device="cpu")
    pm.load_state_dict({k[len("conv.backbone."):]: v for k, v in sd.items()})
    return jm, variables, pm, image


def test_vit_forward_matches_jax():
    jm, variables, pm, image = _vit_pair()
    want = jm.apply(variables, jnp.asarray(image))
    with torch.no_grad():
        got = pm(torch.from_numpy(image), PLAIN_OPS)
    assert got.shape == want.shape == (2, 16, 32)
    _close(got, want)


def test_vit_grads_match_jax():
    """The port's autograd (``F.linear``, ``F.layer_norm``, SDPA) against
    ``jax.grad`` of the same weighted sum of the output, per parameter and
    for the image."""
    jm, variables, pm, image = _vit_pair(3)
    cot = np.random.default_rng(9).normal(size=(2, 16, 32)).astype(np.float32)

    def f(params, x):
        return jnp.sum(jm.apply({"params": params}, x) * cot)

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"],
                                         jnp.asarray(image))
    x = torch.from_numpy(image).requires_grad_(True)
    (pm(x, PLAIN_OPS) * torch.from_numpy(cot)).sum().backward()
    want = {k[len("conv.backbone."):]: v for k, v in
            convert.params_from_flax({"conv": {"backbone": gp}}).items()}
    for name, p in pm.named_parameters():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-12), (name, err)
    gx = np.asarray(gx)
    assert float(np.abs(x.grad.numpy() - gx).max()) <= \
        1e-4 * float(np.abs(gx).max())


def _hf_vit():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-6)             # torchvision's ViT eps
    torch.manual_seed(0)
    return transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()


def test_vit_matches_hf_vitmodel():
    """HF ``ViTModel`` built from a config (no weights) -> ``vit_from_hf``
    -> ``params_from_flax`` -> the port's ViT, against HF's tokens without
    the class token (the port side of ``tests/test_backbones.py:54``)."""
    hf = _hf_vit()
    image = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(image)).last_hidden_state[:, 1:].numpy()
    tree = convert.vit_from_hf(convert.state_dict_to_numpy(hf.state_dict()),
                               VIT.num_layers, VIT.num_heads)
    jtree = jconvert.vit_from_hf(convert.state_dict_to_numpy(hf.state_dict()),
                                 VIT.num_layers, VIT.num_heads)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    sd = convert.params_from_flax({"conv": {"backbone": tree}})
    pm = ViT(pcfg.ViTConfig(**dataclasses.asdict(VIT)), dtype=torch.float32,
             device="cpu")
    pm.load_state_dict({k[len("conv.backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = pm(torch.from_numpy(image).permute(0, 2, 3, 1), PLAIN_OPS)
    assert got.shape == want.shape == (2, 16, 32)
    _close(got, want)


def test_bootstrap_reads_a_vit_prefixed_hf_dict():
    """``convert_backbone`` of an HF ``ViTModel`` dict under ``vit.`` gives
    the ``conv.backbone.*`` tensors of the port's ViT, bitwise the
    converter's, which a ViT model takes by name and shape."""
    hf = _hf_vit()
    sd = {"vit." + k: v for k, v in
          convert.state_dict_to_numpy(hf.state_dict()).items()}
    cfg = dataclasses.replace(
        pcfg.MVLTConfig.for_vqa(result_num=4), conv="vit",
        vit=pcfg.ViTConfig(**dataclasses.asdict(VIT)),
        fusion=pcfg.FusionConfig(hidden_size=32, num_hidden_layers=1,
                                 num_attention_heads=4, intermediate_size=64,
                                 vocab_size=300))
    got = convert_backbone(sd, "vit", cfg)
    want = convert.params_from_flax({"conv": {"backbone": convert.vit_from_hf(
        convert.state_dict_to_numpy(hf.state_dict()), 2, 4)}})
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    own = VQAModel(cfg).state_dict()
    backbone = {k for k in own if k.startswith("conv.backbone.")}
    assert set(got) == backbone
    assert all(own[k].shape == got[k].shape for k in got)


def _linear_pair(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = JaxLinear(features=16, patch=16)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(image))
    variables = {"params": _perturb(v["params"], seed + 1),
                 "batch_stats": _stats(v["batch_stats"], seed + 2)}
    sd = convert.params_from_flax({
        "params": {"conv": {"backbone": variables["params"]}},
        "batch_stats": {"conv": {"backbone": variables["batch_stats"]}}})
    pm = LinearPatch(16, 16, dtype=torch.float32, device="cpu")
    pm.load_state_dict({k[len("conv.backbone."):]: v for k, v in sd.items()})
    return jm, variables, pm, image


def test_linear_patch_eval_and_train_match_jax():
    """Eval on the running statistics and train on the batch's; after one
    train forward the running buffers equal JAX's mutated ``batch_stats``
    (momentum 0.9, biased variance)."""
    jm, variables, pm, image = _linear_pair()
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    want_eval = jm.apply(variables, jnp.asarray(image))
    want_train, mutated = jm.apply(variables, jnp.asarray(image),
                                   deterministic=False,
                                   mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = pm(x)
        got_train = pm(x, train=True)
    assert got_eval.shape == (4, 4, 16)
    _close(got_eval, want_eval)
    _close(got_train, want_train)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(pm.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pm.bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Swin-B's routing, and the refusals
# ---------------------------------------------------------------------------

class _KeepAll(DropoutMasks):
    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def _count_counterparts(monkeypatch):
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
    return counts


def test_swin_base_stage4_serves_on_row_1_and_trains_on_halves(monkeypatch):
    """Swin-B @224 walked on the meta device. Serving: stages 1-3 (C = 128,
    256, 512) on the whole block, stage 4 (C = 1024, whose MLP half's 8 C^2
    bf16 weights exceed 12 MiB) on JAX's plain route: LN1 ->
    ``window_block_attention`` (+x) -> LN2 -> Mlp, no ``fused_mlp_preln``
    (``mvlt_tpu/models/backbones/swin.py:307-311, 338-366``). Training:
    stage 4 on ``swin_half_block`` (``train_half_ok`` has no 8 C^2 gate).
    Swin-S's stage 4 (C = 768) keeps its serving halves."""
    counts = _count_counterparts(monkeypatch)
    assert pswin.uses_half_blocks(1024) and not pswin.half_weights_fit(1024)
    assert pswin.uses_half_blocks(768) and pswin.half_weights_fit(768)
    assert not pswin.uses_half_blocks(512)
    model = VQAModel(flagship.flagship_swin_base_vqa_config(),
                     dtype=torch.bfloat16, device="meta")
    assert model.conv.resnet_fc is not None              # 1024 -> 768
    image = torch.empty(8, 3, 224, 224, device="meta")
    question = torch.ones(8, 23, dtype=torch.long, device="meta")
    _, logits = model(image, question, plain=True)
    assert logits.shape == (8, 224)
    assert counts == {"swin_full_block": 11, "swin_full_block_shift": 11,
                      "window_block_attention": 2, "fused_attn_ln": 12,
                      "fused_mlp_ln": 12}
    counts.clear()
    cfg = dataclasses.replace(flagship.flagship_swin_base_vqa_config(),
                              fusion=dataclasses.replace(
                                  flagship.flagship_vqa_config().fusion,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0))
    model = VQAModel(cfg, dtype=torch.float32, device="meta",
                     compute_dtype=torch.bfloat16)
    label = torch.zeros(8, dtype=torch.long, device="meta")
    model.loss(image, question, label, plain=True, masks=_KeepAll())
    assert counts == {"swin_full_block_train": 11,
                      "swin_full_block_train_shift": 11,
                      "swin_half_block": 2, "attention_core": 2,
                      "fused_attn_ln": 12, "fused_mlp_ln": 12}
    counts.clear()
    model = VQAModel(flagship.flagship_vqa_config(), dtype=torch.bfloat16,
                     device="meta")
    model(image, question, plain=True)
    assert counts["window_block_attention"] == counts["fused_mlp_preln"] == 2


def test_swin_base_wide_route_matches_jax_plain_route(monkeypatch):
    """The C = 1024 serving route (LN1 -> ``window_block_attention`` (+x)
    -> LN2 -> Mlp) computes JAX's plain route: a tiny Swin whose last stage
    is sent there (its map one window, as Swin-B's stage 4) against JAX's
    XLA forward."""
    from mvlt_tpu.models.backbones.swin import SwinTransformer as JaxSwin
    swin = jcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16,
                           depths=(2, 2), num_heads=(2, 4), window_size=4,
                           drop_path_rate=0.0)
    image = np.random.default_rng(4).normal(size=(2, 3, 32, 32)).astype(
        np.float32)
    jm = JaxSwin(swin)
    params = _perturb(jm.init(jax.random.PRNGKey(5), jnp.asarray(image)), 6)
    want = jm.apply(params, jnp.asarray(image))
    monkeypatch.setattr(pswin, "uses_half_blocks", lambda dim: dim >= 32)
    monkeypatch.setattr(pswin, "half_weights_fit", lambda dim: False)
    counts = _count_counterparts(monkeypatch)
    sd = convert.params_from_flax({"conv": {"backbone": params["params"]}})
    model = pswin.SwinTransformer(pcfg.SwinConfig(**dataclasses.asdict(swin)),
                                  dtype=torch.float32, device="cpu")
    model.load_state_dict({k[len("conv.backbone."):]: v
                           for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(image), PLAIN_OPS)
    assert counts == {"swin_full_block": 1, "swin_full_block_shift": 1,
                      "window_block_attention": 2}
    _close(got, want)


def test_fusion_length_guard_refuses_cuda_paths_beyond_288(monkeypatch,
                                                           tmp_path):
    """On a CUDA device the fusion length guard takes the lengths of K2 /
    K4's long form: the caption path on ViT or the linear patch (S = 298 at
    RGC's 100 text tokens, 348 at 150) and two views (S = 474), as it takes
    the register form's lengths (221, 278). It refuses only past the long
    form's N <= 46,340, before anything is built or launched,
    in the `build_*` entry points and the task drivers; on the CPU it only
    measures S."""
    cuda = torch.device("cuda")
    top = kernels.ATTENTION_LONG_MAX_N
    for conv in ("vit", "linear"):
        cap = dataclasses.replace(pcfg.MVLTConfig.for_caption(max_length=150),
                                  conv=conv)
        assert heads.check_fusion_fits(cap, 150, 1, cuda) == 348
        assert heads.check_fusion_fits(cap, 80, 2, cuda) == 474
        assert heads.check_fusion_fits(cap, 100, 1, cuda) == 298
        assert heads.check_fusion_fits(cap, 150, 1, "cpu") == 348
        assert heads.check_fusion_fits(cap, 80, 1, cuda) == 278
        assert heads.check_fusion_fits(cap, 23, 1, cuda) == 221
        with pytest.raises(NotImplementedError,
                           match=f"S = {top + 1}, beyond K2 / K4's N <= "
                                 f"{top}"):
            heads.check_fusion_fits(cap, top - 197, 1, cuda)
        assert heads.check_fusion_fits(cap, top - 197, 1, "cpu") == top + 1
    assert heads.check_fusion_fits(flagship.flagship_caption_config(), 150,
                                   1, cuda) == 201
    assert heads.check_fusion_fits(flagship.flagship_caption_config(), 80,
                                   2, cuda) == 180

    # the entry points call it before they build a model
    monkeypatch.setattr(flagship, "_need_cuda",
                        lambda device, what: torch.device(device))
    built = []
    for cls in (heads.CaptionModel, heads.RetrievalModel):
        monkeypatch.setattr(cls, "__init__", lambda *a, **k: built.append(1))
    vit_cap = flagship.flagship_vit_caption_config()
    vit_ret = flagship.flagship_vit_retrieval_config()
    S1, S2 = 2 + 196 + top, 2 + 392 + top
    for build, kw, S in (
            (flagship.build_caption_generate, dict(config=vit_cap,
                                                   max_length=top), S1),
            (flagship.build_caption_train_step, dict(config=vit_cap,
                                                     text_len=top), S1),
            (flagship.build_retrieval_grid, dict(config=vit_ret, views=2,
                                                 text_len=top), S2),
            (flagship.build_retrieval_train_step, dict(
                config=vit_ret, views=2, text_len=top), S2)):
        with pytest.raises(NotImplementedError, match=f"S = {S}"):
            build(device="cuda", **kw)
    from mvlt_tpu_torch import run_report_generation, run_retrieval
    with pytest.raises(NotImplementedError, match=f"S = {S2}"):
        run_report_generation.main([
            "--dataset", "iu_xray", "--conv", "linear", "--device", "cuda",
            "--max_length", str(top), "--data_root", str(tmp_path),
            "--model_name", str(tmp_path / "c")])
    with pytest.raises(NotImplementedError, match=f"S = {S2}"):
        run_retrieval.main([
            "--iu_xray_root", str(tmp_path), "--conv", "vit", "--do_test",
            "--max_length", str(top), "--device", "cuda",
            "--model_name", str(tmp_path / "r")])
    assert not built


def test_vit_training_with_dropout_raises():
    cfg = dataclasses.replace(
        pcfg.MVLTConfig.for_vqa(result_num=4), conv="vit",
        vit=pcfg.ViTConfig(**dict(dataclasses.asdict(VIT), dropout=0.1)),
        fusion=pcfg.FusionConfig(hidden_size=32, num_hidden_layers=1,
                                 num_attention_heads=4, intermediate_size=64,
                                 vocab_size=300))
    adapter = flagship.init_seeded_(VisualAdapter(
        cfg, dtype=torch.float32, device="cpu"))
    image = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        assert adapter(image, PLAIN_OPS).shape == (2, 16, 32)   # serving
    with pytest.raises(NotImplementedError, match="Other backbones"):
        adapter(image, PLAIN_OPS, train=True)
    with pytest.raises(ValueError, match="position table"):
        adapter(torch.randn(2, 3, 48, 48), PLAIN_OPS)


# ---------------------------------------------------------------------------
# a driver run
# ---------------------------------------------------------------------------

def test_train_vqa_on_the_linear_patch_matches_jax(tmp_path):
    """``train_vqa`` on JAX's ``tiny_config`` with ``conv='linear'`` (16 x 16
    patches of the 32-px synthetic frames: 4 tokens, BN on batch statistics
    in training) from one parameter tree, both in float32, JAX on its
    8-device CPU mesh: per-step losses within 1e-4, equal valid accuracies
    and best epoch; then ``python -m mvlt_tpu_torch.run_vqa --conv linear``
    writes its results."""
    from mvlt_tpu.data.datasets import MedVQADataset as JaxVQADataset
    from mvlt_tpu.tasks.common import TaskRunner as JaxRunner
    from mvlt_tpu.tasks.vqa import train_vqa as jax_train
    from mvlt_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
    from mvlt_tpu.train import (create_train_state, make_optimizer,
                                shard_train_state)
    from mvlt_tpu_torch import run_vqa
    from mvlt_tpu_torch.data.datasets import MedVQADataset
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.vqa import train_vqa
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer

    jtok, ptok = JaxTokenizer(), WordPieceTokenizer()
    cfg = jcfg.tiny_config(jcfg.MVLTConfig.for_vqa(result_num=4, lr=3e-3))
    cfg = dataclasses.replace(cfg.with_tokenizer(jtok), conv="linear",
                              fusion=dataclasses.replace(
                                  cfg.fusion, vocab_size=len(jtok),
                                  num_hidden_layers=1,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0))
    images = np.random.default_rng(0).normal(
        size=(8, 3, 32, 32)).astype(np.float32)
    rng = np.random.default_rng(1)
    words = ("lung", "heart", "liver", "brain")
    answers = rng.integers(0, 4, size=40)
    entries = [{"img_id": int(rng.integers(0, 8)),
                "question": f"is the {words[a]} normal ?", "label": int(a),
                "answer_type": "OPEN" if i % 2 else "CLOSED"}
               for i, a in enumerate(answers)]

    def splits(cls, tok):
        out = []
        for part in (entries[:32], entries[32:]):
            ds = cls.from_arrays(images, part, {str(i): i for i in range(4)})
            ds.tokenize(tok)
            out.append(ds)
        return out

    tc = dict(batch_size=8, epochs=2, seed=0, log_every=1, num_workers=0)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jrun = JaxRunner(JaxVQA(cfg), cfg, jcfg.TrainConfig(
        **tc, mesh=jcfg.MeshConfig()), workdir=jdir, name="jax-linear")
    variables = jax.jit(JaxVQA(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32), jnp.float32),
        jnp.ones((1, 23), jnp.int32))
    start = convert.params_from_flax(jax.tree.map(np.asarray, variables))
    state = create_train_state(jrun.model, variables, make_optimizer(cfg))
    jrun.state, jrun.shardings = shard_train_state(state, jrun.mesh)
    prun = TaskRunner(VQAModel, _port_config(cfg), pcfg.TrainConfig(
        **tc, bf16_compute=False), workdir=pdir, name="port-linear",
        device="cpu")
    prun.init_state(pretrained_variables=start)
    jtrain, jvalid = splits(JaxVQADataset, jtok)
    ptrain, pvalid = splits(MedVQADataset, ptok)
    jbest = jax_train(jrun, jtrain, jvalid, jvalid)
    pbest = train_vqa(prun, ptrain, pvalid, pvalid)

    def losses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]
    jl, pl = losses(jdir), losses(pdir)
    assert len(jl) == len(pl) == 2 * 4
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    assert pbest == jbest, (pbest, jbest)

    out = tmp_path / "cli"
    results = run_vqa.main(["--synthetic", "--tiny", "--conv", "linear",
                            "--device", "cpu", "--epochs", "1",
                            "--batch_size", "8", "--num_workers", "0",
                            "--model_name", str(out)])
    assert set(results[0]) == {"valid_acc", "epoch", "test_final", "test"}
    assert (out / "results.json").exists()


def test_drivers_run_on_vit_and_linear(tmp_path):
    """``run_pretrain --conv vit --tiny`` (the full-width ViT on the 32-px
    synthetic frames: its position table sized for them) trains an epoch
    and exports a ViT config; ``run_retrieval --conv linear --tiny``
    trains and ranks."""
    from mvlt_tpu_torch import run_pretrain, run_retrieval
    runner = run_pretrain.main([
        "--synthetic", "--tiny", "--conv", "vit", "--device", "cpu",
        "--epochs", "1", "--num_workers", "0",
        "--model_name", str(tmp_path / "pt"),
        "--export_dir", str(tmp_path / "export")])
    assert isinstance(runner.model.conv.backbone, ViT)
    assert runner.state.step == 2                  # 64 samples at b32
    cfg = json.loads((tmp_path / "export" / "config.json").read_text())
    assert cfg["conv"] == "vit" and cfg["vit"]["image_size"] == 32
    assert cfg["vit"]["hidden_dim"] == 768
    _, result = run_retrieval.main([
        "--synthetic", "--tiny", "--conv", "linear", "--device", "cpu",
        "--do_train", "--do_test", "--epochs", "1", "--batch_size", "8",
        "--num_workers", "0", "--model_name", str(tmp_path / "ret")])
    assert set(result) == {"i2t_retrieval", "t2i_retrieval"}
