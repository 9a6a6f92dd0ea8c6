"""The port's converters of the reference's task checkpoints
(``mvlt_tpu_torch/utils/convert.py``: ``vqa_from_torch``,
``pretrain_from_torch``, ``retrieval_from_torch``, ``caption_from_torch``
and their ``*_state_dict_from_torch`` forms) against the JAX package's
(``mvlt_tpu/utils/convert.py:165-247``).

The reference-layout state dicts are built as ``tests/test_convert_full.py``
builds them (``_reference_like_sd``: HF ``BertEncoder`` / ``BertPooler`` /
``BertOnlyMLMHead`` / ``BertPredictionHeadTransform`` modules under the
reference's names, a tiny torchvision-layout ResNet-50 under
``conv.conv.0.``), with the backbone swapped for a tiny MSFT-layout Swin
(fused ``qkv``, and the ``relative_position_index`` / ``attn_mask``
buffers a real checkpoint carries) or the linear patch (conv + BatchNorm).
For each task and backbone: the trees equal JAX's bitwise, the state dict
loads into the port's task model with ``strict=True``, and the port's
forward agrees with JAX's on the same converted variables within 1e-4.
ViT raises as in JAX, and a missing name raises ``KeyError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models import heads as jheads
from mvlt_tpu.utils import convert as jconvert
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models import heads as pheads
from mvlt_tpu_torch.utils import convert as pconvert
from test_convert_full import FCFG, _reference_like_sd

torch.set_num_threads(2)

IMG = 32
SWIN = jcfg.SwinConfig(img_size=IMG, patch_size=4, embed_dim=8, depths=(2, 2),
                       num_heads=(2, 4), window_size=4, drop_path_rate=0.0)
BACKBONE = {"resnet50": dict(resnet=jcfg.ResNetConfig(layers=(1, 1),
                                                      width=8)),
            "swin": dict(swin=SWIN), "linear": {}}
TASKS = {"vqa": "VQAModel", "pretrain": "PretrainModel",
         "retrieval": "RetrievalModel", "caption": "CaptionModel"}


def _config(conv):
    return jcfg.MVLTConfig(conv=conv, fusion=FCFG, result_num=4,
                           cls_token_id=3, sep_token_id=4, eos_token_id=5,
                           mask_token_id=6, itm_task=True,
                           **BACKBONE[conv])


def _swin_sd(rng, cfg: jcfg.SwinConfig):
    """A tiny MSFT-layout Swin state dict under ``conv.conv.0.``."""
    sd, p = {}, "conv.conv.0."
    w = lambda *s: rng.normal(0.0, 0.2, s).astype(np.float32)
    sd[p + "patch_embed.proj.weight"] = w(cfg.embed_dim, 3, cfg.patch_size,
                                          cfg.patch_size)
    sd[p + "patch_embed.proj.bias"] = w(cfg.embed_dim)
    for n in ("patch_embed.norm", "norm"):
        dim = cfg.embed_dim if n.startswith("patch") else cfg.num_features
        sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + w(dim), w(dim)
    win = cfg.window_size
    for i, depth in enumerate(cfg.depths):
        C, nH = cfg.embed_dim * 2 ** i, cfg.num_heads[i]
        for j in range(depth):
            b = f"{p}layers.{i}.blocks.{j}."
            for n in ("norm1", "norm2"):
                sd[b + n + ".weight"], sd[b + n + ".bias"] = 1 + w(C), w(C)
            for n, (o, k) in {"attn.qkv": (3 * C, C), "attn.proj": (C, C),
                              "mlp.fc1": (4 * C, C),
                              "mlp.fc2": (C, 4 * C)}.items():
                sd[b + n + ".weight"], sd[b + n + ".bias"] = w(o, k), w(o)
            sd[b + "attn.relative_position_bias_table"] = w(
                (2 * win - 1) ** 2, nH)
            sd[b + "attn.relative_position_index"] = np.zeros(
                (win * win, win * win), np.int64)
            if j % 2:
                sd[b + "attn_mask"] = np.zeros((4, win * win, win * win),
                                               np.float32)
        if i < len(cfg.depths) - 1:
            d = f"{p}layers.{i}.downsample."
            sd[d + "norm.weight"], sd[d + "norm.bias"] = 1 + w(4 * C), w(4 * C)
            sd[d + "reduction.weight"] = w(2 * C, 4 * C)
    return sd


def _linear_sd(rng, hidden):
    p = "conv.conv.0."
    w = lambda *s: rng.normal(0.0, 0.2, s).astype(np.float32)
    return {p + "linear_patch.weight": w(hidden, 3, 16, 16),
            p + "linear_patch.bias": w(hidden),
            p + "bn.weight": 1 + w(hidden), p + "bn.bias": w(hidden),
            p + "bn.running_mean": w(hidden),
            p + "bn.running_var": 1 + np.abs(w(hidden)),
            p + "bn.num_batches_tracked": np.array(3, np.int64)}


def _reference_sd(task, conv):
    sd = _reference_like_sd(FCFG, task)
    if conv != "resnet50":
        sd = {k: v for k, v in sd.items() if not k.startswith("conv.")}
        rng = np.random.default_rng(4)
        sd.update(_swin_sd(rng, SWIN) if conv == "swin"
                  else _linear_sd(rng, FCFG.hidden_size))
    return sd


def _kw(conv):
    return dict(num_layers=FCFG.num_hidden_layers, conv=conv,
                depths=SWIN.depths, layers=(1, 1))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 3, IMG, IMG)).astype(np.float32)
    caption = rng.integers(7, FCFG.vocab_size, (2, 5)).astype(np.int32)
    caption[1, 3:] = 0
    return image, caption


def _forwards(task, jmodel, variables, pmodel):
    """(port output, JAX output): the logits of the VQA, retrieval and
    caption forwards; the pretrain loss's three terms."""
    image, caption = _inputs()
    jargs = (jnp.asarray(image), jnp.asarray(caption))
    pargs = (torch.from_numpy(image), torch.from_numpy(caption).long())
    if task == "vqa":
        return pmodel(*pargs)[1], jmodel.apply(variables, *jargs)[1]
    if task in ("retrieval", "caption"):
        return pmodel(*pargs), jmodel.apply(variables, *jargs)
    labels = np.where(caption > 0, caption, -100).astype(np.int32)
    labels[:, ::2] = -100
    itm = np.array([0, 1], np.int32)
    # the port's loss is the training forward: BatchNorms on batch
    # statistics (the dropout rates are 0)
    (_, want), _ = jmodel.apply(variables, *jargs, jnp.asarray(labels),
                                jnp.asarray(itm), deterministic=False,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
    _, got = pmodel.loss(*pargs, torch.from_numpy(labels).long(),
                         torch.from_numpy(itm).long())
    return (torch.stack([got[k] for k in ("mlm_loss", "itm_loss", "loss")]),
            jnp.stack([want[k] for k in ("mlm_loss", "itm_loss", "loss")]))


@pytest.mark.parametrize("conv", list(BACKBONE))
@pytest.mark.parametrize("task", list(TASKS))
def test_task_converter_matches_jax(task, conv):
    sd = _reference_sd(task, conv)
    name = f"{task}_from_torch"
    want = getattr(jconvert, name)(sd, **_kw(conv))
    got = getattr(pconvert, name)(sd, **_kw(conv))
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        a, b = np.asarray(fw[k]), np.asarray(fg[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)

    state = getattr(pconvert, f"{task}_state_dict_from_torch")(sd,
                                                               **_kw(conv))
    cfg = _config(conv)
    model_cls = TASKS[task]
    pmodel = getattr(pheads, model_cls)(pcfg.MVLTConfig.from_json(
        cfg.to_json()), device="cpu")
    pmodel.load_state_dict(state)                              # strict
    if conv == "linear":
        bn = pmodel.conv.backbone.bn
        np.testing.assert_array_equal(
            bn.running_var.numpy(), sd["conv.conv.0.bn.running_var"])
    jmodel = getattr(jheads, model_cls)(cfg)
    got_out, want_out = _forwards(task, jmodel,
                                  jax.tree.map(jnp.asarray, want), pmodel)
    want_out = np.asarray(want_out)
    assert got_out.shape == want_out.shape
    np.testing.assert_allclose(got_out.detach().numpy(), want_out,
                               atol=1e-4 * max(1.0, np.abs(want_out).max()),
                               rtol=0)


def test_vit_layout_and_missing_names_raise():
    sd = _reference_sd("vqa", "resnet50")
    for mod in (jconvert, pconvert):
        with pytest.raises(NotImplementedError,
                           match="conv layout 'vit' not convertible"):
            mod.vqa_from_torch(sd, **dict(_kw("vit")))
    with pytest.raises(NotImplementedError, match="'vit' not convertible"):
        pconvert.caption_state_dict_from_torch(sd, **_kw("vit"))
    short = dict(sd)
    del short["MVLBert.encoder.layer.0.attention.self.key.weight"]
    with pytest.raises(KeyError, match="attention.self.key.weight"):
        pconvert.vqa_state_dict_from_torch(short, **_kw("resnet50"))
    short = {k: v for k, v in _reference_sd("caption", "swin").items()
             if "mlp.fc2.bias" not in k}
    with pytest.raises(KeyError, match="mlp.fc2.bias"):
        pconvert.caption_state_dict_from_torch(short, **_kw("swin"))
