"""The flax <-> port parameter bridge: every leaf of a flax ``VQAModel`` tree
maps exactly once onto the port's ``state_dict``; a missing or an extra
leaf raises; and flax -> port -> flax (``params_to_flax``) is bitwise equal
on the VQA (Swin and ResNet with ``batch_stats``), pretrain, caption and
retrieval trees."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.config import MVLTConfig, ResNetConfig, SwinConfig
from mvlt_tpu.models import heads as jax_heads
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu_torch import config as port_config
from mvlt_tpu_torch.models import heads as port_heads
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.utils.convert import (params_from_flax, params_to_flax,
                                          vqa_params_from_flax)

torch.set_num_threads(2)


def _config(hidden):
    cfg = MVLTConfig.for_vqa(result_num=6)
    return dataclasses.replace(
        cfg, conv="swin",
        swin=SwinConfig(img_size=16, patch_size=4, embed_dim=16,
                        depths=(2, 1), num_heads=(2, 4), window_size=2,
                        drop_path_rate=0.0),
        fusion=dataclasses.replace(cfg.fusion, hidden_size=hidden,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   intermediate_size=64, vocab_size=200))


def _flax_params(cfg):
    shapes = jax.eval_shape(lambda: JaxVQA(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)),
        jnp.ones((1, 5), jnp.int32)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("hidden", [32, 48])
def test_every_leaf_maps_exactly_once(hidden):
    """hidden 32 equals the backbone width (no resnet_fc), 48 does not."""
    cfg = _config(hidden)
    variables = _flax_params(cfg)
    sd = vqa_params_from_flax(variables)
    model = VQAModel(cfg)
    model.load_state_dict(sd)                            # strict
    assert set(sd) == set(model.state_dict())
    leaves = dict(_leaves(variables["params"]))
    assert sum(v.size for v in leaves.values()) == \
        sum(t.numel() for t in sd.values())
    assert ("conv.resnet_fc.weight" in sd) == (hidden != 32)
    # layouts: Dense kernels transpose, q/k/v concatenate in that order
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["final_mlp.weight"].numpy(), p["final_mlp"]["kernel"].T)
    att = p["fusion"]["layer_1"]["attention"]
    np.testing.assert_array_equal(
        sd["fusion.layers.1.qkv.weight"].numpy(),
        np.concatenate([att[n]["kernel"].T for n in ("query", "key", "value")]))
    np.testing.assert_array_equal(
        sd["fusion.layers.1.qkv.bias"].numpy(),
        np.concatenate([att[n]["bias"] for n in ("query", "key", "value")]))
    np.testing.assert_array_equal(
        sd["conv.backbone.stages.0.1.relative_position_bias_table"].numpy(),
        p["conv"]["backbone"]["layers_0_blocks_1"]["attn"]
        ["relative_position_bias_table"])
    assert sd["fusion.word_embeddings"].shape[0] == cfg.fusion.vocab_size + 1


def test_extra_leaf_raises():
    variables = _flax_params(_config(32))
    bad = copy.deepcopy(variables)
    bad["params"]["fusion"]["layer_0"]["attention"]["rotary"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no port parameter"):
        vqa_params_from_flax(bad)


def test_missing_qkv_part_raises():
    variables = _flax_params(_config(32))
    bad = copy.deepcopy(variables)
    del bad["params"]["fusion"]["layer_1"]["attention"]["key"]["kernel"]
    with pytest.raises(KeyError, match="missing"):
        vqa_params_from_flax(bad)


def test_missing_leaf_fails_strict_load():
    cfg = _config(32)
    bad = copy.deepcopy(_flax_params(cfg))
    del bad["params"]["conv"]["backbone"]["layers_1_blocks_0"]["norm2"]
    with pytest.raises(RuntimeError, match="Missing key"):
        VQAModel(cfg).load_state_dict(vqa_params_from_flax(bad))


def _task_config(task):
    make = {"vqa": MVLTConfig.for_vqa, "vqa_resnet": MVLTConfig.for_vqa,
            "pretrain": MVLTConfig.for_pretrain,
            "caption": MVLTConfig.for_caption,
            "retrieval": MVLTConfig.for_retrieval}[task]
    cfg = dataclasses.replace(_config(48), result_num=6)
    cfg = dataclasses.replace(make(), conv=cfg.conv, swin=cfg.swin,
                              fusion=cfg.fusion, result_num=6,
                              itm_task=True)
    if task == "vqa_resnet":
        cfg = dataclasses.replace(cfg, conv="resnet50",
                                  resnet=ResNetConfig(layers=(1, 1), width=8))
    return cfg


@pytest.mark.parametrize("task", ["vqa", "vqa_resnet", "pretrain",
                                  "caption", "retrieval"])
def test_params_to_flax_round_trip_is_bitwise(task):
    """flax -> port (``params_from_flax``) -> flax (``params_to_flax`` on
    the same tree as template) gives every leaf back bitwise, q / k / v
    split out of the fused qkv and kernels transposed back; the port
    model's own ``state_dict`` maps to the same tree; a port tensor that no
    leaf takes, or a template leaf with no port tensor, raises."""
    cfg = _task_config(task)
    name = {"vqa": "VQAModel", "vqa_resnet": "VQAModel",
            "pretrain": "PretrainModel", "caption": "CaptionModel",
            "retrieval": "RetrievalModel"}[task]
    image, text = jnp.zeros((1, 3, 16, 16)), jnp.ones((1, 5), jnp.int32)
    args = ((image, text, text, jnp.zeros((1,), jnp.int32))
            if task == "pretrain" else (image, text))
    shapes = jax.eval_shape(lambda: getattr(jax_heads, name)(cfg).init(
        jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert ("batch_stats" in variables) == (task == "vqa_resnet")
    sd = params_from_flax(variables)
    back = params_to_flax(sd, variables)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(variables),
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    d = dataclasses.asdict(cfg)
    pcfg = port_config.MVLTConfig(
        fusion=port_config.FusionConfig(**d.pop("fusion")),
        swin=port_config.SwinConfig(**d.pop("swin")),
        resnet=port_config.ResNetConfig(**d.pop("resnet")),
        vit=port_config.ViTConfig(**d.pop("vit")), **d)
    model = getattr(port_heads, name)(pcfg, device="cpu")
    model.load_state_dict(sd)
    again = params_to_flax(model.state_dict(), variables)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(back)))
    with pytest.raises(KeyError, match="no flax leaf takes"):
        params_to_flax({**sd, "extra.weight": torch.zeros(2)}, variables)
    short = dict(sd)
    del short["fusion.pooler.weight"]
    with pytest.raises(KeyError, match="no port tensor"):
        params_to_flax(short, variables)
