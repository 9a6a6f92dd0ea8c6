"""Bridge between the JAX package's flax parameter trees and the port's
``state_dict``, both ways.

``params_from_flax`` (also named ``vqa_params_from_flax``,
``pretrain_params_from_flax``, ``retrieval_params_from_flax`` and
``caption_params_from_flax``) maps every leaf of a flax ``VQAModel``,
``PretrainModel``, ``RetrievalModel`` or ``CaptionModel`` tree
(``mvlt_tpu/models/heads.py:65,97,159,210``: ``conv``, ``fusion`` with its
pooler, and the heads) exactly once:

- a flax Dense ``kernel`` (in, out) becomes a port ``weight`` (out, in);
  a Conv ``kernel`` (H, W, in, out) becomes an OIHW ``weight``;
- the fusion layers' separate ``query`` / ``key`` / ``value`` Denses are
  concatenated into the port's one fused ``qkv`` Dense (fusion.py:122-126);
- LayerNorm and BatchNorm ``scale`` becomes ``weight``; an ``embedding``
  table keeps its layout;
- the ResNet's ``batch_stats`` ``mean`` / ``var`` become the BatchNorms'
  ``running_mean`` / ``running_var`` buffers;
- the heads keep their flax names: ``mlm_head_{seq2seq,bidir}/transform/
  {transform_dense,transform_layernorm}`` and ``.../decoder`` (the caption
  tree has ``mlm_head_seq2seq`` alone), ``itm_mlp``, and the retrieval
  head's ``final_transform/{transform_dense,transform_layernorm}`` and
  ``final_linear``.

A leaf that no rule maps, a leaf mapped twice, or a fused q/k/v missing a
part raises ``KeyError``. Load the result with
``model.load_state_dict(sd)`` (strict), which raises on a port parameter
the tree did not provide and casts each tensor to its parameter's dtype.

``params_to_flax(state_dict, template)`` is the inverse: it fills a flax
tree of the template's structure (``params``, or variables with
``batch_stats``) from a port ``state_dict``, splitting each fused ``qkv``
into ``query`` / ``key`` / ``value`` and transposing the kernels back; a
template leaf with no port tensor, a port tensor that no leaf takes, or a
shape that differs raises ``KeyError``. flax -> port -> flax is bitwise
equal on float32 trees.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_QKV = ("query", "key", "value")

# flax path (joined with '/') -> port module path; first match wins
_RULES = [
    (r"conv/backbone/patch_embed/(proj|norm)", r"conv.backbone.patch_embed.\1"),
    (r"conv/backbone/layers_(\d+)_blocks_(\d+)/attn/(qkv|proj)",
     r"conv.backbone.stages.\1.\2.\3"),
    (r"conv/backbone/layers_(\d+)_blocks_(\d+)/attn",
     r"conv.backbone.stages.\1.\2"),
    (r"conv/backbone/layers_(\d+)_blocks_(\d+)/(norm1|norm2)",
     r"conv.backbone.stages.\1.\2.\3"),
    (r"conv/backbone/layers_(\d+)_blocks_(\d+)/mlp/(fc1|fc2)",
     r"conv.backbone.stages.\1.\2.mlp.\3"),
    (r"conv/backbone/layers_(\d+)_downsample/(norm|reduction)",
     r"conv.backbone.downsamples.\1.\2"),
    (r"conv/backbone/norm", r"conv.backbone.norm"),
    (r"conv/backbone/stem/(conv|bn)", r"conv.backbone.stem.\1"),
    (r"conv/backbone/(layer\d+_\d+)/(conv1|conv2|conv3|downsample)/(conv|bn)",
     r"conv.backbone.blocks.\1.\2.\3"),
    (r"conv/resnet_fc", r"conv.resnet_fc"),
    (r"fusion/(word|position|token_type)_embeddings",
     r"fusion.\1_embeddings"),
    (r"fusion/layer_(\d+)/attention/(query|key|value)",
     r"fusion.layers.\1.qkv:\2"),
    (r"fusion/layer_(\d+)/attention/(out|out_layernorm)",
     r"fusion.layers.\1.\2"),
    (r"fusion/layer_(\d+)/(intermediate|output|output_layernorm)",
     r"fusion.layers.\1.\2"),
    (r"fusion/pooler/dense", r"fusion.pooler"),
    (r"final_mlp", r"final_mlp"),
    (r"(mlm_head_(?:seq2seq|bidir))/transform/"
     r"(transform_dense|transform_layernorm)", r"\1.transform.\2"),
    (r"(mlm_head_(?:seq2seq|bidir))/decoder", r"\1.decoder"),
    (r"itm_mlp", r"itm_mlp"),
    (r"final_transform/(transform_dense|transform_layernorm)",
     r"final_transform.\1"),
    (r"final_linear", r"final_linear"),
]
# flax leaf name -> suffix of the port parameter
_LEAF = {"kernel": ".weight", "bias": ".bias", "scale": ".weight",
         "embedding": "", "mean": ".running_mean", "var": ".running_var",
         "relative_position_bias_table": ".relative_position_bias_table"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _port_name(path: str):
    """(port key, q/k/v slot or None, is_dense_kernel) for one flax leaf."""
    module, leaf = path.rsplit("/", 1)
    for pattern, repl in _RULES:
        if leaf in _LEAF and re.fullmatch(pattern, module):
            target, _, part = re.sub(pattern, repl, module).partition(":")
            slot = _QKV.index(part) if part else None
            return target + _LEAF[leaf], slot, leaf == "kernel"
    raise KeyError(f"no port parameter for flax leaf {path!r}")


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``VQAModel`` / ``PretrainModel`` / ``RetrievalModel`` /
    ``CaptionModel`` variables
    (or their ``params``) -> port state_dict of float32 tensors. A
    ``batch_stats`` collection beside ``params`` maps onto the BatchNorm
    buffers."""
    flat = _flatten(variables.get("params", variables))
    if "params" in variables:
        for path, value in _flatten(variables.get("batch_stats", {})).items():
            if path in flat:
                raise KeyError(f"batch_stats leaf {path!r} shadows a parameter")
            flat[path] = value
    sd: Dict[str, torch.Tensor] = {}
    parts: Dict[str, list] = {}
    for path, value in flat.items():
        key, slot, is_kernel = _port_name(path)
        value = np.array(value, np.float32)             # own, writable copy
        if is_kernel:
            # Dense (in, out) -> (out, in); Conv HWIO -> OIHW
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
        if slot is not None:
            group = parts.setdefault(key, [None] * len(_QKV))
            if group[slot] is not None:
                raise KeyError(f"flax leaf {path!r} mapped twice onto {key!r}")
            group[slot] = value
            continue
        if key in sd:
            raise KeyError(f"flax leaf {path!r} mapped twice onto {key!r}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    for key, group in parts.items():
        missing = [_QKV[i] for i, g in enumerate(group) if g is None]
        if missing:
            raise KeyError(f"fused {key!r} is missing its {missing} part(s)")
        sd[key] = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(group, axis=0)))
    return sd


vqa_params_from_flax = pretrain_params_from_flax = params_from_flax
retrieval_params_from_flax = caption_params_from_flax = params_from_flax


def _to_flax_leaf(path: str, template, sd: Mapping, used: set) -> np.ndarray:
    """The flax leaf at ``path`` (shaped and typed as ``template``) from the
    port tensor its rule names."""
    key, slot, is_kernel = _port_name(path)
    if key not in sd:
        raise KeyError(f"no port tensor {key!r} for flax leaf {path!r}")
    used.add(key)
    value = sd[key].detach().cpu().numpy()
    if slot is not None:
        value = np.split(value, len(_QKV), axis=0)[slot]
    if is_kernel:
        # (out, in) -> Dense (in, out); OIHW -> Conv HWIO
        value = value.T if value.ndim == 2 else value.transpose(2, 3, 1, 0)
    want = np.asarray(template)
    if value.shape != want.shape:
        raise KeyError(f"port tensor {key!r} gives {path!r} the shape "
                       f"{value.shape}, the template has {want.shape}")
    return np.ascontiguousarray(value, dtype=want.dtype)


def params_to_flax(state_dict: Mapping[str, torch.Tensor], template):
    """Port ``state_dict`` -> a flax tree of ``template``'s structure: its
    ``params`` tree, or variables ``{"params", "batch_stats"}`` (the
    BatchNorms' running statistics). Leaves are numpy arrays in the
    template leaves' dtypes."""
    used: set = set()

    def fill(tree: Mapping, prefix: str = ""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            out[k] = (fill(v, path) if isinstance(v, Mapping)
                      else _to_flax_leaf(path, v, state_dict, used))
        return out

    if "params" in template:
        out = {name: fill(template[name]) for name in template
               if name in ("params", "batch_stats")}
    else:
        out = fill(template)
    unused = sorted(set(state_dict) - used)
    if unused:
        raise KeyError(f"port tensors that no flax leaf takes: {unused[:5]}")
    return out
