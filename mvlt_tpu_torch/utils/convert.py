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
  concatenated into the port's one fused ``qkv`` Dense (fusion.py:122-126),
  and so are the ViT blocks' ``attention/{query,key,value}``: flax
  ``DenseGeneral`` kernels (hidden, heads, dh) with (heads, dh) biases, and
  ``attention/out`` (heads, dh, hidden), flattened to the port's
  ``blocks.{i}.qkv`` / ``blocks.{i}.out`` Denses;
- LayerNorm and BatchNorm ``scale`` becomes ``weight``; an ``embedding``
  table keeps its layout, and so do the ViT's ``cls_token`` and
  ``pos_embedding``;
- the ResNet's and the linear patch's ``batch_stats`` ``mean`` / ``var``
  become the BatchNorms' ``running_mean`` / ``running_var`` buffers;
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

The backbone converters (copies of ``mvlt_tpu/utils/convert.py:123-164,
254-309, 349-392``) read an official PyTorch state dict (numpy arrays, see
:func:`state_dict_to_numpy`) into the flax-layout tree of JAX's backbone:
``swin_from_torch`` (the MSFT ``.pth``, fused ``qkv``), ``swin_from_hf``
(HF ``SwinModel``, separate q / k / v), ``resnet_from_torchvision`` and
``resnet_from_hf`` (``{"params", "batch_stats"}``), ``vit_from_hf`` (HF
``ViTModel``, ``mvlt_tpu/utils/convert.py:310-346``). Wrapped under
``conv/backbone``, :func:`params_from_flax` maps them onto the port's
names (``utils/bootstrap.py``).

The task converters (copies of ``mvlt_tpu/utils/convert.py:42-114,
165-247``) read a whole checkpoint of the reference's task models
(``MVLBertForVQA`` / ``ForPretraining`` / ``ForRetrieval`` /
``ForImageCaption``: ``conv.conv.0.<backbone>``, ``conv.resnet_fc``,
``MVLBert.*`` with its HF ``BertEncoder``, and the heads) into JAX's
variables tree: :func:`vqa_from_torch`, :func:`pretrain_from_torch`,
:func:`retrieval_from_torch` and :func:`caption_from_torch`, for the
backbones 'swin', 'linear', 'resnet50' and 'resnet101' ('vit' raises
``NotImplementedError``, as in JAX: the reference's ViT layout is not
convertible). Their ``*_state_dict_from_torch`` forms pass that tree
through :func:`params_from_flax`: a state dict that
``load_state_dict(strict=True)`` takes into the port's task model, the
BatchNorm buffers from ``batch_stats``. A name the checkpoint lacks raises
``KeyError``; nothing is left at its initialization.
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
    (r"conv/backbone/(patch_proj|ln)", r"conv.backbone.\1"),
    (r"conv/backbone/block_(\d+)/(ln_1|ln_2|mlp_fc1|mlp_fc2)",
     r"conv.backbone.blocks.\1.\2"),
    (r"conv/backbone/block_(\d+)/attention/(query|key|value)",
     r"conv.backbone.blocks.\1.qkv:\2"),
    (r"conv/backbone/block_(\d+)/attention/out",
     r"conv.backbone.blocks.\1.out"),
    (r"conv/backbone", r"conv.backbone"),
    (r"conv/backbone/(proj|bn)", r"conv.backbone.\1"),
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
         "relative_position_bias_table": ".relative_position_bias_table",
         "cls_token": ".cls_token", "pos_embedding": ".pos_embedding",
         "absolute_pos_embed": ".absolute_pos_embed"}


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
        if value.ndim == 3 and is_kernel:
            # DenseGeneral: q / k / v (in, heads, dh), out (heads, dh, out)
            value = (value.reshape(-1, value.shape[-1])
                     if path.endswith("/out/kernel")
                     else value.reshape(value.shape[0], -1))
        elif value.ndim == 2 and slot is not None and not is_kernel:
            value = value.reshape(-1)                   # (heads, dh) bias
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
    if want.ndim == value.ndim + 1 and value.size == want.size:
        value = value.reshape(want.shape)   # a DenseGeneral kernel or bias
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


# ---------------------------------------------------------------------------
# official backbone checkpoints -> the flax-layout backbone tree
# ---------------------------------------------------------------------------

def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _dense(sd, prefix):
    return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}


def _dense_nobias(sd, prefix):
    return {"kernel": sd[prefix + ".weight"].T}


def _layernorm(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _patchify_kernel(conv_weight: np.ndarray) -> np.ndarray:
    """Conv (E, C, ph, pw) -> patchify-dense kernel (ph*pw*C, E), matching
    PatchEmbed's (ph, pw, c) patch-pixel flattening order."""
    E = conv_weight.shape[0]
    return conv_weight.transpose(2, 3, 1, 0).reshape(-1, E)


def swin_from_torch(sd: Dict[str, np.ndarray], depths, prefix: str = "") -> Dict:
    """Official MSFT ``swin_*_patch4_window7_224.pth`` state dict (fused qkv;
    the file the reference loads at ``modules/model.py:222-226``) -> the
    Swin tree."""
    params = {
        "patch_embed": {
            "proj": {"kernel": _patchify_kernel(sd[prefix + "patch_embed.proj.weight"]),
                     "bias": sd[prefix + "patch_embed.proj.bias"]},
            "norm": _layernorm(sd, prefix + "patch_embed.norm"),
        },
        "norm": _layernorm(sd, prefix + "norm"),
    }
    if prefix + "absolute_pos_embed" in sd:
        params["absolute_pos_embed"] = sd[prefix + "absolute_pos_embed"]
    for i, depth in enumerate(depths):
        for j in range(depth):
            p = f"{prefix}layers.{i}.blocks.{j}."
            params[f"layers_{i}_blocks_{j}"] = {
                "norm1": _layernorm(sd, p + "norm1"),
                "norm2": _layernorm(sd, p + "norm2"),
                "attn": {
                    "qkv": _dense(sd, p + "attn.qkv"),
                    "proj": _dense(sd, p + "attn.proj"),
                    "relative_position_bias_table":
                        sd[p + "attn.relative_position_bias_table"],
                },
                "mlp": {"fc1": _dense(sd, p + "mlp.fc1"),
                        "fc2": _dense(sd, p + "mlp.fc2")},
            }
        dkey = f"{prefix}layers.{i}.downsample.reduction.weight"
        if dkey in sd:
            params[f"layers_{i}_downsample"] = {
                "norm": _layernorm(sd, f"{prefix}layers.{i}.downsample.norm"),
                "reduction": _dense_nobias(sd, f"{prefix}layers.{i}.downsample.reduction"),
            }
    return params


def vit_from_hf(sd: Dict[str, np.ndarray], num_layers: int,
                num_heads: int) -> Dict:
    """HF ``transformers.ViTModel`` state dict -> the ViT tree
    (``mvlt_tpu/utils/convert.py:310-346``), math-identical to the
    torchvision ViT that the reference wraps
    (``visual_feature_extractor.py:65-107``): q / k / v and the output as
    flax ``DenseGeneral`` kernels."""
    hidden = sd["embeddings.cls_token"].shape[-1]
    dh = hidden // num_heads

    def mha(p):
        def qkv(name):
            w, b = (sd[p + f"attention.attention.{name}.weight"],
                    sd[p + f"attention.attention.{name}.bias"])
            return {"kernel": w.T.reshape(hidden, num_heads, dh),
                    "bias": b.reshape(num_heads, dh)}
        wo = sd[p + "attention.output.dense.weight"]
        return {"query": qkv("query"), "key": qkv("key"),
                "value": qkv("value"),
                "out": {"kernel": wo.T.reshape(num_heads, dh, hidden),
                        "bias": sd[p + "attention.output.dense.bias"]}}

    params = {
        "cls_token": sd["embeddings.cls_token"],
        "pos_embedding": sd["embeddings.position_embeddings"],
        "patch_proj": {
            "kernel": _patchify_kernel(
                sd["embeddings.patch_embeddings.projection.weight"]),
            "bias": sd["embeddings.patch_embeddings.projection.bias"]},
        "ln": _layernorm(sd, "layernorm"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        params[f"block_{i}"] = {
            "ln_1": _layernorm(sd, p + "layernorm_before"),
            "ln_2": _layernorm(sd, p + "layernorm_after"),
            "attention": mha(p),
            "mlp_fc1": _dense(sd, p + "intermediate.dense"),
            "mlp_fc2": _dense(sd, p + "output.dense"),
        }
    return params


def swin_from_hf(sd: Dict[str, np.ndarray], depths) -> Dict:
    """HF ``transformers.SwinModel`` state dict (split q/k/v) -> the Swin
    tree, the q / k / v Denses fused into one ``qkv``."""
    params = {
        "patch_embed": {
            "proj": {"kernel": _patchify_kernel(
                         sd["embeddings.patch_embeddings.projection.weight"]),
                     "bias": sd["embeddings.patch_embeddings.projection.bias"]},
            "norm": _layernorm(sd, "embeddings.norm"),
        },
        "norm": _layernorm(sd, "layernorm"),
    }
    for i, depth in enumerate(depths):
        for j in range(depth):
            p = f"encoder.layers.{i}.blocks.{j}."
            q, k, v = (sd[p + f"attention.self.{n}.weight"] for n in
                       ("query", "key", "value"))
            qb, kb, vb = (sd[p + f"attention.self.{n}.bias"] for n in
                          ("query", "key", "value"))
            params[f"layers_{i}_blocks_{j}"] = {
                "norm1": _layernorm(sd, p + "layernorm_before"),
                "norm2": _layernorm(sd, p + "layernorm_after"),
                "attn": {
                    "qkv": {"kernel": np.concatenate([q.T, k.T, v.T], axis=1),
                            "bias": np.concatenate([qb, kb, vb])},
                    "proj": _dense(sd, p + "attention.output.dense"),
                    "relative_position_bias_table":
                        sd[p + "attention.self.relative_position_bias_table"],
                },
                "mlp": {"fc1": _dense(sd, p + "intermediate.dense"),
                        "fc2": _dense(sd, p + "output.dense")},
            }
        dkey = f"encoder.layers.{i}.downsample.reduction.weight"
        if dkey in sd:
            params[f"layers_{i}_downsample"] = {
                "norm": _layernorm(sd, f"encoder.layers.{i}.downsample.norm"),
                "reduction": _dense_nobias(sd, f"encoder.layers.{i}.downsample.reduction"),
            }
    return params


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv (O, I, kh, kw) -> flax (kh, kw, I, O)."""
    return w.transpose(2, 3, 1, 0)


def _convbn(sd, conv_prefix, bn_prefix):
    params = {"conv": {"kernel": _conv_kernel(sd[conv_prefix + ".weight"])},
              "bn": {"scale": sd[bn_prefix + ".weight"],
                     "bias": sd[bn_prefix + ".bias"]}}
    stats = {"bn": {"mean": sd[bn_prefix + ".running_mean"],
                    "var": sd[bn_prefix + ".running_var"]}}
    return params, stats


def resnet_from_torchvision(sd: Dict[str, np.ndarray], layers,
                            prefix: str = "") -> Dict:
    """torchvision ``resnet50/101`` state dict -> the ResNet's
    ``{"params", "batch_stats"}`` (avgpool / fc dropped, reference
    visual_feature_extractor.py:16-23)."""
    params, stats = {}, {}
    params["stem"], stats["stem"] = _convbn(sd, prefix + "conv1", prefix + "bn1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            p = f"{prefix}layer{stage + 1}.{b}."
            name = f"layer{stage + 1}_{b}"
            params[name], stats[name] = {}, {}
            for c in (1, 2, 3):
                params[name][f"conv{c}"], stats[name][f"conv{c}"] = _convbn(
                    sd, p + f"conv{c}", p + f"bn{c}")
            if p + "downsample.0.weight" in sd:
                params[name]["downsample"], stats[name]["downsample"] = _convbn(
                    sd, p + "downsample.0", p + "downsample.1")
    return {"params": params, "batch_stats": stats}


def resnet_from_hf(sd: Dict[str, np.ndarray], layers) -> Dict:
    """HF ``transformers.ResNetModel`` state dict -> the ResNet's
    ``{"params", "batch_stats"}``."""
    params, stats = {}, {}
    params["stem"], stats["stem"] = _convbn(
        sd, "embedder.embedder.convolution", "embedder.embedder.normalization")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            p = f"encoder.stages.{stage}.layers.{b}."
            name = f"layer{stage + 1}_{b}"
            params[name], stats[name] = {}, {}
            for c in (1, 2, 3):
                params[name][f"conv{c}"], stats[name][f"conv{c}"] = _convbn(
                    sd, p + f"layer.{c - 1}.convolution",
                    p + f"layer.{c - 1}.normalization")
            if p + "shortcut.convolution.weight" in sd:
                params[name]["downsample"], stats[name]["downsample"] = _convbn(
                    sd, p + "shortcut.convolution", p + "shortcut.normalization")
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# the reference's task checkpoints (MVLBertForX state dicts)
# ---------------------------------------------------------------------------

def bert_encoder_from_torch(sd: Dict[str, np.ndarray], num_layers: int,
                            prefix: str = "") -> Dict:
    """HF ``BertEncoder`` state dict -> the ``layer_{i}`` subtrees."""
    params = {}
    for i in range(num_layers):
        p = f"{prefix}layer.{i}."
        params[f"layer_{i}"] = {
            "attention": {
                "query": _dense(sd, p + "attention.self.query"),
                "key": _dense(sd, p + "attention.self.key"),
                "value": _dense(sd, p + "attention.self.value"),
                "out": _dense(sd, p + "attention.output.dense"),
                "out_layernorm": _layernorm(sd, p + "attention.output.LayerNorm"),
            },
            "intermediate": _dense(sd, p + "intermediate.dense"),
            "output": _dense(sd, p + "output.dense"),
            "output_layernorm": _layernorm(sd, p + "output.LayerNorm"),
        }
    return params


def fusion_from_torch(sd: Dict[str, np.ndarray], num_layers: int,
                      prefix: str = "MVLBert.") -> Dict:
    """The reference's ``MVLBert`` module (model.py:16-33):
    ``word_embeddings.weight``, ``position_embeddings.weight``,
    ``token_type_embeddings.weight``, ``encoder.layer.{i}.*`` (HF
    ``BertEncoder``) and ``pooler.dense.*`` -> the fusion encoder tree."""
    params = {
        "word_embeddings": {"embedding": sd[prefix + "word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd[prefix + "position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd[prefix + "token_type_embeddings.weight"]},
    }
    params.update(bert_encoder_from_torch(sd, num_layers, prefix + "encoder."))
    if prefix + "pooler.dense.weight" in sd:
        params["pooler"] = {"dense": _dense(sd, prefix + "pooler.dense")}
    return params


def mlm_head_from_torch(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """HF ``BertOnlyMLMHead``: ``{prefix}predictions.transform.dense.*``,
    ``.transform.LayerNorm.*``, ``.decoder.weight`` and ``.decoder.bias``
    (or ``predictions.bias``) -> the MLM head tree."""
    decoder = {"kernel": sd[prefix + "predictions.decoder.weight"].T}
    bias_key = prefix + "predictions.decoder.bias"
    if bias_key not in sd:
        bias_key = prefix + "predictions.bias"
    decoder["bias"] = sd[bias_key]
    return {
        "transform": {
            "transform_dense": _dense(sd, prefix + "predictions.transform.dense"),
            "transform_layernorm": _layernorm(
                sd, prefix + "predictions.transform.LayerNorm"),
        },
        "decoder": decoder,
    }


def head_transform_from_torch(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """HF ``BertPredictionHeadTransform`` -> its tree."""
    return {
        "transform_dense": _dense(sd, prefix + "dense"),
        "transform_layernorm": _layernorm(sd, prefix + "LayerNorm"),
    }


def _conv_layer_from_torch(sd: Dict[str, np.ndarray], conv: str, depths=None,
                           layers=None) -> tuple:
    """The reference's ``Conv_layer`` (``conv.conv.0.<backbone>`` +
    ``conv.resnet_fc``, modules/model.py:186-236) -> (the adapter's params,
    its batch_stats or None)."""
    out: Dict = {}
    stats = None
    conv = conv.lower()
    if conv in ("swin", "swintransformer"):
        out["backbone"] = swin_from_torch(sd, depths, prefix="conv.conv.0.")
    elif conv == "linear":
        # linear_patch_16x16: Conv2d 3->768 k16 s16 + BatchNorm2d + ReLU
        # (visual_feature_extractor.py:47-59)
        p = "conv.conv.0."
        out["backbone"] = {
            "proj": {"kernel": _conv_kernel(sd[p + "linear_patch.weight"]),
                     "bias": sd[p + "linear_patch.bias"]},
            "bn": {"scale": sd[p + "bn.weight"], "bias": sd[p + "bn.bias"]},
        }
        stats = {"backbone": {"bn": {"mean": sd[p + "bn.running_mean"],
                                     "var": sd[p + "bn.running_var"]}}}
    elif conv in ("resnet101", "resnet50"):
        variables = resnet_from_torchvision(sd, layers, prefix="conv.conv.0.")
        out["backbone"] = variables["params"]
        stats = {"backbone": variables["batch_stats"]}
    else:
        # an empty tree would leave the backbone at its random init
        raise NotImplementedError(f"conv layout {conv!r} not convertible")
    if "conv.resnet_fc.weight" in sd:
        out["resnet_fc"] = _dense(sd, "conv.resnet_fc")
    return out, stats


def _task_common(sd: Dict[str, np.ndarray], num_layers: int, conv: str,
                 depths=None, layers=None) -> Dict:
    conv_params, stats = _conv_layer_from_torch(sd, conv, depths, layers)
    params = {"conv": conv_params,
              "fusion": fusion_from_torch(sd, num_layers, prefix="MVLBert.")}
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = {"conv": stats}
    return variables


def vqa_from_torch(sd, num_layers=12, conv="swin", depths=(2, 2, 18, 2),
                   layers=(3, 4, 23, 3)) -> Dict:
    """The reference's ``MVLBertForVQA`` -> JAX's VQAModel variables; its
    head ``final_mlp`` = Sequential(Dropout, Linear) -> ``final_mlp.1``
    (model.py:313-321)."""
    v = _task_common(sd, num_layers, conv, depths, layers)
    v["params"]["final_mlp"] = _dense(sd, "final_mlp.1")
    return v


def pretrain_from_torch(sd, num_layers=12, conv="swin", depths=(2, 2, 18, 2),
                        layers=(3, 4, 23, 3)) -> Dict:
    """The reference's ``MVLBertForPretraining`` (model.py:352-363)."""
    v = _task_common(sd, num_layers, conv, depths, layers)
    v["params"]["mlm_head_seq2seq"] = mlm_head_from_torch(
        sd, "MLM_head_seq2seq.")
    v["params"]["mlm_head_bidir"] = mlm_head_from_torch(sd, "MLM_head_bidir.")
    v["params"]["itm_mlp"] = _dense(sd, "ITM_mlp")
    return v


def retrieval_from_torch(sd, num_layers=12, conv="swin",
                         depths=(2, 2, 18, 2), layers=(3, 4, 23, 3)) -> Dict:
    """The reference's ``MVLBertForRetrieval``: final_mlp = Sequential(
    transform, Linear) (model.py:434-440)."""
    v = _task_common(sd, num_layers, conv, depths, layers)
    v["params"]["final_transform"] = head_transform_from_torch(
        sd, "final_mlp.0.")
    v["params"]["final_linear"] = _dense(sd, "final_mlp.1")
    return v


def caption_from_torch(sd, num_layers=12, conv="swin", depths=(2, 2, 18, 2),
                       layers=(3, 4, 23, 3)) -> Dict:
    """The reference's ``MVLBertForImageCaption`` (model.py:479-489)."""
    v = _task_common(sd, num_layers, conv, depths, layers)
    v["params"]["mlm_head_seq2seq"] = mlm_head_from_torch(
        sd, "MLM_head_seq2seq.")
    return v


def _state_dict_form(converter):
    def convert(sd, *args, **kw) -> Dict[str, torch.Tensor]:
        return params_from_flax(converter(sd, *args, **kw))
    convert.__name__ = converter.__name__.replace("_from_torch",
                                                  "_state_dict_from_torch")
    convert.__doc__ = (f"``{converter.__name__}`` (same arguments) mapped "
                       "by :func:`params_from_flax`: a port state dict of "
                       "float32 tensors for ``load_state_dict(strict=True)``.")
    return convert


vqa_state_dict_from_torch = _state_dict_form(vqa_from_torch)
pretrain_state_dict_from_torch = _state_dict_form(pretrain_from_torch)
retrieval_state_dict_from_torch = _state_dict_form(retrieval_from_torch)
caption_state_dict_from_torch = _state_dict_form(caption_from_torch)
