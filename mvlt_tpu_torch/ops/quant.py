"""Weight-only int8 serving of the port (counterpart of
``mvlt_tpu/ops/quant.py:35-125``).

Symmetric per-output-channel max-abs quantization: each selected tensor is
held as an ``int8`` tensor and one ``float32`` scale per output channel, and
dequantized (in f32, then cast to bf16) for the length of one serving call;
activations are never quantized. The rounding points are JAX's:
``scale = amax / 127`` in f32 (1 where amax is 0), ``round(w / scale)``
half to even, clipped to +-127.

Which tensors are quantized follows JAX's parameter tree, not the port's
layout. :func:`default_predicate` takes the 2-D leaves of JAX's tree with
both dims >= 64, and :func:`jax_leaf_shapes` gives, for each port tensor,
the shapes of the JAX leaves it stands for (the names that
``utils/convert.py`` maps):

- a ``Dense`` weight (out, in) is a flax kernel (in, out): its channels are
  the port's dim 0;
- the fusion layers' fused ``qkv`` (3H, H) is JAX's three (H, H) ``query``
  / ``key`` / ``value`` kernels; a max-abs over the input dimension is the
  same on the fused tensor, so its per-row scales are the three scale
  vectors concatenated;
- ViT-B/16's fused ``qkv`` and its ``out`` are flax ``DenseGeneral``
  kernels, (in, heads, dh) and (heads, dh, out), with (heads, dh) q / k / v
  biases: 3-D, so they stay unquantized, as do the ViT's 3-D class token and
  position table;
- an embedding table keeps its layout and JAX's channel axis, the last
  (one scale per hidden channel); LayerNorm and BatchNorm parameters,
  biases, Swin's relative-position tables and every 4-D convolution follow
  the predicate on their own shapes (none of them passes it).

A port tensor is quantized when all its JAX leaves pass the predicate, and
counted as that many tensors, so that the count equals JAX's on the same
model. :func:`dequantized` swaps the dequantized tensors into a model for
the length of a call and restores its own parameters afterwards; the
tensors it does not quantize (the relative-position tables among them) are
never touched, so caches keyed on them stay valid.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Mapping, Tuple

import torch

_FUSED_QKV = re.compile(r"fusion\.layers\.\d+\.qkv\.(weight|bias)")
_VIT_ATTENTION = re.compile(r"conv\.backbone\.blocks\.\d+\.(qkv|out)\."
                            r"(weight|bias)")
# position tables: one JAX leaf each, in the port's shape (the ViT's two,
# the Swin's ``ape`` table)
_TABLES = ("conv.backbone.cls_token", "conv.backbone.pos_embedding",
           "conv.backbone.absolute_pos_embed")


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """``q`` int8 and ``scale`` f32 along dim ``axis`` of ``q``."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int


def quantize_int8(w: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization along dim ``axis`` (JAX's
    channel axis is the last). Returns ``(q, scale)``, ``q`` int8 of
    ``w``'s shape and ``scale`` f32 of ``w.shape[axis]``, such that
    ``|q * scale - w| <= scale / 2`` elementwise."""
    wf = w.float()
    axis = axis % w.dim()
    others = tuple(d for d in range(w.dim()) if d != axis)
    amax = wf.abs().amax(dim=others) if others else wf.abs()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / _along(scale, w.dim(), axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: dequantize in f32, then cast."""
    return (q.float() * _along(scale, q.dim(), axis % q.dim())).to(dtype)


def _along(scale: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    return scale.view([-1 if d == axis else 1 for d in range(ndim)])


def default_predicate(shape) -> bool:
    """JAX's rule on one of its leaves: quantize a 2-D tensor with both
    dims >= 64 (the kernels and the vocabulary; LayerNorm parameters,
    biases and small tables stay as they are). ``shape`` is the leaf's
    shape in JAX's layout (:func:`jax_leaf_shapes`)."""
    return len(shape) == 2 and min(shape) >= 64


def jax_leaf_shapes(name: str, shape, config) -> List[Tuple[int, ...]]:
    """The shapes of the leaves of JAX's tree that port tensor ``name`` of
    ``shape`` stands for (``config``: the model's ``MVLTConfig``)."""
    shape = tuple(shape)
    if _VIT_ATTENTION.fullmatch(name):
        heads = config.vit.num_heads
        hidden = shape[-1] if name.endswith("weight") else shape[0] // (
            3 if ".qkv." in name else 1)
        dh = hidden // heads
        if ".qkv." in name:
            one = ((hidden, heads, dh) if name.endswith("weight")
                   else (heads, dh))
            return [one] * 3
        return [(heads, dh, hidden)] if name.endswith("weight") else [shape]
    if _FUSED_QKV.fullmatch(name):
        part = (shape[0] // 3,) + shape[1:]
        return [part[::-1]] * 3
    if name in _TABLES:
        return [shape]
    if name.endswith(".weight") and len(shape) == 2:
        return [shape[::-1]]                       # Dense (out, in) -> (in, out)
    if len(shape) == 4:
        return [(shape[2], shape[3], shape[1], shape[0])]    # OIHW -> HWIO
    return [shape]


def channel_axis(name: str, shape) -> int:
    """The port dim that holds JAX's last (channel) axis: dim 0 of a Dense
    weight, the last dim of anything else."""
    if name.endswith(".weight") and len(shape) == 2:
        return 0
    return len(shape) - 1


def quantize_tree(params: Mapping[str, torch.Tensor], config
                  ) -> Tuple[Dict[str, QuantizedTensor], int]:
    """Quantize the tensors of ``params`` (a model's ``named_parameters()``
    or a state dict; quantize the f32 masters, as JAX quantizes
    ``runner.state.params``) whose JAX leaves :func:`default_predicate`
    selects, each on its own device. Returns ``({name: QuantizedTensor},
    n)``, ``n`` counted in JAX's leaves."""
    out, count = {}, 0
    for name, w in params.items():
        leaves = jax_leaf_shapes(name, w.shape, config)   # of one shape
        if not default_predicate(leaves[0]):
            continue
        axis = channel_axis(name, w.shape)
        with torch.no_grad():
            q, scale = quantize_int8(w.detach(), axis)
        out[name] = QuantizedTensor(q, scale, axis)
        count += len(leaves)
    return out, count


def dequantize_tree(qtree: Mapping[str, QuantizedTensor]
                    ) -> Dict[str, torch.Tensor]:
    """``{name: bf16 tensor}`` of :func:`quantize_tree`'s output (JAX's
    decode dtype)."""
    with torch.no_grad():
        return {name: dequantize_int8(t.q, t.scale, t.axis)
                for name, t in qtree.items()}


def quantized_bytes(qtree: Mapping[str, QuantizedTensor]) -> Tuple[int, int]:
    """(int8 bytes + f32 scale bytes, the same tensors' bf16 bytes) of the
    quantized tensors: the serving-memory saving (JAX's totals: a fused
    q / k / v holds its three leaves' elements and scales)."""
    qb = ob = 0
    for t in qtree.values():
        n = t.q.numel()
        qb += n + t.scale.numel() * 4
        ob += n * 2
    return qb, ob


@contextlib.contextmanager
def dequantized(model: torch.nn.Module,
                qtree: Mapping[str, QuantizedTensor]):
    """Within the block, ``model``'s quantized parameters are their
    dequantized bf16 tensors (the model casts each to its compute
    dtype at use, as flax promotes them); afterwards its own parameters are
    back. Every method of the model sees them, not only ``forward``."""
    swapped = []
    try:
        for name, t in dequantize_tree(qtree).items():
            path, _, leaf = name.rpartition(".")
            module = model.get_submodule(path)
            if not isinstance(module._parameters.get(leaf), torch.Tensor):
                raise KeyError(f"{name} is not a parameter of the model")
            swapped.append((module, leaf, module._parameters[leaf]))
            module._parameters[leaf] = t
        yield model
    finally:
        for module, leaf, p in reversed(swapped):
            module._parameters[leaf] = p
