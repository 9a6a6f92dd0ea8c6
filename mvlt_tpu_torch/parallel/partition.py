"""Parameter and batch partition rules of the port (counterpart of
``mvlt_tpu/parallel/partition.py``).

JAX's Megatron rules (``partition.py:29-52``) are kept as they are, with
their fallback: a leaf whose split dimension the model axis does not divide
stays replicated (:55-72). At mp = 2 the word embedding's 30,523 rows
(vocab + 1) therefore stay replicated while the MLM decoder's 30,522
columns are split; at mp = 4 both stay replicated.

:func:`param_shardings` gives each port parameter JAX's spec of the flax
leaf it stands for and the dimension of the port tensor that it splits,
from ``_PORT_RULES``: the same rules written on the port's names. The
port's fused q / k / v ``qkv`` (3H, H) stands for three kernels, each
``P(None, 'model')``: its split takes the same heads of each third
(``parts = 3``), not a contiguous third of the rows, so that a rank holds
q, k and v of its own heads.

What the port splits in this slice (:func:`held`): the fusion encoder and
the heads. The backbone's rule-matched tensors (Swin / ViT ``qkv``,
``proj``, ``fc1``, ``fc2``) are held replicated: ``param_shardings`` still
gives JAX's spec for them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from mvlt_tpu_torch.parallel import comm

# (regex over 'path/to/param', spec) - first match wins; a spec is JAX's
# PartitionSpec as a tuple, () replicated
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # fusion encoder attention (models/fusion.py SelfAttention)
    (r"attention/(query|key|value)/kernel$", (None, "model")),
    (r"attention/(query|key|value)/bias$", ("model",)),
    (r"attention/out/kernel$", ("model", None)),
    # fusion FFN
    (r"intermediate/kernel$", (None, "model")),
    (r"intermediate/bias$", ("model",)),
    (r"/output/kernel$", ("model", None)),
    # swin / vit blocks
    (r"attn/qkv/kernel$", (None, "model")),
    (r"attn/qkv/bias$", ("model",)),
    (r"attn/proj/kernel$", ("model", None)),
    (r"mlp/fc1/kernel$", (None, "model")),
    (r"mlp/fc1/bias$", ("model",)),
    (r"mlp/fc2/kernel$", ("model", None)),
    (r"mlp_fc1/kernel$", (None, "model")),
    (r"mlp_fc1/bias$", ("model",)),
    (r"mlp_fc2/kernel$", ("model", None)),
    # vocab-dim sharding: MLM decoder + embedding table
    (r"mlm_head_\w+/decoder/kernel$", (None, "model")),
    (r"mlm_head_\w+/decoder/bias$", ("model",)),
    (r"word_embeddings/embedding$", ("model", None)),
)


def partition_spec_for_path(path: str, ndim: int, shape=None,
                            model_size: int = 1) -> tuple:
    """JAX's spec (a tuple) of the flax leaf ``path``; replicated ``()``
    where the split dimension is not divisible by ``model_size``."""
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            if shape is not None and model_size > 1:
                for dim, axis in zip(shape, spec + (None,) * ndim):
                    if axis == "model" and dim % model_size != 0:
                        return ()
            if len(spec) > ndim:
                return ()
            return spec
    return ()


# ---------------------------------------------------------------------------
# the same rules on the port's parameter names
# ---------------------------------------------------------------------------

# (regex over the port parameter name, JAX's spec of the flax leaf, port
# dimension split, parts) - first full match wins. A port (out, in) weight is
# the flax (in, out) kernel transposed: a column split (None, 'model') cuts
# port dimension 0, a row split ('model', None) dimension 1. The fused q / k
# / v of the fusion encoder and of ViT stands for three flax kernels, each
# split alike (parts = 3); Swin's qkv is one flax kernel (parts = 1). ViT's
# flax attention kernels are (H, heads, d) and (heads, d, H), split on heads:
# the port's fallback tests heads * d, which agrees wherever mp divides the
# heads (ViT-B/16's 12 at mp = 2 and 4).
# tests/test_torch_parallel.py holds every leaf's spec to ``_RULES``.
_COL, _ROW, _VEC = (None, "model"), ("model", None), ("model",)
_PORT_RULES: Tuple[Tuple[str, tuple, int, int], ...] = (
    # fusion encoder
    (r"fusion\.layers\.\d+\.qkv\.weight", _COL, 0, 3),
    (r"fusion\.layers\.\d+\.qkv\.bias", _VEC, 0, 3),
    (r"fusion\.layers\.\d+\.out\.weight", _ROW, 1, 1),
    (r"fusion\.layers\.\d+\.intermediate\.weight", _COL, 0, 1),
    (r"fusion\.layers\.\d+\.intermediate\.bias", _VEC, 0, 1),
    (r"fusion\.layers\.\d+\.output\.weight", _ROW, 1, 1),
    # ViT blocks
    (r"conv\.backbone\.blocks\.\d+\.qkv\.weight", _COL, 0, 3),
    (r"conv\.backbone\.blocks\.\d+\.qkv\.bias", _VEC, 0, 3),
    (r"conv\.backbone\.blocks\.\d+\.out\.weight", _ROW, 1, 1),
    (r"conv\.backbone\.blocks\.\d+\.mlp_fc1\.weight", _COL, 0, 1),
    (r"conv\.backbone\.blocks\.\d+\.mlp_fc1\.bias", _VEC, 0, 1),
    (r"conv\.backbone\.blocks\.\d+\.mlp_fc2\.weight", _ROW, 1, 1),
    # Swin blocks
    (r"conv\.backbone\.stages\.\d+\.\d+\.qkv\.weight", _COL, 0, 1),
    (r"conv\.backbone\.stages\.\d+\.\d+\.qkv\.bias", _VEC, 0, 1),
    (r"conv\.backbone\.stages\.\d+\.\d+\.proj\.weight", _ROW, 1, 1),
    (r"conv\.backbone\.stages\.\d+\.\d+\.mlp\.fc1\.weight", _COL, 0, 1),
    (r"conv\.backbone\.stages\.\d+\.\d+\.mlp\.fc1\.bias", _VEC, 0, 1),
    (r"conv\.backbone\.stages\.\d+\.\d+\.mlp\.fc2\.weight", _ROW, 1, 1),
    # vocabulary: MLM decoders and the word embedding (V, H)
    (r"mlm_head_\w+\.decoder\.weight", _COL, 0, 1),
    (r"mlm_head_\w+\.decoder\.bias", _VEC, 0, 1),
    (r"fusion\.word_embeddings", _ROW, 0, 1),
)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One port parameter under a mesh: ``spec`` JAX's spec of its flax
    leaf (of each of q / k / v), ``dim`` the port dimension split over the
    model group (None: replicated), ``parts`` 3 for a fused q / k / v (each
    third split alike), else 1."""

    spec: tuple
    dim: Optional[int]
    parts: int = 1


def shard_for(name: str, shape, model_size: int) -> Shard:
    """The :class:`Shard` of port parameter ``name`` of full ``shape``;
    replicated where the split dimension (of one part) is not divisible by
    ``model_size``, as ``partition_spec_for_path`` falls back."""
    for pattern, spec, dim, parts in _PORT_RULES:
        if re.fullmatch(pattern, name):
            if model_size > 1 and (shape[dim] // parts) % model_size:
                return Shard((), None, parts)
            return Shard(spec, None if model_size == 1 else dim, parts)
    return Shard((), None)


def param_shardings(model: torch.nn.Module, mesh) -> Dict[str, Shard]:
    """``{name: Shard}`` for every parameter of ``model`` under ``mesh`` (a
    :class:`~mvlt_tpu_torch.parallel.mesh.Mesh`, or the model-axis size)."""
    mp = mesh if isinstance(mesh, int) else mesh.mp
    return {name: shard_for(name, p.shape, mp)
            for name, p in model.named_parameters()}


def held(name: str) -> bool:
    """Whether the port splits ``name`` when its rule says so: the fusion
    encoder and the heads; the backbone is held replicated in this slice."""
    return not name.startswith("conv.")


def local_shard(t: torch.Tensor, shard: Shard, rank: int,
                size: int) -> torch.Tensor:
    """The model rank's slice of a full tensor (a copy)."""
    if shard.dim is None or size == 1:
        return t
    parts = t.chunk(shard.parts, dim=shard.dim)
    return torch.cat([p.chunk(size, dim=shard.dim)[rank] for p in parts],
                     dim=shard.dim).contiguous()


def full_tensor(local: torch.Tensor, shard: Shard, group) -> torch.Tensor:
    """The full tensor from the model group's slices (all-gather)."""
    size = comm.group_size(group)
    if shard.dim is None or size == 1:
        return local
    gathered = comm.all_gather_cat(local, group, dim=shard.dim)
    if shard.parts == 1:
        return gathered
    # rank-major [r0: q k v][r1: q k v] -> part-major [q: r0 r1][k ...]
    chunks = gathered.chunk(size * shard.parts, dim=shard.dim)
    order = [chunks[r * shard.parts + j] for j in range(shard.parts)
             for r in range(size)]
    return torch.cat(order, dim=shard.dim)


# ---------------------------------------------------------------------------
# batch placement: P('data') on the leading axis
# ---------------------------------------------------------------------------

def batch_rows(mesh, n: int, name: str = "batch") -> Tuple[int, int]:
    """[start, stop) of the contiguous block of a global batch's ``n`` rows
    that ``mesh``'s data rank holds, as ``P('data')`` places it; raises
    JAX's error when the data-parallel size does not divide ``n``
    (``steps.py:91-103``)."""
    dp = 1 if mesh is None else mesh.dp
    if n % dp != 0:
        raise ValueError(
            f"{name} leading dim {n} not divisible by data-parallel size "
            f"{dp}; pick batch_size as a multiple")
    r = 0 if mesh is None else mesh.data_rank
    per = n // dp
    return r * per, (r + 1) * per


def split_rows(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of block ``index`` of ``n`` rows cut into ``parts``
    contiguous blocks, the first ``n % parts`` one row longer (an eval
    batch that ``parts`` need not divide)."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return start, start + base + (index < extra)
