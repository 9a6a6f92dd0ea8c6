"""Placing a model of the port on a mesh: what ``shard_train_state`` and
GSPMD's propagation do for JAX (``steps.py:178-209``).

:func:`apply_mesh_` broadcasts world rank 0's parameters and buffers (one
seeded init, not one per rank), keeps each model rank's slice of the
tensors that the rules split and the port holds split
(:func:`~mvlt_tpu_torch.parallel.partition.held`: the fusion encoder and
the heads), and tells the modules: the fusion layers run their TP form on
their heads, a split MLM decoder its vocab-parallel loss, a split word
embedding its masked lookup, and the BatchNorms their global-batch moments
over the data group. :func:`full_state_dict` and :func:`load_full_state_dict_`
move between the local shards and the tensors a one-device model holds (the
checkpoint's form).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List

import torch

from mvlt_tpu_torch.parallel import comm, partition
from mvlt_tpu_torch.parallel.partition import Shard

_log = logging.getLogger("mvlt_tpu_torch.parallel")


@dataclasses.dataclass(frozen=True)
class TP:
    """A model group as a module holds it: the group, this rank's place in
    it and its size."""

    group: object
    rank: int
    size: int


def split_shardings(model: torch.nn.Module) -> Dict[str, Shard]:
    """The parameters ``model`` holds split, by name (empty off a mesh)."""
    return getattr(model, "split_shardings", {})


def split_flags(model: torch.nn.Module) -> List[bool]:
    """One bool per parameter in ``model.parameters()`` order: split over
    the model group."""
    split = split_shardings(model)
    return [name in split for name, _ in model.named_parameters()]


def apply_mesh_(model: torch.nn.Module, mesh, logger=None) -> torch.nn.Module:
    """Put ``model`` (built whole on this rank's device) on ``mesh``, in
    place: world rank 0's tensors broadcast, the held split tensors cut to
    this rank's slice, the modules told of their groups. A one-device mesh
    only records itself. Every rank calls it."""
    from mvlt_tpu_torch.models.backbones.resnet import BatchNorm
    from mvlt_tpu_torch.models.fusion import EncoderLayer, FusionEncoder
    from mvlt_tpu_torch.models.heads import MLMHead
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already on a mesh")
    comm.broadcast_tensors_(list(model.parameters()) + list(model.buffers()))
    split: Dict[str, Shard] = {}
    unheld = 0
    if mesh.mp > 1:
        for name, shard in partition.param_shardings(model, mesh).items():
            if shard.dim is None:
                continue
            if not partition.held(name):
                unheld += 1
                continue
            split[name] = shard
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, shard in split.items():
                p = params[name]
                p.data = partition.local_shard(p.data, shard,
                                               mesh.model_rank, mesh.mp)
        tp = TP(mesh.model_group, mesh.model_rank, mesh.mp)
        for mname, m in model.named_modules():
            if isinstance(m, EncoderLayer) and f"{mname}.qkv.weight" in split:
                if m.num_heads % mesh.mp:
                    raise ValueError(f"{m.num_heads} heads do not split over "
                                     f"model_parallel={mesh.mp}")
                m.tp = tp
            elif isinstance(m, MLMHead) and f"{mname}.decoder.weight" in split:
                m.vocab_tp = tp
            elif (isinstance(m, FusionEncoder)
                  and f"{mname}.word_embeddings" in split):
                m.vocab_tp = tp
        if unheld:
            (logger or _log).info(
                "model_parallel=%d: %d backbone tensors that JAX's rules "
                "split are held replicated (the backbone's TP is not in "
                "the port)", mesh.mp, unheld)
    if mesh.dp > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = mesh.data_group
    model.mesh = mesh
    model.split_shardings = split
    return model


@torch.no_grad()
def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor gathered over the
    model group: what a one-device model holds. Every rank calls it."""
    split, mesh = split_shardings(model), getattr(model, "mesh", None)
    sd = model.state_dict()
    if not split:
        return sd
    return {k: (partition.full_tensor(v, split[k], mesh.model_group)
                if k in split else v) for k, v in sd.items()}


@torch.no_grad()
def local_state_dict(model: torch.nn.Module,
                     full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A one-device state_dict cut to this rank's slices."""
    split, mesh = split_shardings(model), getattr(model, "mesh", None)
    if not split:
        return full
    return {k: (partition.local_shard(v, split[k], mesh.model_rank, mesh.mp)
                if k in split else v) for k, v in full.items()}


def _map_optimizer_tensors(state: dict, model: torch.nn.Module, fn) -> dict:
    """A copy of an optimizer state_dict (``torch.optim`` / the port's
    AdamW / ``ClipAccumAdamW``) with ``fn(tensor, shard)`` applied to every
    tensor shaped like a split parameter's moments."""
    split = split_shardings(model)
    shards = [split.get(name) for name, _ in model.named_parameters()]

    def one(st):
        out = dict(st)
        out["state"] = {i: {k: (fn(v, shards[i]) if torch.is_tensor(v)
                                and v.dim() > 0 and shards[i] is not None
                                else v) for k, v in s.items()}
                        for i, s in st["state"].items()}
        return out

    if "adamw" in state:                       # ClipAccumAdamW
        out = dict(state)
        out["adamw"] = one(state["adamw"])
        if state.get("acc") is not None:
            out["acc"] = [fn(a, s) if s is not None else a
                          for a, s in zip(state["acc"], shards)]
        return out
    return one(state)


def full_optimizer_state(optimizer, model: torch.nn.Module) -> dict:
    """The optimizer's state_dict with split moments gathered."""
    mesh = getattr(model, "mesh", None)
    state = optimizer.state_dict()
    if not split_shardings(model):
        return state
    return _map_optimizer_tensors(
        state, model,
        lambda t, s: partition.full_tensor(t, s, mesh.model_group))


def local_optimizer_state(state: dict, model: torch.nn.Module) -> dict:
    """A one-device optimizer state_dict cut to this rank's slices."""
    mesh = getattr(model, "mesh", None)
    if not split_shardings(model):
        return state
    return _map_optimizer_tensors(
        state, model,
        lambda t, s: partition.local_shard(t, s, mesh.model_rank, mesh.mp))
