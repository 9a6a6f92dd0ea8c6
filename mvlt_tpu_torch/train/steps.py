"""Train steps of the port (counterpart of ``mvlt_tpu/train/steps.py``). A
step is forward + backward + optimizer update, eager.

Each step draws its dropout masks from ``step.masks``, a
:class:`~mvlt_tpu_torch.ops.layers.DropoutMasks` (by default one on the
model's device, seeded with 0); replace it to record or replay masks.

Over a mesh (``mesh=``, after :func:`shard_train_state`; one process a
device) a step is JAX's ``shard_map`` DP step and its GSPMD TP step
(``steps.py:116-176``) written out:

- ``step(batch)`` takes this data rank's rows of the global batch
  (``P('data')``: a contiguous block); ``step.shard_batch(global)`` cuts
  them and moves them to the device, raising JAX's "not divisible" error,
  and ``step.prefetch`` does so for a loader of global batches (or moves a
  loader's own rows, ``sliced=True``);
- the loss is made global before the backward: every loss sums its NLL and
  its valid count over the data group (JAX's ``axis_name``), so the mean is
  the global batch's whatever each rank's count;
- after the backward the gradients are summed over the data group in one
  fixed order (flat buckets), so the replicas stay bitwise equal; the TP
  collectives run inside the fusion's counterparts and the heads;
- the accuracy metric is averaged over the data group; the BatchNorm
  moments are the global batch's (``models/backbones/resnet.py``);
- the masks are the caller's: the runner draws them per (step, data rank),
  equal across a model group (``tasks/common.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from mvlt_tpu_torch.ops.layers import DropoutMasks

Batch = Dict[str, torch.Tensor]


def seq2seq_coin_flip(generator: torch.Generator) -> bool:
    """The reference's per-batch ``random.random() < 0.5`` between the
    seq2seq and bidirectional masks (model.py:390-394, ``steps.py:31-34``),
    from an explicit generator: reproducible and loggable."""
    return bool(torch.rand((), generator=generator) < 0.5)


def drop_strings(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A host batch without its non-array fields (ids, raw strings), as
    JAX's ``_validate`` drops them (``train/steps.py:91-103``)."""
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray)
            or (np.isscalar(v) and not isinstance(v, str))}


def _masks(model) -> DropoutMasks:
    device = next(model.parameters()).device
    return DropoutMasks(torch.Generator(device=device).manual_seed(0))


def rank_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This data rank's rows of a host batch, string fields dropped: every
    array field's leading axis cut to the rank's block (``P('data')``),
    raising JAX's error where the data-parallel size does not divide it
    (``steps.py:91-103``)."""
    from mvlt_tpu_torch.parallel.partition import batch_rows
    out = drop_strings(batch)
    if mesh is None or mesh.dp == 1:
        return out
    for k, v in out.items():
        if getattr(v, "ndim", 0):
            a, b = batch_rows(mesh, v.shape[0], name=f"batch[{k!r}]")
            out[k] = v[a:b]
    return out


def _prefetch_to(device, mesh=None):
    """``prefetch(iterator, size=2, threads=1, sliced=False)``: a host batch
    iterator (a ``DataLoader`` epoch) through
    :func:`~mvlt_tpu_torch.data.loader.device_prefetch` to ``device``,
    string fields dropped (``steps.py:105-111``); arrays keep their dtype,
    so a uint8 image crosses the bus as uint8. Over a mesh each global batch
    is cut to this data rank's rows first, unless ``sliced`` (the loader
    already yields them)."""
    def prefetch(iterator, size: int = 2, threads: int = 1,
                 sliced: bool = False):
        from mvlt_tpu_torch.data.loader import device_prefetch
        cut = drop_strings if sliced else (lambda b: rank_rows(b, mesh))
        return device_prefetch(iterator, size=size, device=device,
                               transform=cut, threads=threads)
    return prefetch


def _shard_batch_to(device, mesh):
    """``shard_batch(batch)``: this data rank's rows of a global host batch
    on ``device`` (JAX's ``shard_batch``, ``steps.py:102-103``)."""
    def shard_batch(batch):
        return {k: (torch.as_tensor(v).to(device) if getattr(v, "ndim", None)
                    is not None else v)
                for k, v in rank_rows(batch, mesh).items()}
    return shard_batch


def _mesh_of(model, mesh):
    """The step's mesh: None, or the one :func:`shard_train_state` put the
    model on."""
    if mesh is not None and getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model is not on this mesh: "
                         "shard_train_state(state, mesh) first")
    return mesh


def _data_group(mesh):
    return None if mesh is None else mesh.data_group


def _update(model, optimizer, mesh, zero_unreached: bool) -> None:
    """Zero gradients where the loss did not reach (AdamW decays those
    parameters, as optax does), the data group's gradient sum, the
    optimizer update."""
    if zero_unreached:
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    group = _data_group(mesh)
    if group is not None:
        from mvlt_tpu_torch.parallel import comm
        comm.all_reduce_flat_([p.grad for p in model.parameters()
                               if p.grad is not None], group)
    optimizer.step()


def _mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank mean averaged over the data group (JAX's ``pmean``)."""
    group = _data_group(mesh)
    if group is None:
        return x
    from mvlt_tpu_torch.parallel import comm
    return comm.all_reduce_(x.clone(), group) / mesh.dp


def _attach(step, model, optimizer, device, mesh):
    step.model, step.optimizer, step.mesh = model, optimizer, mesh
    step.masks = _masks(model)
    step.prefetch = _prefetch_to(device, mesh)
    step.shard_batch = _shard_batch_to(device, mesh)
    return step


def shard_train_state(state, mesh, logger=None):
    """Place a :class:`~mvlt_tpu_torch.train.state.TrainState` on ``mesh``
    (``steps.py:178-189``): world rank 0's parameters and buffers broadcast,
    each rank keeping its shards (:func:`~mvlt_tpu_torch.parallel.shard.
    apply_mesh_`); the optimizer, which must not have stepped yet, keeps
    its moments with the local shards and learns which tensors are split
    (the clip's global norm). Returns the state."""
    from mvlt_tpu_torch.parallel import shard
    opt = state.optimizer
    inner = getattr(opt, "adamw", opt)
    if any(inner.state.values()):
        raise ValueError("shard_train_state needs an optimizer that has not "
                         "stepped")
    shard.apply_mesh_(state.model, mesh, logger)
    if hasattr(opt, "set_model_parallel"):
        opt.set_model_parallel(shard.split_flags(state.model),
                               mesh.model_group if mesh.mp > 1 else None)
    return state


def make_vqa_step(model, optimizer: torch.optim.Optimizer, *,
                  plain: bool = False, mesh=None
                  ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {"loss", "accuracy"}`` for a :class:`VQAModel`
    (``steps.py:236-248``): CE over the answer logits, then one optimizer
    update; the BatchNorm running statistics move in the forward. ``batch``
    holds ``image`` (B, 3, H, W), ``question`` (B, L) and ``label`` (B,);
    it is moved to the model's device. After a step the parameters' ``.grad``
    hold that step's gradients. ``plain=True`` runs the kernels' plain
    versions.

    ``step.prefetch(iterator, size=2, threads=1)`` wraps a host batch
    iterator (a ``DataLoader`` epoch) with
    :func:`~mvlt_tpu_torch.data.loader.device_prefetch` to the model's
    device, string fields dropped (``steps.py:105-111``)."""
    device = next(model.parameters()).device
    mesh = _mesh_of(model, mesh)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, question, label = (batch[k].to(device)
                                  for k in ("image", "question", "label"))
        optimizer.zero_grad(set_to_none=True)
        loss, logits = model.loss(image, question, label, plain=plain,
                                  masks=step.masks, group=_data_group(mesh))
        loss.backward()
        _update(model, optimizer, mesh, zero_unreached=False)
        acc = (logits.argmax(-1) == label).float().mean()
        return {"loss": loss.detach(), "accuracy": _mean_over_data(acc, mesh)}

    return _attach(step, model, optimizer, device, mesh)


def make_pretrain_step(model, optimizer: torch.optim.Optimizer, *,
                       plain: bool = False, mesh=None):
    """``step(batch, seq2seq) -> {"mlm_loss", "itm_loss", "loss"}`` for a
    :class:`PretrainModel` (``steps.py:251-263``): MLM (+ ITM) CE in the
    mask mode ``seq2seq`` (a plain bool per call, as JAX compiles one
    program per mode), then one optimizer update. ``batch`` holds ``image``
    (B, 3, H, W), ``caption_masked`` (B, L), ``caption_label`` (B, L) and
    ``itm_label`` (B,); it is moved to the model's device. After a step the
    parameters' ``.grad`` hold that step's gradients: zeros for the MLM
    head of the other mode, which the loss does not reach, so that AdamW
    moves its moments and decays its weights as optax does for every
    parameter. ``plain=True`` runs the kernels' plain versions. ``image``
    may be a uint8 (B, H, W, 3) frame, normalized by the model.
    ``step.prefetch`` as :func:`make_vqa_step`'s."""
    device = next(model.parameters()).device
    mesh = _mesh_of(model, mesh)

    def step(batch: Batch, seq2seq: bool) -> Dict[str, torch.Tensor]:
        args = [batch[k].to(device) for k in ("image", "caption_masked",
                                               "caption_label")]
        itm = batch.get("itm_label")
        optimizer.zero_grad(set_to_none=False)
        loss, metrics = model.loss(*args, None if itm is None else
                                   itm.to(device), seq2seq=bool(seq2seq),
                                   plain=plain, masks=step.masks,
                                   group=_data_group(mesh))
        loss.backward()
        _update(model, optimizer, mesh, zero_unreached=True)
        return {k: v.detach() for k, v in metrics.items()}

    return _attach(step, model, optimizer, device, mesh)


def make_caption_step(model, optimizer: torch.optim.Optimizer, *,
                      learning_strategy: str = "unilm", plain: bool = False,
                      mesh=None):
    """``step(batch) -> {"loss"}`` for a :class:`CaptionModel`
    (``steps.py:282-294``): CE over the MLM logits with ignore index -100
    in ``learning_strategy``, then one optimizer update. ``batch`` holds
    ``image`` (B, 3, H, W), ``caption`` (B, L) and ``mlm_labels`` (B, L);
    it is moved to the model's device. The masks are drawn in JAX's order:
    the Swin DropPath first, then each fusion layer's. Parameters the loss
    does not reach (the fusion pooler) get zero gradients, so that AdamW
    decays them as optax does. ``plain=True`` runs the kernels' plain
    versions. ``image`` may be two-view (B, 2, 3, H, W) and uint8 ((B, H, W,
    3) or (B, 2, H, W, 3)), normalized by the model. ``step.prefetch`` as
    :func:`make_vqa_step`'s."""
    device = next(model.parameters()).device
    mesh = _mesh_of(model, mesh)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, caption, labels = (batch[k].to(device)
                                  for k in ("image", "caption", "mlm_labels"))
        optimizer.zero_grad(set_to_none=False)
        loss, _ = model.loss(image, caption, labels, learning_strategy,
                             plain=plain, masks=step.masks,
                             group=_data_group(mesh))
        loss.backward()
        _update(model, optimizer, mesh, zero_unreached=True)
        return {"loss": loss.detach()}

    return _attach(step, model, optimizer, device, mesh)


def make_retrieval_step(model, optimizer: torch.optim.Optimizer, *,
                        plain: bool = False, mesh=None):
    """``step(batch) -> {"loss", "accuracy"}`` for a :class:`RetrievalModel`
    (``steps.py:266-279``): CE over the 2-way match logits, accuracy the
    mean of ``argmax(logits) == label``, then one optimizer update.
    ``batch`` holds ``image`` (B, 3, H, W), ``caption`` (B, L) and
    ``label`` (B,), already ``cat(pos, neg)`` (run_retrieval.py:162-177);
    it is moved to the model's device. The masks are drawn in JAX's order:
    the Swin DropPath first, then each fusion layer's attention dropout.
    After a step the parameters' ``.grad`` hold that step's gradients (zeros
    for any the loss does not reach, so that AdamW decays them as optax
    does). ``plain=True`` runs the kernels' plain versions. ``image`` as
    :func:`make_caption_step`'s; ``step.prefetch`` as
    :func:`make_vqa_step`'s."""
    device = next(model.parameters()).device
    mesh = _mesh_of(model, mesh)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        image, caption, label = (batch[k].to(device)
                                 for k in ("image", "caption", "label"))
        optimizer.zero_grad(set_to_none=False)
        loss, logits = model.loss(image, caption, label, plain=plain,
                                  masks=step.masks, group=_data_group(mesh))
        loss.backward()
        _update(model, optimizer, mesh, zero_unreached=True)
        acc = (logits.argmax(-1) == label).float().mean()
        return {"loss": loss.detach(), "accuracy": _mean_over_data(acc, mesh)}

    return _attach(step, model, optimizer, device, mesh)
