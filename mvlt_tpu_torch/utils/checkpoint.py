"""Checkpoint / resume of the port (counterpart of
``mvlt_tpu/utils/checkpoint.py:52-137``), in torch's own format.

- :func:`save_checkpoint` / :func:`restore_checkpoint`: the whole
  :class:`~mvlt_tpu_torch.train.state.TrainState`: parameters and
  BatchNorm buffers (``model.state_dict()``), the optimizer's state (AdamW's
  moments and count, the accumulation buffers) and ``step``, in
  ``<path>/step_%08d/state.pt``. A save writes a ``-tmp-`` directory and
  renames it, so an interrupted save leaves a ``-tmp-`` leftover, which
  every listing skips; ``keep`` prunes the oldest steps.
- ``async_save=True`` copies the state to host memory, then writes it on a
  background thread while training goes on; :func:`wait_for_async_saves`
  joins it (and raises what it raised). One save is in flight at a time.
- :func:`save_pretrained` / :func:`load_pretrained`: the model-only export
  (``config.json``, the text of JAX's ``MVLTConfig.to_json`` for the same
  config, and ``model.pt``, a state_dict), the interchange from a pretrain
  run to a finetune.

The JAX package writes Orbax; a JAX export reaches the port through
:mod:`mvlt_tpu_torch.utils.convert` on numpy arrays.

Over a mesh every rank enters a save (as JAX's sharded Orbax write is a
collective): the split tensors and their AdamW moments are gathered over
the model group and world rank 0 writes the file that a one-device run
writes. A restore reads that file on every rank and cuts it for the mesh it
restores into, so a checkpoint moves between mp = 2 and mp = 1 bitwise.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import torch

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.parallel import comm, shard

STATE_FILE = "state.pt"

_pending: Optional[threading.Thread] = None
_pending_error: list = []


def _snapshot(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def wait_for_async_saves() -> None:
    """Block until the save in flight, if any, is on disk; raise its
    error."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def _steps(path: str):
    if not os.path.isdir(path):
        return []
    return sorted(d for d in os.listdir(path)
                  if d.startswith("step_") and "-tmp-" not in d)


def _write(target: str, payload: dict) -> None:
    tmp = f"{target}-tmp-{os.getpid()}-{time.monotonic_ns()}"
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(target):
        shutil.rmtree(target)
    os.replace(tmp, target)


def _prune(path: str, keep: int) -> None:
    for d in _steps(path)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    keep: int = 3, async_save: bool = False) -> str:
    """Save ``state`` under ``path/step_<n>`` and prune to the ``keep``
    newest. With ``async_save`` it returns after the host copy; up to
    ``keep`` + 1 step directories may exist while the write runs."""
    global _pending
    step = int(state.step) if step is None else int(step)
    target = os.path.join(os.path.abspath(path), f"step_{step:08d}")
    payload = _snapshot({
        "step": step, "model": shard.full_state_dict(state.model),
        "optimizer": shard.full_optimizer_state(state.optimizer,
                                                state.model)})
    if comm.global_rank() != 0:
        return target
    os.makedirs(path, exist_ok=True)
    if not async_save:
        _write(target, payload)
        _prune(path, keep)
        return target
    wait_for_async_saves()

    def run():
        try:
            _write(target, payload)
            _prune(path, keep)
        except BaseException as e:     # noqa: BLE001 - raised on the wait
            _pending_error.append(e)

    _pending = threading.Thread(target=run, name="checkpoint-save",
                                daemon=False)
    _pending.start()
    return target


def latest_checkpoint(path: str) -> Optional[str]:
    wait_for_async_saves()          # an in-flight save must be visible
    steps = _steps(path)
    return os.path.join(os.path.abspath(path), steps[-1]) if steps else None


def restore_checkpoint(path: str, state: Any) -> Tuple[Any, bool]:
    """Restore the newest checkpoint under ``path`` (or the ``step_`` dir
    ``path`` itself) into ``state``, in place: the tensors keep their
    devices. Returns ``(state, restored?)``."""
    wait_for_async_saves()
    comm.barrier()              # world rank 0's save is on disk
    target = (os.path.abspath(path)
              if os.path.basename(os.path.normpath(path)).startswith("step_")
              else latest_checkpoint(path))
    if target is None or not os.path.exists(os.path.join(target, STATE_FILE)):
        return state, False
    payload = torch.load(os.path.join(target, STATE_FILE), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(shard.local_state_dict(state.model,
                                                       payload["model"]))
    state.optimizer.load_state_dict(shard.local_optimizer_state(
        payload["optimizer"], state.model))
    state.step = int(payload["step"])
    return state, True


# ---------------------------------------------------------------------------
# model-only export (pretrain -> finetune interchange)
# ---------------------------------------------------------------------------

def save_pretrained(path: str, config: MVLTConfig, model) -> None:
    """``config.json`` and ``model.pt`` (``model``: a module or a
    state_dict). A module on a mesh is gathered (every rank calls) and world
    rank 0 writes."""
    sd = (shard.full_state_dict(model) if hasattr(model, "state_dict")
          else model)
    if comm.global_rank() != 0:
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config.to_json())
    torch.save(_snapshot(dict(sd)), os.path.join(path, "model.pt"))


def load_pretrained(path: str) -> Tuple[MVLTConfig, dict]:
    """(config, state_dict on the CPU) of a :func:`save_pretrained`
    directory."""
    with open(os.path.join(path, "config.json")) as f:
        config = MVLTConfig.from_json(f.read())
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                    weights_only=True)
    return config, sd
