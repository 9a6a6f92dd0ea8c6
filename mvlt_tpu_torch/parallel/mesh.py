"""The (data, model) device mesh of the port on ``torch.distributed``
(counterpart of ``mvlt_tpu/parallel/mesh.py``).

One process drives one device. :func:`initialize_distributed` brings up
the default process group (NCCL on the card, gloo on the CPU; a caller that
wants gloo on the card says so with ``backend=``), and :func:`build_mesh`
lays the world out as JAX's ``build_mesh`` lays its devices out: a
``(dp, mp)`` grid, the ``mp`` ranks of one model group adjacent (rank = d *
mp + m, strides (mp, 1): the layout of ``init_device_mesh(device_type, (dp,
mp), mesh_dim_names=("data", "model"))``), ``data_parallel == -1`` taking
what is left. A one-device mesh without a process group has no groups, and
every collective of the port is skipped on it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from mvlt_tpu_torch.config import MeshConfig


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) grid: ``shape`` (dp, mp), its
    ``data_rank`` and ``model_rank``, and the process groups of its data
    column (the ranks holding the same model shard) and of its model row
    (the ranks holding the same rows of the batch); each group is None when
    there is no process group."""

    shape: tuple
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    device: torch.device = torch.device("cpu")

    @property
    def dp(self) -> int:
        return self.shape[0]

    @property
    def mp(self) -> int:
        return self.shape[1]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _init_method(coordinator: Optional[str]) -> str:
    if coordinator is None:
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"          # JAX's "host:port"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device,
                           backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Bring up the default process group and return this rank's device.

    Arguments left None come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` through
    ``env://``); ``coordinator`` is ``host:port``, ``tcp://...`` or
    ``file://...``. One process is a no-op (the device is returned as it
    is) unless a ``coordinator`` is given, which brings up a group of one
    (a one-rank NCCL check). ``backend`` defaults to NCCL for a ``cuda``
    device and gloo for ``cpu``. On the card each rank takes
    ``cuda:LOCAL_RANK`` and ``torch.cuda.set_device`` is called on it; a
    device with an explicit index (``cuda:0``) is taken by every rank,
    which only gloo allows. More local ranks than cards, or NCCL ranks
    sharing a card, raise: nothing moves to the CPU or to another
    backend."""
    device = torch.device(device)
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1 and coordinator is None:
        return device
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') needs a "
                               "CUDA device and torch.cuda.is_available() is "
                               "False")
        cards = torch.cuda.device_count()
        if device.index is None:
            if local >= cards:
                raise ValueError(f"local rank {local} has no card: "
                                 f"{cards} visible")
            device = torch.device("cuda", local)
        elif backend == "nccl" and world > 1:
            raise ValueError(f"NCCL takes one card a rank; {device} was "
                             f"given to all {world} ranks (use "
                             "backend='gloo')")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=_init_method(coordinator), world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def mesh_shape(config: MeshConfig, n_devices: int) -> tuple:
    """(dp, mp) of ``n_devices`` under ``config``, with JAX's two
    ``ValueError``s (``mesh.py:44-53``)."""
    mp = max(1, config.model_parallel)
    if n_devices % mp != 0:
        raise ValueError(
            f"model_parallel={mp} does not divide device count {n_devices}")
    dp = n_devices // mp
    if config.data_parallel not in (-1, dp):
        raise ValueError(
            f"data_parallel={config.data_parallel} inconsistent with "
            f"{n_devices} devices / model_parallel={mp}")
    return dp, mp


def rank_coords(rank: int, mp: int) -> tuple:
    """(data, model) coordinates of a world rank: model ranks adjacent."""
    return divmod(rank, mp)


def build_mesh(config: MeshConfig = MeshConfig(), device="cpu") -> Mesh:
    """The (data, model) mesh of the world (``mesh.py:35-54``): ``model_
    parallel`` ranks adjacent, the data axis the rest. Raises JAX's two
    ``ValueError``s. Every rank must call it, in the same order as its
    other group constructions (``torch.distributed.new_group``)."""
    dp, mp = mesh_shape(config, _world())
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh((dp, mp), device=device)
    d, m = rank_coords(dist.get_rank(), mp)
    data_group = model_group = None
    # every rank creates every group, in one order
    for j in range(mp):
        g = dist.new_group([i * mp + j for i in range(dp)])
        if j == m:
            data_group = g
    for i in range(dp):
        g = dist.new_group([i * mp + j for j in range(mp)])
        if i == d:
            model_group = g
    return Mesh((dp, mp), d, m, data_group, model_group, device)
