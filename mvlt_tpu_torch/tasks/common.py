"""Shared task plumbing of the port (counterpart of
``mvlt_tpu/tasks/common.py:23-177``): the mesh, the model and its train
state, the optimizer, checkpoints, the dropout masks of training and
metric logging.

- The mesh: :func:`~mvlt_tpu_torch.parallel.mesh.build_mesh` of
  ``TrainConfig.mesh`` over the world of processes (one a device; bring
  it up first with :func:`~mvlt_tpu_torch.parallel.mesh.
  initialize_distributed`); one process is the (1, 1) mesh. The logger and
  the metric log write on world rank 0 only (``tasks/common.py:51-55``).

- :meth:`TaskRunner.init_state` builds the task model seeded from
  ``TrainConfig.seed`` (``flagship.init_seeded_``) with f32 master weights,
  computing in bf16 when ``TrainConfig.bf16_compute`` (as on the card) and
  in f32 otherwise (as the tests compare with JAX); merges pretrained
  state_dicts in order by name and shape (HF ``from_pretrained``
  semantics, JAX's ``_merge_pretrained``) and builds the optimizer with
  ``grad_clip_norm`` / ``grad_accum_steps``.
- The masks: :func:`train_rng` (JAX's ``train_rng``) is a
  :class:`~mvlt_tpu_torch.ops.layers.DropoutMasks` on a ``torch.Generator``
  seeded with ``TrainConfig.seed + offset``; :meth:`TaskRunner.
  masks_for_step` reseeds it from ``(seed + offset, step)`` at every step,
  as JAX folds ``state.step`` into its key (``train/steps.py:71``): the
  masks of a step depend on the seed and the step only, so a restored run
  draws what the run it resumes would have drawn. Over a mesh with dp > 1
  the data rank is folded in as well (JAX's ``fold_in(axis_index('data'))``,
  ``steps.py:129``): the masks are equal across a model group.
  ``rng_impl`` selects nothing here.
- :meth:`TaskRunner.log_step` counts steps on the host and reads the
  metrics off the device only every ``log_every`` steps: no
  synchronisation in the other steps.

The device defaults to ``cuda``, and a runner asked for it without a CUDA
device raises. ``plain=True`` runs the kernels' plain versions (for the
chip smoke test and the tests; not a driver option).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from mvlt_tpu_torch.config import MVLTConfig, TrainConfig
from mvlt_tpu_torch.flagship import _need_cuda, init_seeded_
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.parallel import comm
from mvlt_tpu_torch.parallel.mesh import build_mesh
from mvlt_tpu_torch.train.state import TrainState, make_optimizer
from mvlt_tpu_torch.train.steps import shard_train_state
from mvlt_tpu_torch.utils import checkpoint as ckpt_lib
from mvlt_tpu_torch.utils.logging import MetricLogger, setup_logger


_M64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The generator seed of training step ``step`` under ``seed``: (seed,
    step) packed into 64 bits and mixed by splitmix64's finalizer, so that
    every bit depends on both. A CPU generator's Mersenne Twister keeps only
    the low 32 bits of its seed, where the packed pair alone holds the step
    and nothing of ``seed``; CUDA's Philox keeps all 64."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) & _M64
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def mask_seed(seed: int, step: int, data_rank: int = 0, dp: int = 1) -> int:
    """The generator seed of step ``step``: :func:`step_seed`, with the
    data rank folded in when the data axis has more than one rank."""
    s = step_seed(seed, step)
    if dp > 1:
        s = step_seed(((s >> 32) ^ s) & 0xFFFFFFFF, data_rank)
    return s


def train_rng(tc: TrainConfig, device, offset: int = 0, step: int = 0,
              data_rank: int = 0, dp: int = 1) -> DropoutMasks:
    """The masks of training step ``step``: a generator on ``device``
    seeded with ``tc.seed + offset`` and folded with ``step`` (and the data
    rank, :func:`mask_seed`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mask_seed(tc.seed + offset, step, data_rank, dp))
    return DropoutMasks(gen)


def flax_leaves(name: str) -> int:
    """How many leaves of JAX's variables tree a port tensor stands for:
    a fused ``qkv`` of the fusion encoder or of a ViT block is the three
    ``query`` / ``key`` / ``value`` Denses (``utils/convert.py``; Swin's
    ``qkv`` is one Dense in JAX too); every other tensor is one."""
    return 3 if ".qkv." in name and name.startswith(
        ("fusion.layers.", "conv.backbone.blocks.")) else 1


def _merge_pretrained(model: torch.nn.Module, pretrained, logger):
    """Copy the tensors of ``pretrained`` (a state_dict) whose name and
    shape match into ``model``; the others stay initialized, and unexpected
    ones are dropped. Logs "loaded n/m pretrained tensors" counted in JAX's
    leaves (:func:`flax_leaves`), so that the counts equal JAX's on the
    same tree. Returns (n, m)."""
    own = model.state_dict()
    used = total = 0
    with torch.no_grad():
        for name, t in own.items():
            n = flax_leaves(name)
            total += n
            src = pretrained.get(name)
            if src is not None and tuple(src.shape) == tuple(t.shape):
                t.copy_(torch.as_tensor(src).to(t.dtype))
                used += n
    logger.info("loaded %d/%d pretrained tensors", used, total)
    return used, total


def gather_batches(runner, per_batch: list) -> list:
    """Per-batch results of this data rank (a list, one entry of rows per
    batch) gathered over the data group: entry b is the ranks' entries b
    concatenated in rank order, the rows of global batch b in order."""
    m = runner.mesh
    if m.dp == 1:
        return per_batch
    ranks = comm.all_gather_objects(per_batch, m.data_group)
    return [sum((r[b] for r in ranks), []) for b in range(len(per_batch))]


class TaskRunner:
    """Owns the mesh, the model and its train state, the optimizer,
    checkpoints and logging. ``model_cls(config, dtype=, device=,
    compute_dtype=)`` builds the task model (``VQAModel``, ...); ``device``
    is this process's device (``initialize_distributed`` returns it)."""

    def __init__(self, model_cls, config: MVLTConfig,
                 train_config: TrainConfig = TrainConfig(),
                 workdir: Optional[str] = None, name: str = "mvlt",
                 device="cuda", plain: bool = False):
        self.device = _need_cuda(device, "TaskRunner")
        self.mesh = build_mesh(train_config.mesh, device=self.device)
        self.model_cls = model_cls
        self.config = config
        self.train_config = train_config
        self.workdir = workdir
        self.plain = plain
        rank = comm.global_rank()
        self.logger = setup_logger(name, workdir, distributed_rank=rank)
        self.metrics = MetricLogger(workdir if rank == 0 else None)
        self.state: Optional[TrainState] = None
        self._window_samples = 0
        self._masks: Optional[DropoutMasks] = None

    @property
    def rows(self):
        """(data rank, dp): the loaders' ``rows`` argument."""
        return self.mesh.data_rank, self.mesh.dp

    @property
    def model(self):
        return self.state.model

    @property
    def optimizer(self):
        return self.state.optimizer

    def init_state(self, pretrained_variables=None,
                   seed: Optional[int] = None) -> TrainState:
        """A seeded model on the runner's device, the pretrained
        state_dicts (one, or a list merged in order) copied in, and its
        optimizer, placed on the mesh (:func:`shard_train_state`: world
        rank 0's tensors, each rank keeping its shards)."""
        tc = self.train_config
        compute = torch.bfloat16 if tc.bf16_compute else torch.float32
        model = self.model_cls(self.config, dtype=torch.float32,
                               device=self.device, compute_dtype=compute)
        init_seeded_(model, tc.seed if seed is None else seed)
        if pretrained_variables is not None:
            trees = (pretrained_variables
                     if isinstance(pretrained_variables, (list, tuple))
                     else [pretrained_variables])
            for tree in trees:
                _merge_pretrained(model, tree, self.logger)
        opt = make_optimizer(model, self.config,
                             grad_accum_steps=tc.grad_accum_steps)
        self.state = shard_train_state(
            TrainState(model=model, optimizer=opt, step=0), self.mesh,
            self.logger)
        return self.state

    def masks_for_step(self, offset: int = 0) -> DropoutMasks:
        """The dropout / DropPath masks of the next step: the runner's
        generator reseeded from ``(seed + offset, state.step)`` and, over
        a data axis, the data rank."""
        m = self.mesh
        if self._masks is None:
            self._masks = train_rng(self.train_config, self.device, offset,
                                    self.state.step, m.data_rank, m.dp)
        else:
            self._masks.generator.manual_seed(mask_seed(
                self.train_config.seed + offset, self.state.step,
                m.data_rank, m.dp))
        return self._masks

    def maybe_restore(self) -> bool:
        if not self.workdir:
            return False
        self.state, ok = ckpt_lib.restore_checkpoint(self.workdir, self.state)
        if ok:
            self.logger.info("restored checkpoint at step %d",
                             self.state.step)
        return ok

    def save(self, keep: int = 3) -> None:
        if self.workdir:
            ckpt_lib.save_checkpoint(
                self.workdir, self.state, keep=keep,
                async_save=self.train_config.async_checkpoint)

    def finish(self) -> None:
        """Block until an async checkpoint save in flight is on disk."""
        ckpt_lib.wait_for_async_saves()

    def log_step(self, metrics: Dict[str, Any], samples: int) -> None:
        """Count a step (``state.step`` is a host int: no read of the
        device); every ``log_every`` steps, read the metrics and log them
        with the window's samples/s."""
        step = self.state.step
        self._window_samples += samples
        every = max(1, self.train_config.log_every)
        if step % every != 0:
            return
        out = self.metrics.step(step, metrics, self._window_samples)
        self._window_samples = 0
        parts = " ".join(f"{k}={v:.4f}" for k, v in out.items()
                         if k != "step")
        self.logger.info("step %d: %s", step, parts)
