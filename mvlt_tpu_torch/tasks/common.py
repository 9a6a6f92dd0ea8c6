"""Shared task plumbing of the port (counterpart of
``mvlt_tpu/tasks/common.py:23-177``): the model and its train state on one
device, the optimizer, checkpoints, the dropout masks of training and
metric logging.

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
  draws what the run it resumes would have drawn. ``rng_impl`` selects
  nothing here.
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
from mvlt_tpu_torch.train.state import TrainState, make_optimizer
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


def train_rng(tc: TrainConfig, device, offset: int = 0,
              step: int = 0) -> DropoutMasks:
    """The masks of training step ``step``: a generator on ``device``
    seeded with ``tc.seed + offset`` and folded with ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(tc.seed + offset, step))
    return DropoutMasks(gen)


def flax_leaves(name: str) -> int:
    """How many leaves of JAX's variables tree a port tensor stands for:
    a fused ``qkv`` of the fusion encoder is the three ``query`` / ``key`` /
    ``value`` Denses (``utils/convert.py``); every other tensor is one."""
    return 3 if ".qkv." in name and name.startswith("fusion.layers.") else 1


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


class TaskRunner:
    """Owns the model and its train state, the optimizer, checkpoints and
    logging, on one device. ``model_cls(config, dtype=, device=,
    compute_dtype=)`` builds the task model (``VQAModel``, ...)."""

    def __init__(self, model_cls, config: MVLTConfig,
                 train_config: TrainConfig = TrainConfig(),
                 workdir: Optional[str] = None, name: str = "mvlt",
                 device="cuda", plain: bool = False):
        mesh = train_config.mesh
        if mesh.model_parallel != 1 or mesh.data_parallel not in (1, -1):
            raise NotImplementedError(
                f"mesh {mesh}: the port runs on one device (ROADMAP.md queue "
                "A, 'Multi-device')")
        self.device = _need_cuda(device, "TaskRunner")
        self.model_cls = model_cls
        self.config = config
        self.train_config = train_config
        self.workdir = workdir
        self.plain = plain
        self.logger = setup_logger(name, workdir)
        self.metrics = MetricLogger(workdir)
        self.state: Optional[TrainState] = None
        self._window_samples = 0
        self._masks: Optional[DropoutMasks] = None

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
        optimizer."""
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
        self.state = TrainState(model=model, optimizer=opt, step=0)
        return self.state

    def masks_for_step(self, offset: int = 0) -> DropoutMasks:
        """The dropout / DropPath masks of the next step: the runner's
        generator reseeded from ``(seed + offset, state.step)``."""
        if self._masks is None:
            self._masks = train_rng(self.train_config, self.device, offset,
                                    self.state.step)
        else:
            self._masks.generator.manual_seed(step_seed(
                self.train_config.seed + offset, self.state.step))
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
