"""MLM+ITM pretraining loop of the port (counterpart of
``mvlt_tpu/tasks/pretrain.py:19-54``; reference ``pretrain_MVLBert``,
``run_pretrain.py:162-194``).

Per epoch, the shuffled train set (``drop_last``) through the loader and
the device prefetch; per batch, the seq2seq / bidirectional coin flip from
a generator seeded as ``train_rng(tc, offset=1)`` and folded with ``epoch *
1_000_000 + i`` (JAX folds the same number into its key), so that a
restored run flips what the run it resumes would have flipped; per step,
the masks of that step (``TaskRunner.masks_for_step``). Every
``checkpoint_every_epochs``: a checkpoint, then the model-only export to
``export_dir`` and to the numbered snapshot ``export_dir + "_epoch<e>"``
(run_pretrain.py:190-192).

The flip's generator is a CPU ``torch.Generator``: the mode is a host bool
that picks the step's program, as in JAX, and reading it costs no
synchronisation with the card. Its stream differs from JAX's
``jax.random.bernoulli`` draw by design (ROADMAP.md C)."""

from __future__ import annotations

from typing import Optional

from mvlt_tpu_torch.data.loader import DataLoader
from mvlt_tpu_torch.tasks.common import TaskRunner, train_rng
from mvlt_tpu_torch.train.steps import make_pretrain_step, seq2seq_coin_flip
from mvlt_tpu_torch.utils import checkpoint as ckpt_lib

# the flips of one epoch are folded in at epoch * FLIP_EPOCH_STRIDE + batch
FLIP_EPOCH_STRIDE = 1_000_000


def batch_mode(tc, epoch: int, i: int) -> bool:
    """The mask mode (True: seq2seq) of batch ``i`` of ``epoch``."""
    masks = train_rng(tc, "cpu", offset=1,
                      step=epoch * FLIP_EPOCH_STRIDE + i)
    return seq2seq_coin_flip(masks.generator)


def train_pretrain(runner: TaskRunner, train_ds,
                   epochs: Optional[int] = None,
                   export_dir: Optional[str] = None) -> None:
    tc = runner.train_config
    epochs = epochs if epochs is not None else tc.epochs
    step = make_pretrain_step(runner.model, runner.optimizer,
                              plain=runner.plain)
    loader = DataLoader(train_ds, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers)
    n_seq2seq = 0
    for epoch in range(epochs):
        for i, b in enumerate(step.prefetch(loader.epoch(epoch))):
            mode = batch_mode(tc, epoch, i)
            n_seq2seq += int(mode)
            step.masks = runner.masks_for_step()
            metrics = step(b, mode)
            runner.state.step += 1
            runner.log_step(metrics, samples=tc.batch_size)
        runner.logger.info("epoch %d done (seq2seq batches so far: %d)",
                           epoch, n_seq2seq)
        if (epoch + 1) % tc.checkpoint_every_epochs == 0:
            runner.save()
            if export_dir:
                # per-epoch export + numbered snapshot (run_pretrain.py:190-192)
                for path in (export_dir, export_dir + f"_epoch{epoch}"):
                    ckpt_lib.save_pretrained(path, runner.config, runner.model)
    runner.finish()
