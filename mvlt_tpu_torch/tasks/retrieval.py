"""Image-text retrieval of the port (counterpart of
``mvlt_tpu/tasks/retrieval.py:20-118``; reference
``run_retrieval.py:148-356``): train on ``cat(pos, neg)`` batches; test by
P(match) for every (image, caption) pair of a test set, then rank R@1 / 5 /
10 in both directions.

:func:`train_retrieval` is JAX's loop: per epoch, the shuffled train split
(``drop_last``), each batch's positives and negatives concatenated on the
host (2 x ``batch_size`` rows, logged as such), through the device
prefetch, one retrieval step a batch with the masks of that step; a
checkpoint every ``checkpoint_every_epochs``.

:func:`score_grid` / :func:`eval_retrieval` take JAX's runner signatures:
they read the images, caption ids and ``cap_id``s out of a test
``RetrievalDataset`` (JAX's step 1) and score them with
:func:`score_images`, which takes those three arrays: the visual backbone
once per image, in chunks of ``batch_size``; then the fusion encoder and
the ITM head sweep the grid one image row at a time, the row's features
broadcast (``expand``, no copy) against each chunk of captions. A last
chunk shorter than ``batch_size`` runs as it is: rows are independent, and
JAX's zero padding of it changes no kept score.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from mvlt_tpu_torch.data.loader import DataLoader
from mvlt_tpu_torch.metrics.retrieval import evaluate_retrieval
from mvlt_tpu_torch.train.steps import make_retrieval_step

if TYPE_CHECKING:       # tasks.common imports flagship, which imports this
    from mvlt_tpu_torch.tasks.common import TaskRunner

PAIR_KEYS = ("image", "caption", "label")


def merge_pairs(batch) -> Dict[str, np.ndarray]:
    """A train batch's ``pos`` then ``neg`` rows (run_retrieval.py:162-177)."""
    return {k: np.concatenate([batch["pos"][k], batch["neg"][k]])
            for k in PAIR_KEYS}


def train_retrieval(runner: TaskRunner, train_ds,
                    epochs: Optional[int] = None) -> None:
    """trainRetrieval (run_retrieval.py:148-189): batch = cat(pos, neg)."""
    tc = runner.train_config
    epochs = epochs if epochs is not None else tc.epochs
    step = make_retrieval_step(runner.model, runner.optimizer,
                               plain=runner.plain)
    loader = DataLoader(train_ds, tc.batch_size, shuffle=True, drop_last=True,
                        seed=tc.seed, num_workers=tc.num_workers)
    for epoch in range(epochs):
        merged = map(merge_pairs, loader.epoch(epoch))
        for b in step.prefetch(merged):
            step.masks = runner.masks_for_step()
            metrics = step(b)
            runner.state.step += 1
            runner.log_step(metrics, samples=2 * tc.batch_size)
        if (epoch + 1) % tc.checkpoint_every_epochs == 0:
            runner.save()
    runner.finish()


@torch.no_grad()
def encode_images(model, images, batch_size: int = 64,
                  plain: bool = False) -> torch.Tensor:
    """Backbone features (n, tokens, hidden) of images (n, C, H, W), in
    chunks of ``batch_size`` on the model's device."""
    device = next(model.parameters()).device
    images = torch.as_tensor(images)
    return torch.cat([
        model.encode_image(images[s:s + batch_size].to(device), plain)
        for s in range(0, images.shape[0], batch_size)])


@torch.no_grad()
def score_matrix(model, feats: torch.Tensor, captions,
                 batch_size: int = 64, plain: bool = False) -> torch.Tensor:
    """P(match) (images, captions) float32 on the model's device: each
    image's features (``feats[i]``, broadcast) against every chunk of
    ``batch_size`` caption ids (m, L), on the fusion encoder and the head
    only. Nothing is read back to the host."""
    device = feats.device
    caps = torch.as_tensor(captions).to(device)
    n, m = feats.shape[0], caps.shape[0]
    sims = torch.empty((n, m), dtype=torch.float32, device=device)
    for i in range(n):
        for s in range(0, m, batch_size):
            chunk = caps[s:s + batch_size]
            feat = feats[i:i + 1].expand(chunk.shape[0], -1, -1)
            sims[i, s:s + chunk.shape[0]] = model.score_from_features(
                feat, chunk, plain)
    return sims


def grid_labels(cap_ids) -> np.ndarray:
    """(n, n) int32: 1 where the image and the caption are one sample or
    share a ``cap_id`` (``tasks/retrieval.py:110-112``)."""
    cap_ids = np.asarray(cap_ids)
    n = cap_ids.shape[0]
    return ((np.arange(n)[:, None] == np.arange(n)[None, :])
            | (cap_ids[:, None] == cap_ids[None, :])).astype(np.int32)


def score_images(model, images, captions, cap_ids, batch_size: int = 64,
                 plain: bool = False) -> Dict[str, np.ndarray]:
    """P(match) for all n x n pairs of a :class:`RetrievalModel`: images
    (n, C, H, W), caption ids (n, L) (0 = padding), ``cap_ids`` (n,).
    Returns ``{"similarities": (n, n) float32, "labels": (n, n) int32}``
    as numpy, rows = images, columns = captions. ``plain=True`` runs the
    kernels' plain versions."""
    feats = encode_images(model, images, batch_size, plain)
    sims = score_matrix(model, feats, captions, batch_size, plain)
    return {"similarities": sims.cpu().numpy(), "labels": grid_labels(cap_ids)}


def grid_arrays(test_ds):
    """(images (n, ...), caption ids (n, L), cap_ids) of a test
    ``RetrievalDataset``'s samples (``tasks/retrieval.py:76-84``)."""
    images, caps, cap_ids = [], [], []
    for i in range(test_ds.img_num):
        im, cap, _, cap_id = test_ds.source[i]
        images.append(np.asarray(im))
        caps.append(test_ds._cap_ids(cap))
        cap_ids.append(cap_id)
    return np.stack(images), np.asarray(caps), cap_ids


def score_grid(runner: TaskRunner, test_ds, batch_size: int = 64
               ) -> Dict[str, np.ndarray]:
    """testRetrieval (run_retrieval.py:192-217): P(match) for all n x n
    pairs of a test ``RetrievalDataset`` (``{"similarities",
    "labels"}``), on the runner's model."""
    return score_images(runner.model, *grid_arrays(test_ds), batch_size,
                        plain=runner.plain)


def eval_retrieval(runner: TaskRunner, test_ds,
                   batch_size: int = 64) -> Dict:
    """R@1 / 5 / 10 of :func:`score_grid` (``tasks/retrieval.py:115-118``)."""
    grid = score_grid(runner, test_ds, batch_size)
    return evaluate_retrieval(grid["similarities"], grid["labels"])
