"""Image-text retrieval evaluation (counterpart of
``mvlt_tpu/tasks/retrieval.py:45-118``; reference
``run_retrieval.py:192-217``): P(match) for every (image, caption) pair of
a test set, then rank R@1 / 5 / 10 in both directions.

:func:`score_grid` is the body of JAX's ``score_grid`` after its step 1
(which reads the images, caption ids and ``cap_id``s out of a
``RetrievalDataset``): the caller passes those three arrays. The visual
backbone runs once per image, in chunks of ``batch_size``; the fusion
encoder and the ITM head then sweep the grid one image row at a time, the
row's features broadcast (``expand``, no copy) against each chunk of
captions. A last chunk shorter than ``batch_size`` runs as it is: rows are
independent, and JAX's zero padding of it changes no kept score.

Still to come with ``TaskRunner``, the data loader and the datasets
(ROADMAP.md queue A, "Host modules that the tasks need" and "Tasks and
drivers"): the runner-based signatures (``score_grid(runner, test_ds)``)
and ``train_retrieval``. The train step is
:func:`mvlt_tpu_torch.train.steps.make_retrieval_step`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mvlt_tpu_torch.metrics.retrieval import evaluate_retrieval


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


def score_grid(model, images, captions, cap_ids, batch_size: int = 64,
               plain: bool = False) -> Dict[str, np.ndarray]:
    """P(match) for all n x n pairs of a :class:`RetrievalModel`: images
    (n, C, H, W), caption ids (n, L) (0 = padding), ``cap_ids`` (n,).
    Returns ``{"similarities": (n, n) float32, "labels": (n, n) int32}``
    as numpy, rows = images, columns = captions. ``plain=True`` runs the
    kernels' plain versions."""
    feats = encode_images(model, images, batch_size, plain)
    sims = score_matrix(model, feats, captions, batch_size, plain)
    return {"similarities": sims.cpu().numpy(), "labels": grid_labels(cap_ids)}


def eval_retrieval(model, images, captions, cap_ids,
                   batch_size: int = 64) -> Dict:
    """R@1 / 5 / 10, image to text and text to image, of
    :func:`score_grid` (``tasks/retrieval.py:115-118``)."""
    grid = score_grid(model, images, captions, cap_ids, batch_size)
    return evaluate_retrieval(grid["similarities"], grid["labels"])
