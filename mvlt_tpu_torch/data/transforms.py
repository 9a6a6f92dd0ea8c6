"""Host-side data transforms of the port (numpy, explicit PRNG): a copy of
the pieces of ``mvlt_tpu/data/transforms.py`` that the port's drivers use.
So far that is :func:`sample_rng` (``transforms.py:34-42``), which keys the
loader's shuffle; the image and masking transforms come with the pretrain
and caption drivers (ROADMAP.md queue A, "Host modules")."""

from __future__ import annotations

import numpy as np


def sample_rng(seed: int, epoch: int, index: int,
               tag: int = 0) -> np.random.Generator:
    """Stable per-sample generator (independent of worker layout).
    Philox takes a 128-bit key: pack (seed, epoch) and (index, tag)."""
    key = np.array([(np.uint64(seed & 0xFFFFFFFF) << np.uint64(32))
                    | np.uint64(epoch & 0xFFFFFFFF),
                    (np.uint64(index & 0xFFFFFFFF) << np.uint64(32))
                    | np.uint64(tag & 0xFFFFFFFF)], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))
