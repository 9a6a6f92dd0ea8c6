"""Boolean environment switches of the port (its own copy of
``mvlt_tpu/utils/env.py:env_flag``).

The port honours the JAX package's opt-in kernel switches under their own
names, read at call time where JAX reads them at trace time:
``MVLT_KERNEL_DROPOUT`` (in-kernel attention dropout in the fusion encoder,
:mod:`mvlt_tpu_torch.models.fusion`), ``MVLT_STOREP`` and its kill switch
``MVLT_NO_STOREP`` (the stored-softmax backward of the >= 12-head Swin
blocks, :mod:`mvlt_tpu_torch.models.backbones.swin` and
:mod:`mvlt_tpu_torch.ops.blocks`).
"""

from __future__ import annotations

import os

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str) -> bool:
    """True iff the environment variable ``name`` is set to a truthy value:
    unset, empty, ``0``, ``false``, ``no`` and ``off`` (any case) are
    False, anything else is True."""
    return os.environ.get(name, "").strip().lower() not in _FALSY
