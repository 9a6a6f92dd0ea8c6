"""Small utilities (counterpart of ``mvlt_tpu/utils/misc.py``, the
reference's ``utils.py:3-7``)."""

from __future__ import annotations


def print_obj(obj, logger=None) -> None:
    """Dump an object's ``__dict__``, one ``key: value`` line each, to
    ``logger.info`` or stdout (reference ``print_obj``)."""
    emit = logger.info if logger is not None else print
    for k, v in vars(obj).items():
        emit(f"{k}: {v}")
