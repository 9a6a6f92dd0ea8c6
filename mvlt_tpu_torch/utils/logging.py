"""Logging of the port: a copy of ``mvlt_tpu/utils/logging.py:21-80``.

``setup_logger`` mirrors the reference (``modules/logger.py:82-105``): INFO
to stdout and a flush-per-record ``log.txt`` file handler; non-zero ranks
get a silent logger. Set up again with another directory, the logger moves
its file there (JAX's keeps writing to the first directory, so its second
``run_vqa`` round logs into ``round0/log.txt``). ``MetricLogger`` writes one JSON line a logged step to
``metrics.jsonl``: the step's metrics, the window's samples/s (an EMA) and
step time, on the host clock.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


class FlushFileHandler(logging.FileHandler):
    def emit(self, record):
        super().emit(record)
        self.flush()


def setup_logger(name: str, save_dir: Optional[str] = None,
                 distributed_rank: int = 0,
                 filename: str = "log.txt") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if save_dir:
        # a logger set up again for another directory (the next round of
        # run_vqa, a second runner) writes there, not to the first one's
        path = os.path.abspath(os.path.join(save_dir, filename))
        for h in [h for h in logger.handlers
                  if isinstance(h, FlushFileHandler)]:
            if h.baseFilename == path:
                return logger
            logger.removeHandler(h)
            h.close()
        os.makedirs(save_dir, exist_ok=True)
        fh = FlushFileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Step timing + JSONL metric stream."""

    def __init__(self, save_dir: Optional[str] = None, ema: float = 0.9):
        self._t = None
        self._ema = ema
        self._rate = None
        self._file = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._file = open(os.path.join(save_dir, "metrics.jsonl"), "a")

    def step(self, step: int, metrics: Dict, samples: int = 0) -> Dict:
        now = time.perf_counter()
        out = {k: float(v) for k, v in metrics.items()}
        if self._t is not None and samples:
            dt = now - self._t
            rate = samples / dt
            self._rate = rate if self._rate is None else (
                self._ema * self._rate + (1 - self._ema) * rate)
            out["samples_per_sec"] = self._rate
            out["step_time_s"] = dt
        self._t = now
        out["step"] = step
        if self._file:
            self._file.write(json.dumps(out) + "\n")
            self._file.flush()
        return out

    def close(self):
        if self._file:
            self._file.close()
