"""Structured logging, metrics and progress.

The reference's observability is ANSI-colored prints and backspace-erased
counters (``train_fastercnn_func.py:51-62``, ``segment.py:86,134``).  Here:
a standard logger, a jsonl metrics writer, and a progress callback API.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def get_logger(name: str = "hcunet_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(os.environ.get("HCUNET_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


class Metrics:
    """Append-only jsonl metrics writer (tensorboard-free observability)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: list[dict] = []

    def write(self, **kv) -> None:
        kv.setdefault("time", time.time())
        self.history.append(kv)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(kv) + "\n")


class Progress:
    """Lightweight progress reporter — replaces the reference's
    backspace-erasing console counters."""

    def __init__(self, total: int, label: str = "", stream=sys.stderr,
                 every: float = 1.0):
        self.total = total
        self.label = label
        self.stream = stream
        self.count = 0
        self._last = 0.0
        self.every = every

    def tick(self, note: str = "") -> None:
        self.count += 1
        now = time.time()
        if now - self._last >= self.every or self.count == self.total:
            self._last = now
            self.stream.write(
                f"\r{self.label} {self.count}/{self.total} {note}   "
            )
            self.stream.flush()
            if self.count == self.total:
                self.stream.write("\n")
