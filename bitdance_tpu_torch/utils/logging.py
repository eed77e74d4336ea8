"""Metrics and logging: a rank-0 logger, scalar summaries and running means
(port of bitdance_tpu/utils/logging.py).

The logger writes log.txt under the results directory and to the stream
(the reference's imagenet_gen/src/utils.py:8-26). ScalarWriter writes
TensorBoard summaries where ``torch.utils.tensorboard`` imports, else one
JSON line per scalar. MetricAccumulator keeps device tensors on the device
and reads them with one host sync per flush.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch


def create_logger(log_dir: str | None = None, rank: int = 0) -> logging.Logger:
    """The "bitdance_tpu_torch" logger: stream and log_dir/log.txt handlers
    on rank 0, a null handler elsewhere. Each call replaces the handlers of
    the last, so commands run one after another in a process each log to
    their own directory."""
    logger = logging.getLogger("bitdance_tpu_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    if rank == 0:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


class ScalarWriter:
    """TensorBoard scalar writer; log_dir/scalars.jsonl ({"tag", "value",
    "step", "time"} a line) where tensorboard does not import. Writes on
    rank 0 only."""

    def __init__(self, log_dir: str, rank: int = 0):
        self.log_dir = log_dir
        self.rank = rank
        self._tb = None
        self._jsonl = None
        if rank != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._tb = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.rank != 0:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        elif self._jsonl is not None:
            self._jsonl.close()


class MetricAccumulator:
    """Running means over a logging window. :meth:`update` adds 0-d tensors
    (any device) or numbers without reading them; :meth:`flush` reads every
    sum with one host sync and returns (means, steps per second)."""

    def __init__(self):
        self.sums: dict[str, torch.Tensor | float] = {}
        self.count = 0
        self.t0 = time.time()

    def update(self, **metrics) -> None:
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().float()
            self.sums[k] = self.sums[k] + v if k in self.sums else v
        self.count += 1

    def flush(self) -> tuple[dict, float]:
        sums = {k: float(v) for k, v in self.sums.items()
                if not isinstance(v, torch.Tensor)}
        held = [k for k, v in self.sums.items() if isinstance(v, torch.Tensor)]
        if held:
            dev = self.sums[held[0]].device
            read = torch.stack([self.sums[k].reshape(()).to(dev) for k in held])
            sums.update(zip(held, read.tolist()))          # the one host sync
        steps_per_sec = self.count / max(time.time() - self.t0, 1e-9)
        means = {k: v / max(self.count, 1) for k, v in sums.items()}
        self.sums, self.count, self.t0 = {}, 0, time.time()
        return means, steps_per_sec
