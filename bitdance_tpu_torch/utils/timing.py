"""Phase times of a generation path, in seconds."""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Seconds per named phase, summed over every span of that name: CUDA
    events on the card (read once, in :meth:`totals`), the host clock
    elsewhere. ``totals()["clock"]`` says which."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans: list = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = self._now()
        yield
        self._spans.append((name, start, self._now()))

    def totals(self) -> dict:
        out: dict = {}
        if self.cuda and self._spans:
            self._spans[-1][2].synchronize()
        for name, a, b in self._spans:
            dt = a.elapsed_time(b) / 1000.0 if self.cuda else b - a
            out[name] = out.get(name, 0.0) + dt
        out["clock"] = "cuda_events" if self.cuda else "host"
        return out
