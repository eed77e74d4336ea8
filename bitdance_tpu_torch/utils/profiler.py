"""Profiling and debug switches on torch.profiler (port of
bitdance_tpu/utils/profiler.py).

StepProfiler keeps the reference's schedule (utils/profiler.py:16-23 of
the reference: wait 40 steps, warm up 2, record 2) and writes a Chrome
trace per recorded window under log_dir/host_<rank>/.
"""

from __future__ import annotations

import contextlib
import os

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class StepProfiler:
    """Schedule-driven profiler: wait ``wait`` steps, warm up ``warmup``,
    record ``active``, then write trace_step<N>.json (N the last recorded
    step). Call :meth:`step` once after every training step."""

    def __init__(self, log_dir: str, wait: int = 40, warmup: int = 2,
                 active: int = 2, enabled: bool = True, rank: int = 0):
        self.log_dir = os.path.join(log_dir, f"host_{rank}")
        self.wait, self.warmup, self.active = wait, warmup, active
        self.enabled = enabled
        self._prof = None
        if enabled:
            self._prof = torch.profiler.profile(
                activities=_activities(),
                schedule=torch.profiler.schedule(wait=wait, warmup=warmup,
                                                 active=active, repeat=1),
                on_trace_ready=self._export)
            self._prof.start()

    def _export(self, prof) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir,
                                              f"trace_step{prof.step_num - 1}.json"))

    def step(self) -> None:
        if self._prof is not None:
            self._prof.step()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write log_dir/trace.json (a Chrome trace).
    Work queued on the card is waited for before the trace ends."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd anomaly detection: a backward that makes a NaN raises and
    names the forward op (the port's jax_debug_nans)."""
    torch.autograd.set_detect_anomaly(enable)


def annotate(name: str):
    """A named range in traces."""
    return torch.profiler.record_function(name)
