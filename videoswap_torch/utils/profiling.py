"""Profiling hooks (the port of videoswap_tpu/utils/profiling.py).

- `trace(dir)`: a context manager around the torch profiler (CPU and, where
  there is one, CUDA activity), its Chrome trace written under `dir`;
- `StepTimer`: wall-clock per-step statistics, the step's device
  synchronised at `stop` on demand;
- `annotate`: a named range of a step's phase in the trace
  (`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace goes to
    `log_dir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def annotate(name: str):
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Track per-step wall time; `summary()` gives mean/p50/p90."""
    sync: bool = False
    times: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """End the step; with `sync`, first wait for the device of
        `result` (a tensor) to finish its work."""
        if self.sync and isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            'steps': n,
            'mean_s': sum(ts) / n,
            'p50_s': ts[n // 2],
            'p90_s': ts[int(n * 0.9)],
            'total_s': sum(self.times),
        }
