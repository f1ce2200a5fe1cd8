"""Tracing and per-stage wall-clock accounting (counterpart of the JAX
package's ``utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the CPU and, where
  there is a card, of CUDA kernels, written as a Chrome trace into
  ``log_dir`` (``chrome://tracing`` or Perfetto read it).
- ``StageTimer``: wall time and calls per named stage, on when
  ``BZ3_TPU_PROFILE=1`` unless told otherwise.  Work on a CUDA device
  is asynchronous, so a timer given ``sync`` (``device_sync`` of the
  devices it times) calls it before reading the clock at the end of each
  stage; the stage then holds its own device time instead of handing it
  to the next stage that waits on the device.  Stages may close in
  several threads at once.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block inside into ``log_dir``/trace_<pid>_<ns>.json
    (CPU activity, and CUDA activity when a card is present); yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_sync(devices) -> Callable[[], None] | None:
    """A ``StageTimer`` sync that waits for every distinct card among
    ``devices`` (``torch.cuda.synchronize`` waits for the current card
    only); None when none of them is a card."""
    cards = {d.index for d in map(torch.device, devices) if d.type == "cuda"}
    if not cards:
        return None

    def sync() -> None:
        for i in cards:
            torch.cuda.synchronize(i)

    return sync


class StageTimer:
    """Accumulates wall time and calls per named stage; ``enabled=None``
    reads ``BZ3_TPU_PROFILE`` (on at 1)."""

    def __init__(self, enabled: bool | None = None, sync: Callable[[], None] | None = None):
        if enabled is None:
            enabled = os.environ.get("BZ3_TPU_PROFILE", "0") == "1"
        self.enabled = enabled
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:20s} {self.totals[name]*1e3:10.2f} ms  x{self.counts[name]}"
            )
        return "\n".join(lines)
