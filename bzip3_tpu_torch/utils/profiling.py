"""Tracing and per-stage wall-clock accounting (counterpart of the JAX
package's ``utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the CPU and, where
  there is a card, of CUDA kernels, written as a Chrome trace into
  ``log_dir`` (``chrome://tracing`` or Perfetto read it).  It records
  every thread where the installed torch can, so the host pool's spans
  are in it too.
- ``StageTimer``: wall time and calls per named stage, on when
  ``BZ3_TPU_PROFILE=1`` unless told otherwise.  Work on a CUDA device
  is asynchronous, so a timer given ``sync`` (``device_sync`` of the
  devices it times) calls it before reading the clock at the end of each
  stage; the stage then holds its own device time instead of handing it
  to the next stage that waits on the device.  Stages may close in
  several threads at once.  ``span`` times host work alone (no
  synchronise), in any thread: the host pool's passes total
  thread-seconds.  ``add`` counts.  While a profiler records, every
  stage and span of a timer that is on is also a ``record_function``
  range of the trace (a stage as ``stage:<name>``).
- ``host_span(timer, name)``: a span on ``timer`` where it is on, else
  only the trace's range while a profiler records.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def ranged(name: str):
    """A ``record_function(name)`` range while a ``torch.profiler``
    records, else a context that does nothing.  Recording is read from
    the process-wide flag the profiler's start sets, or this thread's
    own: a profiler of every thread (``profile_all_threads``) leaves the
    calling thread's flag off."""
    if (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch._C._autograd._profiler_enabled()):
        return _autograd_profiler.record_function(name)
    return _OFF


def _all_threads() -> dict:
    """``profile``'s argument that records every thread, where the
    installed torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block inside into ``log_dir``/trace_<pid>_<ns>.json
    (CPU activity of every thread, and CUDA activity when a card is
    present); yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, **_all_threads()) as prof:
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


def host_span(timer, name: str):
    """A host span ``name``: on ``timer`` (its ``span``) where it is on,
    else only a ``record_function`` range while a profiler records."""
    if timer is not None and getattr(timer, "enabled", False):
        return timer.span(name)
    return ranged(name)


class StageTimer:
    """Accumulates wall time and calls per named stage or span, and
    counts (``counters``); ``enabled=None`` reads ``BZ3_TPU_PROFILE`` (on
    at 1)."""

    def __init__(self, enabled: bool | None = None, sync: Callable[[], None] | None = None):
        if enabled is None:
            enabled = os.environ.get("BZ3_TPU_PROFILE", "0") == "1"
        self.enabled = enabled
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def _record(self, name: str, dt: float) -> None:
        with self._lock:
            self.totals[name] += dt
            self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        with ranged("stage:" + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync is not None:
                    self.sync()
                self._record(name, time.perf_counter() - t0)

    def span(self, name: str):
        """Host time of the block inside under ``name``, never
        synchronising a device; nothing when the timer is off."""
        return self._span(name) if self.enabled else _OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        with ranged(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._record(name, time.perf_counter() - t0)

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (nothing when off)."""
        if self.enabled:
            with self._lock:
                self.counters[name] += n

    def clear(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()

    def summary(self) -> str:
        """A line a stage or span (the JAX package's format); then, once
        anything was counted, a line a counter, a line a kernel's
        launches in this process (the wrappers' ``LAUNCHES``, those not
        0), and a line a native library's build and load seconds
        (``ops.build.LOADS``)."""
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:20s} {self.totals[name]*1e3:10.2f} ms  x{self.counts[name]}"
            )
        if not self.counters:
            return "\n".join(lines)
        from ..ops import build
        from ..ops.device import cm_cuda, cm_parallel_cuda, crc32_cuda, lzp_cuda

        for name in sorted(self.counters):
            lines.append(f"{name:30s} {self.counters[name]:10d}")
        for mod in (cm_cuda, crc32_cuda, lzp_cuda, cm_parallel_cuda):
            for kernel, n in mod.LAUNCHES.items():
                if n:
                    lines.append(f"{'launches/' + kernel:30s} {n:10d}")
        for lib, secs in sorted(build.LOADS.items()):
            for what, s in secs.items():
                lines.append(f"{f'lib/{lib}/{what}':30s} {s*1e3:10.2f} ms")
        return "\n".join(lines)
