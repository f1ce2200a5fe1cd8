"""Per-stage wall-clock accounting for the block pipeline.

``StageTimer`` sums wall time per named stage.  Work on a CUDA device
is asynchronous, so a timer given ``sync`` (``torch.cuda.synchronize``)
calls it before reading the clock at the end of each stage; the stage
then holds its own device time instead of handing it to the next
stage that waits on the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable


class StageTimer:
    """Accumulates wall time and calls per named stage."""

    def __init__(self, enabled: bool = False, sync: Callable[[], None] | None = None):
        self.enabled = enabled
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

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
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
