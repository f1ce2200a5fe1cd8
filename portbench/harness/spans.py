"""The benchmark's own host spans: a name and the host clock's start and
end of each, kept in memory; while a trace runs, each is also a
``torch.profiler.record_function`` range, so that the trace names what
the host was doing while the card sat idle."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.records.append((name, t0, t1))

    def clear(self) -> None:
        self.records.clear()


class SpanEngine:
    """An engine as ``compress_file`` / ``decompress_file`` drive it, each
    batch call inside a span ``engine.encode`` / ``engine.decode``."""

    def __init__(self, engine, spans: Spans):
        self.engine, self.spans = engine, spans
        self.stages = engine.stages

    def encode_blocks(self, blocks, block_size=None):
        with self.spans.span("engine.encode"):
            return self.engine.encode_blocks(blocks, block_size)

    def decode_blocks(self, pairs, block_size):
        with self.spans.span("engine.decode"):
            return self.engine.decode_blocks(pairs, block_size)


class SpanTimer:
    """Wraps the program's ``StageTimer`` so that each of its stages is
    also a span (``stage:<name>``) of the trace; totals and counts stay
    the timer's own."""

    def __init__(self, timer, spans: Spans):
        self.timer, self.spans = timer, spans

    def __getattr__(self, name):
        return getattr(self.timer, name)

    @contextlib.contextmanager
    def stage(self, name: str):
        with self.spans.span("stage:" + name), self.timer.stage(name):
            yield
