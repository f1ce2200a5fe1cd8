"""What a traced run gives the per-layer readers (``Ctx``): the timed
ops, the program's stage times (its ``StageTimer``), the device trace,
the benchmark's spans and the work of each op."""

from __future__ import annotations

from ..harness import trace as tr
from . import work


class Ctx:
    def __init__(self, ops, stages, device, spans, rows, payloads):
        self.ops = ops  # the window's ops (enc_s, dec_s, in_bytes, ...)
        self.n_ops = len(ops)
        self.stages = stages  # StageTimer totals over the window, s
        self.device = device  # [(name, start, end)] on the profiler's clock
        self.spans = spans  # [(name, start, end)] benchmark spans, same clock
        self.rows = rows  # CM row bytes a block of the op's file
        self.payloads = payloads  # CM payload bytes a block
        self.busy = tr.merge([(a, b) for _, a, b in device])

    def per_op(self, *stage_names: str) -> float | None:
        """Seconds an op of the named StageTimer stages; None when none ran."""
        if not self.n_ops or not any(s in self.stages for s in stage_names):
            return None
        return sum(self.stages.get(s, 0.0) for s in stage_names) / self.n_ops

    def op_spans(self, direction: str) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.spans if n == "op." + direction]

    def container_s(self, direction: str) -> float | None:
        """Seconds an op in the container: the call's time less its engine
        calls' (the benchmark's spans, host clock)."""
        ops = [s for s in self.spans if s[0] == "op." + direction]
        eng = [s for s in self.spans if s[0] == "engine." + direction]
        if not ops:
            return None
        total = sum(b - a for _, a, b in ops) - sum(b - a for _, a, b in eng)
        return total / len(ops)

    def kernel_s(self, name: str, direction: str) -> float | None:
        """Device seconds an op of kernels named ``name`` inside the ops of
        ``direction``; None when the trace holds none."""
        spans = self.op_spans(direction)
        ivs = [(a, b) for n, a, b in self.device if n == name]
        if not ivs or not spans:
            return None
        return sum(tr.overlap(tr.merge(ivs), a, b) for a, b in spans) / len(spans)

    def idle_pct(self, direction: str) -> float | None:
        spans = self.op_spans(direction)
        if not spans or not self.device:
            return None
        total = sum(b - a for a, b in spans)
        busy = sum(tr.overlap(self.busy, a, b) for a, b in spans)
        return 100.0 * (1.0 - busy / total)

    def cm_roofline(self, kernel: str, direction: str) -> float | None:
        t = self.kernel_s(kernel, direction)
        if t is None or not self.rows:
            return None
        return work.roofline_pct(*work.cm_work(self.rows, self.payloads), t)
