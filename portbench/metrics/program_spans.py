"""Seconds an op of the program's own host spans of one name, read from
the trace: the ``record_function`` ranges its ``utils.profiling``
opens while a profiler records (absent from a program that has none)."""

from __future__ import annotations

from ..harness import trace as tr


def per_op(ctx, name: str, direction: str) -> float | None:
    """Seconds of the spans ``name`` inside the ops of ``direction``
    (``op.encode`` / ``op.decode``), over the number of those ops; None
    when the trace holds no such span or no such op."""
    ops = ctx.op_spans(direction)
    ivs = tr.merge([(a, b) for n, a, b in ctx.spans if n == name])
    if not ops or not ivs:
        return None
    return sum(tr.overlap(ivs, a, b) for a, b in ops) / len(ops)
