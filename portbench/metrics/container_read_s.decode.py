"""Seconds an op in the container's reads (the program's spans container/decode/read)."""

from portbench.metrics.program_spans import per_op


def read(ctx):
    return per_op(ctx, "container/decode/read", "decode")
