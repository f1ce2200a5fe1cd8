"""Seconds an op in the container's reads (the program's spans container/encode/read)."""

from portbench.metrics.program_spans import per_op


def read(ctx):
    return per_op(ctx, "container/encode/read", "encode")
