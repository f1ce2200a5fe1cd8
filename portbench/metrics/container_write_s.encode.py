"""Seconds an op in the container's writes (the program's spans container/encode/write)."""

from portbench.metrics.program_spans import per_op


def read(ctx):
    return per_op(ctx, "container/encode/write", "encode")
