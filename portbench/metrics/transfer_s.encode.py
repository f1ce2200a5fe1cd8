"""Seconds an op in the pipeline's uploads and downloads (StageTimer encode/h2d, encode/d2h)."""


def read(ctx):
    return ctx.per_op("encode/h2d", "encode/d2h")
