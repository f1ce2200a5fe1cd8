"""Seconds an op in the pipeline's uploads and downloads (StageTimer decode/h2d, decode/d2h)."""


def read(ctx):
    return ctx.per_op("decode/h2d", "decode/d2h")
