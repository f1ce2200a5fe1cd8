"""Seconds an op in the inverse BWT, all groups (StageTimer decode/bwt)."""


def read(ctx):
    return ctx.per_op("decode/bwt")
