"""Seconds an op in the forward BWT, all groups (StageTimer encode/bwt)."""


def read(ctx):
    return ctx.per_op("encode/bwt")
