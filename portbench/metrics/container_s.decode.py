"""Seconds an op in the container (decompress_file less its engine calls)."""


def read(ctx):
    return ctx.container_s("decode")
