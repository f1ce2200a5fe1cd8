"""Seconds an op in the container (compress_file less its engine calls)."""


def read(ctx):
    return ctx.container_s("encode")
