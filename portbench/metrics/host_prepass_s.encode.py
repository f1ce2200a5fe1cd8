"""Seconds an op the encode waits for the host pool's CRC, RLE and LZP (StageTimer encode/host_prepass)."""


def read(ctx):
    return ctx.per_op("encode/host_prepass")
