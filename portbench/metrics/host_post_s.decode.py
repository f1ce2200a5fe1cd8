"""Seconds an op the decode waits for the host pool's un-LZP, un-RLE and CRC (StageTimer decode/host_post)."""


def read(ctx):
    return ctx.per_op("decode/host_post")
