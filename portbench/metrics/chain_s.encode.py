"""Seconds an op in the device chain's CRC (K4), RLE and LZP (K5) (StageTimer)."""


def read(ctx):
    return ctx.per_op("encode/crc", "encode/rle", "encode/lzp")
