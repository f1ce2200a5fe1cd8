"""Seconds an op in the device chain's un-LZP (K6), un-RLE and CRC (K4) (StageTimer)."""


def read(ctx):
    return ctx.per_op("decode/lzp", "decode/rle", "decode/crc_verify")
