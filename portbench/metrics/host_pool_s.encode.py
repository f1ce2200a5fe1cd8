"""Thread-seconds an op the host pool spends on the encode's CRC, RLE,
LZP and BWT difficulty (StageTimer spans pool/encode/*)."""


def read(ctx):
    return ctx.per_op("pool/encode/crc", "pool/encode/rle", "pool/encode/lzp",
                      "pool/encode/difficulty")
