"""Block framing of the BZ3v1 format: the block codec, RLE -> LZP ->
BWT -> CM with the stage bits in each block's header."""

from .block_codec import Bz3Codec, encode_block, decode_block

__all__ = ["Bz3Codec", "encode_block", "decode_block"]
