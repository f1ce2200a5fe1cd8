"""The port's executable spec: every stage codec of BZ3v1 as a small,
readable NumPy/Python program (reference: src/libbz3.c).

These define the stage semantics byte for byte, independently of the
tensor code and the kernels: the ``oracle`` engine (``engines.py``) runs
the block codec over them, and the tests and harnesses hold the card's
streams to them.  numpy and the standard library only.
"""

from .crc32 import crc32
from .rle import rle_encode, rle_decode
from .lzp import lzp_encode, lzp_decode
from .bwt import bwt_forward, bwt_inverse
from .cm import cm_encode, cm_decode

__all__ = [
    "crc32",
    "rle_encode",
    "rle_decode",
    "lzp_encode",
    "lzp_decode",
    "bwt_forward",
    "bwt_inverse",
    "cm_encode",
    "cm_decode",
]
