"""The benchmark's plain reference of BZ3v1 (reference: bzip3 1.5.2,
src/libbz3.c and src/main.c): NumPy and the standard library only, and
nothing of the program under test.

``crc32``, ``rle``, ``lzp``, ``bwt`` and ``cm`` are frozen copies of the
encoders of the port's executable spec (its ``ops/ref``), with faster
forms of the CRC, RLE, LZP and suffix sort that tests hold to the copies;
``stream`` frames a file and parses a stream as the CLI's format has it.
"""
