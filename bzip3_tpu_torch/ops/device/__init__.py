"""Device stages of the port, batched over [K, N] rows of blocks.

- ``crc32_batch``: CRC-32C, lane states from the CUDA kernel K4
  (``crc32_cuda``) combined as tensor code (``crc32``);
- ``rle_encode_batch`` / ``rle_decode_batch``: mRLE as tensor code (``rle``);
- ``lzp_encode`` / ``lzp_decode``: LZP, CUDA kernels K5/K6 (``lzp_cuda``);
- ``bwt_forward_batch`` / ``bwt_inverse_batch``: BWT as tensor code (``bwt``);
- ``cm_encode`` / ``cm_decode``: the CM coder, CUDA kernels K1/K2 (``cm_cuda``),
  or K3a/K3b for rows wider than one launch chunk;
- ``cm_encode_parallel_batch`` / ``cm_encode_parallel``: the parallel CM
  encoder (sorted per-slot counter chains, then a table-free range
  coder), CUDA kernels P1/P2 (``cm_parallel_cuda``), the latter over
  groups of rows;
- ``cm_encode_resumable`` / ``cm_decode_resumable`` / ``cm_decode_stream``:
  the CM coder in launches of a chunk of steps each, CUDA kernels K3a,
  K3b and K3c (``cm_cuda``);
- ``BlockStages`` / ``block_stages(device)``: the single-block stage
  namespace that the block codec runs on one device (``stages``).

Each kernel wrapper takes its plain PyTorch version (``crc32``, ``lzp``,
``cm``, ``cm_parallel``) for tensors on the CPU.
"""

from .bwt import bwt_forward_batch, bwt_inverse_batch
from .cm_cuda import (
    cm_decode,
    cm_decode_resumable,
    cm_decode_stream,
    cm_encode,
    cm_encode_resumable,
)
from .cm_parallel import cm_encode_parallel_batch
from .cm_parallel_cuda import cm_encode_parallel
from .crc32_cuda import crc32_batch
from .lzp_cuda import lzp_decode, lzp_encode
from .rle import rle_decode_batch, rle_encode_batch
from .stages import BlockStages, block_stages

__all__ = [
    "BlockStages",
    "block_stages",
    "bwt_forward_batch",
    "bwt_inverse_batch",
    "cm_decode",
    "cm_decode_resumable",
    "cm_decode_stream",
    "cm_encode",
    "cm_encode_parallel",
    "cm_encode_parallel_batch",
    "cm_encode_resumable",
    "crc32_batch",
    "lzp_decode",
    "lzp_encode",
    "rle_decode_batch",
    "rle_encode_batch",
]
