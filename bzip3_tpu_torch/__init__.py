"""bzip3_tpu_torch — the BZ3v1 block codec on PyTorch and CUDA (Hopper).

The PyTorch/CUDA port of ``bzip3_tpu``.  Per block:

    host CRC32, RLE, LZP  ->  BWT (torch)  ->  CM range coder (CUDA kernel)

mirrored in reverse for decode with a CRC32 check.  Streams are
byte-identical to the reference bzip3 1.5.2 and to ``bzip3_tpu``.
Blocks are independent, which is the unit of data parallelism: each
wave's blocks split over the cards of a process, and blocks stripe over
the processes of a ``torch.distributed`` job (``bzip3_tpu_torch.parallel``;
the ``sharded`` engine).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a GPU the default raises.

Public API:

- :func:`compress` / :func:`decompress` — one-shot frame API
- :func:`compress_file` / :func:`decompress_file` / :func:`test_file` /
  :func:`recover_file` — the CLI's stream format
- :class:`Bz3Codec` — reusable block encoder/decoder (cf. bz3_new,
  bz3_encode_block, bz3_decode_block)
- :func:`bound` — worst-case compressed size of one block;
  :func:`min_memory_needed`, :func:`orig_size_sufficient_for_decode`
"""

from .version import __version__
from .errors import (
    BZ3_OK,
    BZ3_ERR_OUT_OF_BOUNDS,
    BZ3_ERR_BWT,
    BZ3_ERR_CRC,
    BZ3_ERR_MALFORMED_HEADER,
    BZ3_ERR_TRUNCATED_DATA,
    BZ3_ERR_DATA_TOO_BIG,
    BZ3_ERR_INIT,
    BZ3_ERR_DATA_SIZE_TOO_SMALL,
    Bz3Error,
    strerror,
)
from .container.bound import (
    bound,
    min_memory_needed,
    orig_size_sufficient_for_decode,
    BLOCK_SIZE_MIN,
    BLOCK_SIZE_MAX,
)
from .models.block_codec import Bz3Codec
from .container.frame import compress, decompress
from .container.stream import (
    compress_file,
    decompress_file,
    test_file,
    recover_file,
)

__all__ = [
    "__version__",
    "compress",
    "decompress",
    "compress_file",
    "decompress_file",
    "test_file",
    "recover_file",
    "Bz3Codec",
    "bound",
    "min_memory_needed",
    "orig_size_sufficient_for_decode",
    "BLOCK_SIZE_MIN",
    "BLOCK_SIZE_MAX",
    "Bz3Error",
    "strerror",
    "BZ3_OK",
    "BZ3_ERR_OUT_OF_BOUNDS",
    "BZ3_ERR_BWT",
    "BZ3_ERR_CRC",
    "BZ3_ERR_MALFORMED_HEADER",
    "BZ3_ERR_TRUNCATED_DATA",
    "BZ3_ERR_DATA_TOO_BIG",
    "BZ3_ERR_INIT",
    "BZ3_ERR_DATA_SIZE_TOO_SMALL",
]
