"""Single-block stage namespace on one device (counterpart of the JAX
package's ``ops/device/__init__.py:65-136``).

``BlockStages(device)`` serves the stage API that the block codec
(``models/block_codec.py``) runs stage by stage, each function on one
block of ``bytes``:

    crc32(data) -> int
    bwt_forward(data) -> (U, index);   bwt_inverse(U, index) -> bytes | None
    cm_encode(data) -> bytes;          cm_decode(payload, out_len) -> bytes
    rle_encode(data) -> bytes;         rle_decode(data, out_len) -> bytes | None
    lzp_encode(data) -> bytes | None;  lzp_decode(data, max_out) -> bytes | None

Each function puts its block on the device as one row and runs the
batched stage on it.  On ``cuda`` the CRC is K4 (``crc32_cuda``), the CM
coder K1/K2 (``cm_cuda``; a row wider than one launch chunk takes K3a/K3b
there), the BWT and RLE tensor code, and LZP the host C++ (``ops/host``),
as the JAX package keeps LZP on the host for a single block.  On ``cpu``
every function takes the plain version: the same wrappers on CPU
tensors, and the plain LZP rows (``lzp.py``).  Rows are padded only
where a wrapper needs it; there is no ``jit`` to bucket widths for.
"""

from __future__ import annotations

import torch

from .. import host
from . import cm_cuda, crc32_cuda, lzp, rle
from .bwt import bwt_forward_batch, bwt_inverse_batch

_BY_DEVICE: dict[torch.device, "BlockStages"] = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class BlockStages:
    """The stage API on ``device`` (a ``torch.device`` or its name)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        on_cpu = self.device.type == "cpu"
        self.lzp_encode = lzp.encode_row if on_cpu else host.lzp_encode
        self.lzp_decode = lzp.decode_row if on_cpu else host.lzp_decode

    def _row(self, data: bytes):
        """data as a [1, W] uint8 row, zero-padded to W = its length
        rounded up to 16 (at least 16: the kernels' 16-byte readers and
        the BWT's seed symbols), and its [1] int32 length."""
        n = len(data)
        w = _round_up(max(1, n), 16)
        row = torch.zeros((1, w), dtype=torch.uint8)
        if n:
            row[0, :n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        lens = torch.tensor([n], dtype=torch.int32)
        return row.to(self.device), lens.to(self.device)

    def _lens(self, n: int) -> torch.Tensor:
        return torch.tensor([n], dtype=torch.int32).to(self.device)

    @staticmethod
    def _bytes(row: torch.Tensor, n: int) -> bytes:
        return row[0, :n].cpu().numpy().tobytes()

    def crc32(self, data: bytes) -> int:
        """CRC32-C with init 1, no final xor (src/libbz3.c:37-72)."""
        return int(crc32_cuda.crc32_batch(*self._row(data))[0])

    def bwt_forward(self, data: bytes):
        n = len(data)
        if n <= 1:
            return data, n
        row, lens = self._row(data)
        u, idx = bwt_forward_batch(row, lens)
        return self._bytes(u, n), int(idx[0])

    def bwt_inverse(self, u: bytes, index: int):
        n = len(u)
        if n <= 1:
            return u if index == n else None
        if index <= 0 or index > n:
            return None
        row, lens = self._row(u)
        return self._bytes(bwt_inverse_batch(row, lens, self._lens(index)), n)

    def cm_encode(self, data: bytes) -> bytes:
        row, lens = self._row(data)
        out, olens = cm_cuda.cm_encode(row, lens)
        plen = int(olens[0])
        if plen > out.shape[1]:  # past the default width: again, with room
            out, olens = cm_cuda.cm_encode(row, lens, plen)
        return self._bytes(out, plen)

    def cm_decode(self, payload: bytes, out_len: int) -> bytes:
        row, lens = self._row(payload)
        out = cm_cuda.cm_decode(row, lens, self._lens(out_len),
                                _round_up(max(1, out_len), 256))
        return self._bytes(out, out_len)

    def rle_encode(self, data: bytes) -> bytes:
        """mRLE; an expanding stream past the row's output width comes
        back as zeros of its true length (callers keep RLE only when it
        shrinks)."""
        n = len(data)
        row, lens = self._row(data)
        out, olens = rle.rle_encode_batch(row, lens, n + 64)
        m = int(olens[0])
        if m > out.shape[1]:
            return b"\x00" * m
        return self._bytes(out, m)

    def rle_decode(self, data: bytes, out_len: int):
        row, lens = self._row(data)
        out, ok = rle.rle_decode_batch(row, lens, self._lens(out_len), max(1, out_len))
        return self._bytes(out, out_len) if bool(ok[0]) else None


def block_stages(device="cuda") -> BlockStages:
    """The ``BlockStages`` of ``device``, made once per device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _BY_DEVICE:
        _BY_DEVICE[dev] = BlockStages(dev)
    return _BY_DEVICE[dev]
