"""Batched CRC-32C as PyTorch tensor code (counterpart of the JAX
package's ``ops/device/crc32.py`` and of the lane-state half of
``crc32_pallas.py``).

The BZ3v1 checksum (reflected CRC-32C, init 1, no final xor; reference
src/libbz3.c:37-72) of each row of a [K, N] batch:

1. the row, cut to its length and padded with zeros to ``lanes * seg``
   bytes, splits into ``lanes`` contiguous segments of ``seg`` bytes;
   each lane runs the byte-serial table recurrence with init 0
   (``crc_lane_scan``, the plain version of the CUDA kernel K4 in
   ``crc32_cuda``);
2. lane states merge through constant GF(2) shift matrices
   (Z**(bytes after the lane), ``gf2.py``), zlib's crc32_combine;
3. the zero padding past each row's length is undone by applying Z**-1
   once per set bit of the pad length.

CRC states are int64 masked to 32 bits: torch's ``>>`` on int32 is
arithmetic, and bit 31 is part of the state.  Any lane count gives the
same CRC.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf2

# Lanes of the plain scan on the CPU, a Python loop of ``seg`` steps
# over [K, LANES] tensors: 64 KiB rows take 2 steps.  The kernel K4 takes
# its own count (``kernel_lanes``); any count gives the same CRC.
LANES = 32768
# K4 runs one CTA of 512 threads a lane, one CTA an SM (its tables fill
# 136 KB of shared memory): a lane is at least MIN_SEG bytes, so that a
# CTA's set-up and fold stay small beside its loads.
MIN_SEG = 64 << 10

_TABLE = torch.from_numpy(gf2.CRC_TABLE.astype(np.int64))
_BITS = torch.arange(32, dtype=torch.int64)

# (lanes, seg, device) -> [lanes, 32] lane-combine bank;
# (max_bits, device) -> [max_bits, 32] unwind bank; (device,) -> the
# bit positions 0..31; (padded_n, "init") -> init 1 shifted past
# padded_n zero bytes.  Kept, so that a call copies nothing from the
# host (each copy would wait for the card's queue).
_BANKS: dict = {}


def lane_layout(n: int, lanes: int) -> tuple[int, int]:
    """(lanes, seg) of an N-byte row: at most one lane per byte, and
    seg = ceil(N / lanes) bytes per lane (the last lanes read zeros)."""
    lanes = max(1, min(lanes, n))
    return lanes, -(-n // lanes)


def kernel_lanes(n: int, k: int, sms: int) -> int:
    """K4's lane count for K rows of N bytes on a card of ``sms`` SMs:
    about one CTA an SM over all rows (sms // K lanes a row, at least 1)
    and no lane shorter than MIN_SEG bytes, before ``lane_layout``'s cap.
    8 rows of 16 MiB on 132 SMs: 16 lanes of 1 MiB, 128 CTAs; one such
    row: 132 lanes."""
    want = min(max(1, sms // max(1, k)), max(1, -(-n // MIN_SEG)))
    return lane_layout(n, want)[0]


def crc_lane_scan(rows: torch.Tensor, lengths: torch.Tensor, lanes: int) -> torch.Tensor:
    """Lane CRC states with init 0: rows [K, N] uint8, lengths [K] int32
    -> [K, lanes'] int64, lanes' and seg from ``lane_layout``.  Lane l
    owns bytes [l*seg, (l+1)*seg) of row k cut to lengths[k] and padded
    with zeros to lanes' * seg; every byte there, padding included, is
    one table step."""
    k_dim, n = rows.shape
    lanes, seg = lane_layout(n, lanes)
    pos = torch.arange(n, device=rows.device)
    x = torch.zeros((k_dim, lanes * seg), dtype=torch.int64, device=rows.device)
    x[:, :n] = torch.where(pos < lengths[:, None], rows, 0)
    x = x.view(k_dim, lanes, seg)
    table = _TABLE.to(rows.device)
    crc = torch.zeros((k_dim, lanes), dtype=torch.int64, device=rows.device)
    for s in range(seg):
        crc = table[(crc ^ x[:, :, s]) & 0xFF] ^ (crc >> 8)
    return crc


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over ``dim`` by log-step halving."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        folded = x[..., :half] ^ x[..., half : 2 * half]
        if n % 2:
            folded[..., 0] ^= x[..., n - 1]
        x, n = folded, half
    return x[..., 0]


def _apply_bank(bank: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply 32x32 GF(2) matrices (``bank`` [..., 32] int64 columns,
    broadcast against v[..., None]) to the states v [...]."""
    bits = (v[..., None] >> _bank((), lambda: _BITS.to(v.device), v.device)) & 1
    return _xor_reduce(torch.where(bits.bool(), bank, 0), -1)


def _lane_combine_bank(lanes: int, seg: int, device="cpu") -> torch.Tensor:
    """[lanes, 32] int64: row l = Z**(seg * (lanes-1-l)), the shift past
    the bytes after lane l.  Powers by doubling on ``device``: ~log2(lanes)
    batched products instead of one product per lane."""
    step = torch.from_numpy(gf2.shift_matrix(seg).astype(np.int64)).to(device)
    pw = torch.from_numpy(gf2.matrix_of(lambda v: v).astype(np.int64)).to(device)[None]
    while pw.shape[0] < lanes:  # pw[j] = Z**(seg*j); step = Z**(seg * len(pw))
        pw = torch.cat([pw, _apply_bank(step, pw)])
        step = _apply_bank(step, step)
    return pw[:lanes].flip(0).contiguous()


def _bank(key: tuple, make, device) -> torch.Tensor:
    full = (*key, str(device))
    if full not in _BANKS:
        bank = make()
        if isinstance(bank, torch.Tensor) and bank.is_cuda:
            # complete before another stream of the card reads it
            torch.cuda.current_stream(bank.device).synchronize()
        _BANKS[full] = bank
    return _BANKS[full]


def crc32_from_lanes(states: torch.Tensor, n: int, lengths: torch.Tensor) -> torch.Tensor:
    """CRC of each row data[k, :lengths[k]] from its lane states.

    states [K, L] int64 (``crc_lane_scan`` of the [K, N] rows, N = n,
    at these lengths), lengths [K] in [0, N].  Returns [K] int64 in
    [0, 2**32)."""
    lanes = states.shape[1]
    seg = -(-n // lanes) if n else 0
    padded_n = lanes * seg
    dev = states.device
    comb = _bank((lanes, seg), lambda: _lane_combine_bank(lanes, seg, dev), dev)
    merged = _xor_reduce(_apply_bank(comb, states), 1)
    # init 1 shifted past every padded byte is a constant
    crc = merged ^ _bank((padded_n,), lambda: gf2._apply(gf2.shift_matrix(padded_n), 1), "init")
    pad = padded_n - lengths.long().clamp(0, padded_n)
    max_bits = max(1, padded_n.bit_length())
    unwind = _bank(
        (max_bits,),
        lambda: torch.from_numpy(gf2.unshift_pow2_bank(max_bits).astype(np.int64)).to(dev),
        dev,
    )
    # one copy of the pads to the host, then a step only for a bit that
    # some row's pad has (rows of full length have none)
    bits = 0
    for p in pad.tolist():
        bits |= p
    for j in range(max_bits):
        if (bits >> j) & 1:
            hit = ((pad >> j) & 1).bool()
            crc = torch.where(hit, _apply_bank(unwind[j], crc), crc)
    return crc


def crc32_batch(data: torch.Tensor, lengths: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """CRC32 of each row data[k, :lengths[k]], plain PyTorch.

    data [K, N] uint8 (bytes past each length are ignored); lengths [K]
    int32, clamped to [0, N].  Returns [K] int64 in [0, 2**32)."""
    lengths = lengths.clamp(0, data.shape[1])
    return crc32_from_lanes(crc_lane_scan(data, lengths, lanes), data.shape[1], lengths)
