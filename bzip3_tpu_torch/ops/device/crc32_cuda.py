"""CRC-32C on the card: the wrapper of the CUDA kernel K4.

``crc_lane_scan`` launches K4 (``csrc/crc32_kernels.cu``; it replaces
the Pallas lane scan of the JAX package's ``ops/device/crc32_pallas.py``)
for the lane states, and ``crc32_batch`` combines them and unwinds the
padding as tensor code (``crc32.crc32_from_lanes``), as the JAX
package's ``crc32_batch_auto`` does with its Pallas kernel.  K4 runs one
CTA a lane; ``crc32_batch`` picks its lane count from the rows and the
card's SM count (``crc32.kernel_lanes``).  A tensor on the CPU takes the
plain version (``crc32.crc_lane_scan``, at ``crc32.LANES`` lanes in
``crc32_batch``); any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import crc32, gf2
from .launch import I32, I64, P, check, count, entry, raise_on, reset, route, rows16

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"crc_lanes": 0}

# device -> the [32, 32] bank of Z**(2**k) that K4 reads; device -> SMs.
_POW2: dict = {}
_SMS: dict = {}


def reset_launches() -> None:
    reset(LAUNCHES)


def _pow2(device) -> torch.Tensor:
    if device not in _POW2:
        bank = torch.from_numpy(gf2.shift_pow2_bank(32).view(np.int32).copy()).to(device)
        torch.cuda.current_stream(device).synchronize()  # before another stream reads it
        _POW2[device] = bank
    return _POW2[device]


def lanes_for(rows: torch.Tensor) -> int:
    """The lane count ``crc32_batch`` gives K4 for ``rows`` [K, N] on the
    card (``crc32.kernel_lanes`` at its SM count), ``crc32.LANES`` on
    the CPU."""
    if rows.device.type != "cuda":
        return crc32.LANES
    dev = rows.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return crc32.kernel_lanes(rows.shape[1], rows.shape[0], _SMS[dev])


def smem_bytes() -> int:
    """Dynamic shared memory of one K4 CTA (its tables), in bytes."""
    return entry("bz3t_crc_smem_bytes", [], I32)()


def crc_lane_scan(rows: torch.Tensor, lengths: torch.Tensor, lanes: int) -> torch.Tensor:
    """K4: lane CRC states with init 0 (``crc32.crc_lane_scan``).

    rows [K, N] uint8, lengths [K] int32.  Returns [K, lanes'] int64 in
    [0, 2**32), lanes' from ``crc32.lane_layout(N, lanes)``.  Rows that
    are not 16-byte aligned, or whose width is not a multiple of 16, go
    to K4 through a zero-padded copy."""
    check(rows, "rows", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    k, n = rows.shape
    if lengths.shape[0] != k:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, data {k}")
    if route(rows, lengths) == "cpu":
        return crc32.crc_lane_scan(rows, lengths, lanes)
    lanes, seg = crc32.lane_layout(n, lanes)
    out = torch.empty((k, lanes), dtype=torch.int32, device=rows.device)
    if k:
        src = rows16(rows)
        with torch.cuda.device(rows.device):
            rc = entry("bz3t_crc_lanes", [P, I64, I64, P, I32, I64, P, P, I32, P])(
                src.data_ptr(), src.shape[1], n, lengths.data_ptr(), lanes, seg,
                _pow2(rows.device).data_ptr(), out.data_ptr(), k,
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(rc, "crc_lanes")
        count(LAUNCHES, "crc_lanes")
    return out.long() & 0xFFFFFFFF


def crc32_batch(data: torch.Tensor, lengths: torch.Tensor):
    """CRC32 of each row data[k, :lengths[k]] (K4 on the card, at
    ``lanes_for(data)`` lanes).

    data [K, N] uint8, lengths [K] int32 (clamped to [0, N]); bytes past
    a length are ignored.  Returns [K] int64 in [0, 2**32)."""
    check(data, "data", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    lengths = lengths.clamp(0, data.shape[1])
    states = crc_lane_scan(data, lengths, lanes_for(data))
    return crc32.crc32_from_lanes(states, data.shape[1], lengths)
