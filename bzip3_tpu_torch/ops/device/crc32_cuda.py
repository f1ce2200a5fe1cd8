"""CRC-32C on the card: the wrapper of the CUDA kernel K4.

``crc_lane_scan`` launches K4 (``csrc/crc32_kernels.cu``; it replaces
the Pallas lane scan of the JAX package's ``ops/device/crc32_pallas.py``)
for the lane states, and ``crc32_batch`` combines them and unwinds the
padding as tensor code (``crc32.crc32_from_lanes``), as the JAX
package's ``crc32_batch_auto`` does with its Pallas kernel.  A tensor on
the CPU takes the plain version (``crc32.crc_lane_scan``); any other
device raises.
"""

from __future__ import annotations

import torch

from . import crc32
from .launch import I32, I64, P, check, entry, raise_on, route

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"crc_lanes": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def crc_lane_scan(rows: torch.Tensor, lengths: torch.Tensor, lanes: int) -> torch.Tensor:
    """K4: lane CRC states with init 0 (``crc32.crc_lane_scan``).

    rows [K, N] uint8, lengths [K] int32.  Returns [K, lanes'] int64 in
    [0, 2**32), lanes' from ``crc32.lane_layout(N, lanes)``."""
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
        with torch.cuda.device(rows.device):
            rc = entry("bz3t_crc_lanes", [P, I64, I64, P, I32, I64, P, I32, P])(
                rows.data_ptr(), n, n, lengths.data_ptr(), lanes, seg, out.data_ptr(), k,
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(rc, "crc_lanes")
        LAUNCHES["crc_lanes"] += 1
    return out.long() & 0xFFFFFFFF


def crc32_batch(data: torch.Tensor, lengths: torch.Tensor, lanes: int = crc32.LANES):
    """CRC32 of each row data[k, :lengths[k]] (K4 on the card).

    data [K, N] uint8, lengths [K] int32 (clamped to [0, N]); bytes past
    a length are ignored.  Returns [K] int64 in [0, 2**32)."""
    check(lengths, "lengths", torch.int32, 1)
    lengths = lengths.clamp(0, data.shape[1])
    states = crc_lane_scan(data, lengths, lanes)
    return crc32.crc32_from_lanes(states, data.shape[1], lengths)
