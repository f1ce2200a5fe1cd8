"""LZP encode/decode on the card: wrappers of the CUDA kernels K5/K6.

``lzp_encode`` launches K5 and ``lzp_decode`` launches K6
(``csrc/lzp_kernels.cu``; they replace the Pallas kernels of the JAX
package's ``ops/device/lzp_pallas.py``).  Each wrapper checks dtype,
shape and contiguity, allocates its outputs with ``torch.empty`` and
the rows' hash tables with ``torch.zeros``, launches on the current
stream, raises if the launch was refused and adds one to its count in
``LAUNCHES``.  A tensor on the CPU takes the plain version (``lzp.py``);
any other device raises.

Outputs past a row's length, and whole rows that report -1, are left
unwritten or partly written.

A caller that passes ``stats`` (a [K, 5] int32 tensor on the card) gets
each row's counters of the kernel's windows of 32 positions: K5
[windows, events, extension steps, matches, us], K6 [windows, events,
windows that read the table, copy steps, us], us being the row's own
time in microseconds.  The plain version counts
nothing, so ``stats`` with CPU tensors raises.
"""

from __future__ import annotations

import torch

from . import lzp
from .launch import I32, I64, P, check, count, entry, raise_on, reset, route

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"lzp_encode": 0, "lzp_decode": 0}


def reset_launches() -> None:
    reset(LAUNCHES)


STATS = 5  # counters a row


def _luts(k: int, device) -> torch.Tensor:
    return torch.zeros((k, 1 << lzp.LZP_BITS), dtype=torch.int32, device=device)


def _stats_ptr(stats: torch.Tensor | None, k: int, where: str) -> int | None:
    if stats is None:
        return None
    check(stats, "stats", torch.int32, 2)
    if where == "cpu" or stats.device.type != "cuda" or tuple(stats.shape) != (k, STATS):
        raise ValueError(f"stats must be a [{k}, {STATS}] int32 tensor on the card")
    return stats.data_ptr()


def lzp_encode(data: torch.Tensor, lengths: torch.Tensor, stats: torch.Tensor | None = None):
    """K5: LZP-encode each row data[k, :lengths[k]] (``lzp.lzp_encode_batch``).

    data [K, N] uint8, lengths [K] int32.  Returns (out [K, N + OUT_PAD]
    uint8, out_lens [K] int32), -1 where LZP does not apply or would not
    shrink the row."""
    check(data, "data", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    k, n = data.shape
    if lengths.shape[0] != k:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, data {k}")
    where = route(data, lengths)
    sp = _stats_ptr(stats, k, where)
    if where == "cpu":
        return lzp.lzp_encode_batch(data, lengths)
    w = n + lzp.OUT_PAD
    out = torch.empty((k, w), dtype=torch.uint8, device=data.device)
    out_lens = torch.empty((k,), dtype=torch.int32, device=data.device)
    if k:
        luts = _luts(k, data.device)
        with torch.cuda.device(data.device):
            rc = entry("bz3t_lzp_encode", [P, I64, I64, P, P, I64, P, P, P, I32, P])(
                data.data_ptr(), n, n, lengths.data_ptr(), out.data_ptr(), w,
                luts.data_ptr(), out_lens.data_ptr(), sp, k,
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(rc, "lzp_encode")
        count(LAUNCHES, "lzp_encode")
    return out, out_lens


def lzp_decode(data: torch.Tensor, in_lens: torch.Tensor, max_out: int,
               stats: torch.Tensor | None = None):
    """K6: LZP-decode each row data[k, :in_lens[k]] to at most max_out
    bytes (``lzp.lzp_decode_batch``).

    data [K, M] uint8, in_lens [K] int32, max_out >= 4.  Returns (out
    [K, max_out] uint8, out_lens [K] int32), -1 for a stream under 4
    bytes (a row of length 0 reads nothing) or a truncated one."""
    check(data, "data", torch.uint8, 2)
    check(in_lens, "in_lens", torch.int32, 1)
    k, m = data.shape
    if in_lens.shape[0] != k:
        raise ValueError(f"in_lens has {in_lens.shape[0]} rows, data {k}")
    if max_out < 4:
        raise ValueError(f"max_out must be at least 4, got {max_out}")
    where = route(data, in_lens)
    sp = _stats_ptr(stats, k, where)
    if where == "cpu":
        return lzp.lzp_decode_batch(data, in_lens, max_out)
    out = torch.empty((k, max_out), dtype=torch.uint8, device=data.device)
    out_lens = torch.empty((k,), dtype=torch.int32, device=data.device)
    if k:
        luts = _luts(k, data.device)
        with torch.cuda.device(data.device):
            rc = entry("bz3t_lzp_decode", [P, I64, I64, P, P, I64, I32, P, P, P, I32, P])(
                data.data_ptr(), m, m, in_lens.data_ptr(), out.data_ptr(), max_out, max_out,
                luts.data_ptr(), out_lens.data_ptr(), sp, k,
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(rc, "lzp_decode")
        count(LAUNCHES, "lzp_decode")
    return out, out_lens
