"""The parallel CM encoder on the card: wrappers of the CUDA kernels P1
and P2 (``csrc/cm_parallel_kernels.cu``) and the row groups around it.

The JAX package writes its parallel encoder (``ops/device/cm_parallel.py``)
as XLA-level code, not Pallas; its two sequential loops (the window scans
of ``_chain_values_sorted``, the range coder's ``lax.scan`` over byte
steps) are hand kernels here because a Python loop of tensor calls would
take ~0.5 M and ~80 M launches at a 2 MiB row:

- ``chain_windows`` launches P1, one pass over every window of a sorted
  event stream in one of three modes (``cm_parallel.MODES``);
- ``range_pass`` launches P2, the range coder of each row over its
  precomputed split factors.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if
the launch was refused and adds one to its count in ``LAUNCHES``.  A
tensor on the CPU takes the plain version (``cm_parallel.py``); any other
device raises.

``cm_encode_parallel`` runs the encoder of ``cm_parallel.py``
(``cm_encode_parallel_batch``, over these wrappers) on groups of rows of
at most ``GROUP_BYTES`` of input each, since its event state is large.
"""

from __future__ import annotations

import torch

from . import cm_parallel
from .launch import I32, I64, P, check, count, entry, raise_on, reset, route

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"chain_windows": 0, "range_pass": 0}

# Input bytes of rows per group of cm_encode_parallel.  The peak device
# memory of one call is 988 bytes a byte of input at [16, 2 Mi] and
# 1,244 at [1, 2 Mi] (chip_smoke.py's main_parallel on an H100 80GB HBM3
# at 700 W): a group of 32 MiB peaks at ~33.2 GB, under ~40 GB of the
# card's 80 GB.
GROUP_BYTES = 32 << 20


def reset_launches() -> None:
    reset(LAUNCHES)


def chain_windows(ev: torch.Tensor, rate: int, mode: str, in0: torch.Tensor,
                  in1: torch.Tensor | None = None):
    """P1: one pass over every window of ``ev`` [K, seg, S] int32 (packed
    events, scan-major), as ``cm_parallel.chain_windows_plain``: ``pair``
    gives (x0, x1) [K, S], ``map`` [K, S, 2**rate], ``emit`` [K, seg, S]."""
    if mode not in cm_parallel.MODES:
        raise ValueError(f"mode must be one of {cm_parallel.MODES}, got {mode!r}")
    if rate not in (2, 4, 6):
        raise ValueError(f"rate must be 2, 4 or 6, got {rate}")
    check(ev, "ev", torch.int32, 3)
    check(in0, "in0", torch.int32, 2)
    k, seg, s = ev.shape
    ins = [in0] if mode != "pair" else [in0, in1]
    if mode == "pair":
        if in1 is None:
            raise ValueError("pair mode takes two entry tensors")
        check(in1, "in1", torch.int32, 2)
    for t in ins:
        if tuple(t.shape) != (k, s):
            raise ValueError(f"entries of shape {tuple(t.shape)}, want {(k, s)}")
    if route(ev, *ins) == "cpu":
        return cm_parallel.chain_windows_plain(ev, rate, mode, in0, in1)
    dev = ev.device
    if mode == "pair":
        outs = (torch.empty((k, s), dtype=torch.int32, device=dev),
                torch.empty((k, s), dtype=torch.int32, device=dev))
    elif mode == "map":
        outs = (torch.empty((k, s, 1 << rate), dtype=torch.int32, device=dev),)
    else:
        outs = (torch.empty((k, seg, s), dtype=torch.int32, device=dev),)
    if k * seg * s == 0:
        return outs if mode == "pair" else outs[0]
    with torch.cuda.device(dev):
        rc = entry("bz3t_chain_windows", [P, I64, I32, I32, I32, I32, P, P, P, P, P])(
            ev.data_ptr(), k, seg, s, rate, cm_parallel.MODES.index(mode), in0.data_ptr(),
            ins[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on(rc, "chain_windows")
    count(LAUNCHES, "chain_windows")
    return outs if mode == "pair" else outs[0]


def range_pass(words: torch.Tensor, lengths: torch.Tensor, out_width: int):
    """P2: the range coder of each row over words [K, 8N] int32 (split
    factor in bits 0-17, the bit in bit 31), 8 * lengths[k] bits a row, as
    ``cm_parallel.range_pass_plain``: (out [K, out_width] uint8, out_lens
    [K] int32).  A payload past out_width reports its true length; its
    bytes past out_width, and every byte past its length, are not
    written."""
    check(words, "words", torch.int32, 2)
    check(lengths, "lengths", torch.int32, 1)
    k, n8 = words.shape
    if lengths.shape[0] != k or n8 % 8:
        raise ValueError(f"words {tuple(words.shape)} and lengths {tuple(lengths.shape)}")
    if out_width < 0:
        raise ValueError(f"out_width must be >= 0, got {out_width}")
    if route(words, lengths) == "cpu":
        return cm_parallel.range_pass_plain(words, lengths, out_width)
    out = torch.empty((k, out_width), dtype=torch.uint8, device=words.device)
    out_lens = torch.empty((k,), dtype=torch.int32, device=words.device)
    if k == 0:
        return out, out_lens
    with torch.cuda.device(words.device):
        rc = entry("bz3t_range_pass", [P, I64, P, P, I64, I32, P, I32, P])(
            words.data_ptr(), n8, lengths.data_ptr(), out.data_ptr(), out_width, out_width,
            out_lens.data_ptr(), k, torch.cuda.current_stream().cuda_stream,
        )
    raise_on(rc, "range_pass")
    count(LAUNCHES, "range_pass")
    return out, out_lens


def cm_encode_parallel(u: torch.Tensor, lens: torch.Tensor, seg: int = 2048,
                       out_width: int | None = None, speculative: bool = True, timer=None):
    """``cm_encode_parallel_batch`` over consecutive groups of rows of at
    most ``GROUP_BYTES`` of input, N bytes a row and at least one row a
    group, concatenated: (out [K, W] uint8, out_lens [K] int32, ok [K]
    bool)."""
    k, n = u.shape
    rows = max(1, GROUP_BYTES // max(1, n))
    if k <= rows:
        return cm_parallel.cm_encode_parallel_batch(u, lens, seg, out_width, speculative,
                                                    timer=timer)
    parts = [
        cm_parallel.cm_encode_parallel_batch(u[s : s + rows], lens[s : s + rows], seg,
                                             out_width, speculative, timer=timer)
        for s in range(0, k, rows)
    ]
    return tuple(torch.cat(p) for p in zip(*parts))

