"""CM encode/decode on the card: wrappers of the CUDA kernels K1/K2.

``cm_encode`` launches K1 and ``cm_decode`` launches K2
(``csrc/cm_kernels.cu``; they replace the Pallas kernels of the JAX
package's ``ops/device/cm_pallas.py``).  Each wrapper checks device,
dtype, shape and contiguity, allocates its outputs with ``torch.empty``,
launches on the current stream, raises if the launch was refused and
adds one to its count in ``LAUNCHES``.  A tensor on the CPU takes the
plain PyTorch version (``cm.py``); any other device raises.

Outputs past a row's length are left unwritten (``torch.empty``).
"""

from __future__ import annotations

import torch

from . import cm
from .launch import I32, I64, P, check, entry, raise_on, route, rows16

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"cm_encode": 0, "cm_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cm_encode(data: torch.Tensor, lengths: torch.Tensor, out_width: int | None = None):
    """K1: CM-encode each row data[k, :lengths[k]] with a fresh model.

    data [K, N] uint8, lengths [K] int32.  Returns (out [K, W] uint8,
    out_lens [K] int32), W = ``out_width`` or N + N//8 + 64.  A row whose
    payload exceeds W reports its true length; its bytes past W are
    not written.
    """
    check(data, "data", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    k, n = data.shape
    if lengths.shape[0] != k:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, data {k}")
    if route(data, lengths) == "cpu":
        return cm.cm_encode_batch(data, lengths, out_width)
    w = out_width if out_width is not None else n + n // 8 + 64
    out = torch.empty((k, w), dtype=torch.uint8, device=data.device)
    out_lens = torch.empty((k,), dtype=torch.int32, device=data.device)
    if k == 0:
        return out, out_lens
    src = rows16(data)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry("bz3t_cm_encode", [P, I64, I64, P, P, I64, I32, P, I32, P])(
            src.data_ptr(), src.shape[1], n, lengths.data_ptr(), out.data_ptr(), w, w,
            out_lens.data_ptr(), k, stream,
        )
    raise_on(rc, "cm_encode")
    LAUNCHES["cm_encode"] += 1
    return out, out_lens


def cm_decode(
    payload: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor, out_width: int
) -> torch.Tensor:
    """K2: decode out_lens[k] bytes from each row of payload [K, M] uint8.

    Input past in_lens[k] reads as exhausted (``(code << 8) - 1``).
    Returns [K, out_width] uint8; bytes past out_lens[k] are not written.
    """
    check(payload, "payload", torch.uint8, 2)
    check(in_lens, "in_lens", torch.int32, 1)
    check(out_lens, "out_lens", torch.int32, 1)
    k = payload.shape[0]
    if in_lens.shape[0] != k or out_lens.shape[0] != k:
        raise ValueError("in_lens/out_lens must have one entry per payload row")
    if route(payload, in_lens, out_lens) == "cpu":
        return cm.cm_decode_batch(payload, in_lens, out_lens, out_width)
    out = torch.empty((k, out_width), dtype=torch.uint8, device=payload.device)
    if k == 0:
        return out
    src = rows16(payload)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry("bz3t_cm_decode", [P, I64, I64, P, P, P, I64, I32, P])(
            src.data_ptr(), src.shape[1], payload.shape[1], in_lens.data_ptr(),
            out_lens.data_ptr(), out.data_ptr(), out_width, k, stream,
        )
    raise_on(rc, "cm_decode")
    LAUNCHES["cm_decode"] += 1
    return out
