"""CM encode/decode on the card: wrappers of the CUDA kernels K1-K3c.

``cm_encode`` launches K1 and ``cm_decode`` launches K2
(``csrc/cm_kernels.cu``; they replace the Pallas kernels of the JAX
package's ``ops/device/cm_pallas.py``).  A row wider than one launch
chunk (the ``chunk_steps`` argument, else ``cm.default_chunk_steps()``:
16 Mi steps unless ``BZ3_TPU_CM_CHUNK_MI`` says otherwise), or any row under
``BZ3_TPU_CM_RESUME=1``, takes the resumable form instead, as in the
JAX package: ``cm_encode_resumable`` (K3a) and ``cm_decode_resumable``
(K3b) launch once per chunk of steps and carry each row's model and
registers between launches in a state buffer; ``cm_decode_stream`` (K3c)
yields each launch's output as its own piece.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and state with ``torch.empty``, launches on the current stream,
raises if a launch was refused and adds one to its count in
``LAUNCHES`` for each launch.  A tensor on the CPU takes the plain
PyTorch version (``cm.py``); any other device raises.

Outputs past a row's length are left unwritten (``torch.empty``).
"""

from __future__ import annotations

import os

import torch

from . import cm
from .launch import I32, I64, P, check, count, entry, raise_on, reset, route, rows16

# Kernel launches since the last reset, by kernel.
LAUNCHES = {
    "cm_encode": 0,
    "cm_decode": 0,
    "cm_encode_resume": 0,
    "cm_decode_resume": 0,
    "cm_decode_stream": 0,
}


def reset_launches() -> None:
    reset(LAUNCHES)


def _resumable(steps: int, chunk_steps: int) -> bool:
    """The JAX package's rule (cm_pallas.py:1286, :2042): rows wider than
    one launch chunk, or every row under ``BZ3_TPU_CM_RESUME=1``."""
    return steps > chunk_steps or os.environ.get("BZ3_TPU_CM_RESUME", "0") == "1"


def _chunk(chunk_steps: int | None) -> int:
    cs = cm.default_chunk_steps() if chunk_steps is None else chunk_steps
    if cs <= 0 or cs % 16:
        raise ValueError(f"chunk_steps must be a positive multiple of 16, got {cs}")
    return cs


def _check_encode(data: torch.Tensor, lengths: torch.Tensor) -> None:
    check(data, "data", torch.uint8, 2)
    check(lengths, "lengths", torch.int32, 1)
    if lengths.shape[0] != data.shape[0]:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, data {data.shape[0]}")


def _check_decode(payload: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor) -> None:
    check(payload, "payload", torch.uint8, 2)
    check(in_lens, "in_lens", torch.int32, 1)
    check(out_lens, "out_lens", torch.int32, 1)
    k = payload.shape[0]
    if in_lens.shape[0] != k or out_lens.shape[0] != k:
        raise ValueError("in_lens/out_lens must have one entry per payload row")


def _state(k: int, device) -> torch.Tensor:
    """Per-row state of the resumable kernels (tables, then registers);
    each row's first launch writes fresh tables."""
    n = entry("bz3t_cm_state_bytes", [], I64)()
    return torch.empty((k, n), dtype=torch.uint8, device=device)


def cm_encode(
    data: torch.Tensor,
    lengths: torch.Tensor,
    out_width: int | None = None,
    chunk_steps: int | None = None,
):
    """K1: CM-encode each row data[k, :lengths[k]] with a fresh model.

    data [K, N] uint8, lengths [K] int32.  Returns (out [K, W] uint8,
    out_lens [K] int32), W = ``out_width`` or N + N//8 + 64.  A row whose
    payload exceeds W reports its true length; its bytes past W are
    not written.  N past ``chunk_steps`` (default
    ``cm.default_chunk_steps()``) takes K3a in launches of that many steps.
    """
    _check_encode(data, lengths)
    k, n = data.shape
    cs = _chunk(chunk_steps)
    if _resumable(n, cs):
        return cm_encode_resumable(data, lengths, out_width, cs)
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
    count(LAUNCHES, "cm_encode")
    return out, out_lens


def cm_encode_resumable(
    data: torch.Tensor,
    lengths: torch.Tensor,
    out_width: int | None = None,
    chunk_steps: int | None = None,
):
    """K3a: ``cm_encode`` in launches of ``chunk_steps`` steps (a multiple
    of 16; default ``cm.default_chunk_steps()``), one per window of the
    N columns.  Same outputs as K1, byte for byte."""
    _check_encode(data, lengths)
    cs = _chunk(chunk_steps)
    if route(data, lengths) == "cpu":
        return cm.cm_encode_resumable(data, lengths, out_width, cs)
    k, n = data.shape
    w = out_width if out_width is not None else n + n // 8 + 64
    out = torch.empty((k, w), dtype=torch.uint8, device=data.device)
    out_lens = torch.empty((k,), dtype=torch.int32, device=data.device)
    if k == 0:
        return out, out_lens
    src = rows16(data)
    state = _state(k, data.device)
    launch = entry("bz3t_cm_encode_resume", [P, I64, I64, P, P, I64, I32, P, P, I32, I32, I32, P])
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s, e in cm.windows(n, cs):
            rc = launch(
                src.data_ptr(), src.shape[1], n, lengths.data_ptr(), out.data_ptr(), w, w,
                out_lens.data_ptr(), state.data_ptr(), s, e, k, stream,
            )
            raise_on(rc, "cm_encode_resume")
            count(LAUNCHES, "cm_encode_resume")
    return out, out_lens


def cm_decode(
    payload: torch.Tensor,
    in_lens: torch.Tensor,
    out_lens: torch.Tensor,
    out_width: int,
    chunk_steps: int | None = None,
) -> torch.Tensor:
    """K2: decode out_lens[k] bytes from each row of payload [K, M] uint8.

    Input past in_lens[k] reads as exhausted (``(code << 8) - 1``).
    Returns [K, out_width] uint8; bytes past out_lens[k] are not written.
    An ``out_width`` past ``chunk_steps`` (default
    ``cm.default_chunk_steps()``) takes K3b in launches of that many steps.
    """
    _check_decode(payload, in_lens, out_lens)
    cs = _chunk(chunk_steps)
    if _resumable(out_width, cs):
        return cm_decode_resumable(payload, in_lens, out_lens, out_width, cs)
    if route(payload, in_lens, out_lens) == "cpu":
        return cm.cm_decode_batch(payload, in_lens, out_lens, out_width)
    k = payload.shape[0]
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
    count(LAUNCHES, "cm_decode")
    return out


def _decode_launches(payload, in_lens, out_lens, out_width: int, chunk_steps, rel: bool):
    """Launch K3b (one [K, out_width] output) or, with ``rel``, K3c (a new
    [K, stop - start] output a launch) window by window, yielding (start,
    output) after each launch."""
    k = payload.shape[0]
    key = "cm_decode_stream" if rel else "cm_decode_resume"
    src = rows16(payload)
    state = _state(k, payload.device)
    launch = entry("bz3t_cm_decode_resume", [P, I64, I64, P, P, I32, P, I64, I32, P, I32, I32, I32, P])
    out = None if rel else torch.empty((k, out_width), dtype=torch.uint8, device=payload.device)
    for s, e in cm.windows(out_width, chunk_steps):
        if rel:
            out = torch.empty((k, e - s), dtype=torch.uint8, device=payload.device)
        with torch.cuda.device(payload.device):
            rc = launch(
                src.data_ptr(), src.shape[1], payload.shape[1], in_lens.data_ptr(),
                out_lens.data_ptr(), out_width, out.data_ptr(), out.shape[1], int(rel),
                state.data_ptr(), s, e, k, torch.cuda.current_stream().cuda_stream,
            )
        raise_on(rc, key)
        count(LAUNCHES, key)
        yield s, out


def cm_decode_resumable(
    payload: torch.Tensor,
    in_lens: torch.Tensor,
    out_lens: torch.Tensor,
    out_width: int,
    chunk_steps: int | None = None,
) -> torch.Tensor:
    """K3b: ``cm_decode`` in launches of ``chunk_steps`` output steps (a
    multiple of 16; default ``cm.default_chunk_steps()``)."""
    _check_decode(payload, in_lens, out_lens)
    cs = _chunk(chunk_steps)
    if route(payload, in_lens, out_lens) == "cpu":
        return cm.cm_decode_resumable(payload, in_lens, out_lens, out_width, cs)
    if payload.shape[0] == 0:
        return torch.empty((0, out_width), dtype=torch.uint8, device=payload.device)
    out = None
    for _, out in _decode_launches(payload, in_lens, out_lens, out_width, cs, False):
        pass
    return out


def cm_decode_stream(
    payload: torch.Tensor,
    in_lens: torch.Tensor,
    out_lens: torch.Tensor,
    out_width: int,
    chunk_steps: int | None = None,
):
    """K3c: decode as ``cm_decode_resumable``, yielding (start, [K, stop -
    start] uint8) after each launch, so that the caller can copy one
    piece off the card while the next launch runs.  A piece lives on the
    current stream; bytes past a row's length are not written."""
    _check_decode(payload, in_lens, out_lens)
    cs = _chunk(chunk_steps)
    if route(payload, in_lens, out_lens) == "cpu":
        yield from cm.cm_decode_stream(payload, in_lens, out_lens, out_width, cs)
        return
    if payload.shape[0] == 0:
        for s, e in cm.windows(out_width, cs):
            yield s, torch.empty((0, e - s), dtype=torch.uint8, device=payload.device)
        return
    yield from _decode_launches(payload, in_lens, out_lens, out_width, cs, True)
