"""LZP pre-pass over a batch of rows: the plain version of the CUDA
kernels K5 (encode) and K6 (decode) in ``lzp_cuda``.

Semantics (reference src/libbz3.c:84-257; the JAX package's oracle
``ops/ref/lzp.py`` and Pallas kernels ``ops/device/lzp_pallas.py``): the
last 4 bytes, as a big-endian context, hash into an 18-bit table of
positions; a predicted match of at least 40 bytes becomes the token
0xF2 and a base-254 length, and a literal 0xF2 that meets a live
prediction is escaped as 0xF2 0xFF.  The encoder keeps three quirks
that shape the stream: the ``heur`` high-water mark of known
mismatches, word-granular extension plus 0..3 bytes, and the break out
of the base-254 length loop at ``out_cap``.

Each row runs as one serial state machine, here a Python loop per row
on the row's bytes: it gives the function, not the speed.
"""

from __future__ import annotations

import numpy as np
import torch

LZP_BITS = 18
LZP_MASK = (1 << LZP_BITS) - 1
MIN_MATCH = 40
MATCH = 0xF2
# Encoder output columns past the input width.  The encoder stops once
# its output reaches out_cap = n - 8, and a step that starts under it
# ends at most two bytes past it (a 254 length byte, then the last
# one), so a row never needs more than n bytes; the pad is a margin,
# and the kernel also guards every store.
OUT_PAD = 8


def _hash(ctx: int) -> int:
    return ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & LZP_MASK


def _ctx_at(buf, i: int) -> int:
    """Big-endian word of the 4 bytes before position i."""
    return buf[i - 1] | (buf[i - 2] << 8) | (buf[i - 3] << 16) | (buf[i - 4] << 24)


def encode_row(buf: bytes) -> bytes | None:
    """LZP stream of one row; None when the row is under 72 bytes or the
    output reaches out_cap = n - 8."""
    n = len(buf)
    if n < MIN_MATCH + 32:
        return None
    lut = [0] * (1 << LZP_BITS)
    out = bytearray(buf[:4])
    out_cap = n - 8
    scan_end = n - MIN_MATCH - 32
    i, ctx, heur = 4, _ctx_at(buf, 4), 0

    while i < scan_end and len(out) < out_cap:
        h = _hash(ctx)
        val, lut[h] = lut[h], i
        if val > 0:
            take = (
                buf[i + MIN_MATCH - 4 : i + MIN_MATCH] == buf[val + MIN_MATCH - 4 : val + MIN_MATCH]
                and buf[i : i + 4] == buf[val : val + 4]
                and not (heur > i and buf[heur : heur + 4] != buf[val + heur - i : val + heur - i + 4])
            )
            if take:
                ln = 4
                while i + ln < scan_end and buf[i + ln : i + ln + 4] == buf[val + ln : val + ln + 4]:
                    ln += 4
                if ln < MIN_MATCH:
                    heur = max(heur, i + ln)
                else:
                    for _ in range(3):
                        if buf[i + ln] == buf[val + ln]:
                            ln += 1
                    i += ln
                    ctx = _ctx_at(buf, i)
                    out.append(MATCH)
                    rem = ln - MIN_MATCH
                    while rem >= 254:
                        rem -= 254
                        out.append(254)
                        if len(out) >= out_cap:
                            break
                    out.append(rem)
                    continue
        b = buf[i]
        i += 1
        out.append(b)
        ctx = ((ctx << 8) | b) & 0xFFFFFFFF
        if b == MATCH and val > 0:
            out.append(255)

    ctx = _ctx_at(buf, i)
    while i < n and len(out) < out_cap:
        h = _hash(ctx)
        val, lut[h] = lut[h], i
        b = buf[i]
        i += 1
        out.append(b)
        ctx = ((ctx << 8) | b) & 0xFFFFFFFF
        if b == MATCH and val > 0:
            out.append(255)

    return None if len(out) >= out_cap else bytes(out)


def decode_row(data: bytes, max_out: int) -> bytes | None:
    """Inverse LZP of one row, at most max_out bytes (at least the first
    4); None on a stream under 4 bytes or a truncated token."""
    n = len(data)
    if n < 4:
        return None
    lut = [0] * (1 << LZP_BITS)
    out = bytearray(data[:4])
    ip = 4
    ctx = _ctx_at(out, 4)
    while ip < n and len(out) < max_out:
        h = _hash(ctx)
        val, lut[h] = lut[h], len(out)
        if data[ip] == MATCH and val > 0:
            ip += 1
            if ip == n:
                return None
            if data[ip] == 255:
                ip += 1
                out.append(MATCH)
                ctx = ((ctx << 8) | MATCH) & 0xFFFFFFFF
                continue
            ln = MIN_MATCH
            while True:
                if ip == n:
                    return None
                b = data[ip]
                ip += 1
                ln += b
                if b != 254:
                    break
            end = min(len(out) + ln, max_out)
            while len(out) < end:  # overlapping forward copy
                out.append(out[val])
                val += 1
            ctx = _ctx_at(out, len(out))
        else:
            b = data[ip]
            ip += 1
            out.append(b)
            ctx = ((ctx << 8) | b) & 0xFFFFFFFF
    return bytes(out)


def _rows(data: torch.Tensor, lengths: torch.Tensor):
    arr = data.cpu().numpy()
    lens = lengths.cpu().numpy().clip(0, data.shape[1])
    return [arr[k, : lens[k]].tobytes() for k in range(arr.shape[0])]


def _pack(results, k_dim: int, width: int, device):
    out = np.zeros((k_dim, width), np.uint8)
    out_lens = np.full(k_dim, -1, np.int32)
    for k, r in enumerate(results):
        if r is not None:
            out[k, : len(r)] = np.frombuffer(r, np.uint8)
            out_lens[k] = len(r)
    return torch.from_numpy(out).to(device), torch.from_numpy(out_lens).to(device)


def lzp_encode_batch(data: torch.Tensor, lengths: torch.Tensor):
    """LZP-encode each row data[k, :lengths[k]] (lengths clamped to [0, N]).

    data [K, N] uint8, lengths [K] int32.  Returns (out [K, N + OUT_PAD]
    uint8, out_lens [K] int32); -1 marks a row where LZP does not apply
    or would not shrink it.  Bytes past a row's length are 0."""
    k_dim, n = data.shape
    res = [encode_row(r) for r in _rows(data, lengths)]
    return _pack(res, k_dim, n + OUT_PAD, data.device)


def lzp_decode_batch(data: torch.Tensor, in_lens: torch.Tensor, max_out: int):
    """LZP-decode each row data[k, :in_lens[k]] to at most max_out bytes.

    data [K, M] uint8, in_lens [K] int32 (clamped to [0, M]), max_out
    >= 4.  Returns (out [K, max_out] uint8, out_lens [K] int32); -1 marks
    a stream under 4 bytes or a truncated one.  Bytes past a row's
    length are 0."""
    if max_out < 4:
        raise ValueError(f"max_out must be at least 4, got {max_out}")
    res = [decode_row(r, max_out) for r in _rows(data, in_lens)]
    return _pack(res, data.shape[0], max_out, data.device)
