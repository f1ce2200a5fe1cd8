"""Batched mRLE as PyTorch tensor code (counterpart of the JAX package's
``ops/device/rle.py``; reference mrlec/mrled, src/libbz3.c:259-329).

Encode: runs from a segmented ``cummax``, the per-byte-value gain
histogram from one ``scatter_add_``, then each output position finds
its source run by a batched ``searchsorted`` over the prefix sum of the
runs' emitted lengths.

Decode: whether a byte is a run header, a literal, or a length /
continuation byte is a 2-state automaton (NORMAL / IN-LENGTH).  Each
byte's transition map on the two states packs into two bits (bit s is
the state after s), two such codes compose with a few uint8 shifts, and
a log-step (Hillis-Steele) prefix composition over the codes gives
every byte's state.  Run totals and the output gather are then again
parallel.

The JAX package has no Pallas kernel for RLE, so this is the port's
only version, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch


def _then(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Code of the map "g, then f" on the two states (uint8 codes)."""
    return ((f >> (g & 1)) & 1) | (((f >> (g >> 1)) & 1) << 1)


def rle_encode_batch(data: torch.Tensor, lengths: torch.Tensor, out_width: int | None = None):
    """mrlec of each row data[k, :lengths[k]].

    data [K, N] uint8, lengths [K] int32.  Returns (out [K, W] uint8,
    out_lens [K] int32), W = ``out_width`` (at least 32) or N + 64.  The
    stream is out[k, :out_lens[k]]; one that expands past W is cut at W
    while its length stays true, and a caller keeps the stage only when
    out_lens < lengths (src/libbz3.c:609-614).  An empty row emits the
    32-byte bitmap."""
    k_dim, n = data.shape
    w = out_width if out_width is not None else n + 64
    if w < 32:
        raise ValueError(f"out_width must hold the 32-byte bitmap, got {w}")
    dev = data.device
    lens = lengths.clamp(0, n)[:, None]
    if n == 0 or k_dim == 0:
        return torch.zeros((k_dim, w), dtype=torch.uint8, device=dev), torch.full(
            (k_dim,), 32, dtype=torch.int32, device=dev
        )
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    valid = pos < lens
    is_start = torch.ones_like(valid)
    is_start[:, 1:] = data[:, 1:] != data[:, :-1]
    is_start &= valid
    runpos = pos - torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    # Gains: +1 per repeat except every 255th, -1 per run start.
    gain = (valid & (runpos > 0) & (runpos % 255 != 0)).int() - is_start.int()
    del runpos
    gains = torch.zeros((k_dim, 256), dtype=torch.int32, device=dev)
    gains.scatter_add_(1, torch.where(valid, data, 0).long(), gain)
    del gain
    gate = gains > 0  # [K, 256]
    weights = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    bitmap = (gate.view(k_dim, 32, 8).int() * weights).sum(2).to(torch.uint8)

    # Per-run emission lengths; run slots padded to N.
    run_id = torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1
    run_start = torch.full((k_dim, n + 1), n, dtype=torch.int32, device=dev)
    run_start.scatter_(1, torch.where(is_start, run_id, n).long(), pos.expand(k_dim, n))
    del run_id, is_start, valid
    run_start = run_start[:, :n]
    run_end = torch.cat([run_start[:, 1:], torch.full_like(run_start[:, :1], n)], dim=1)
    run_len = (run_end.minimum(lens) - run_start.minimum(lens)).clamp(min=0)
    del run_end
    run_val = data.gather(1, run_start.clamp(max=n - 1).long())
    del run_start
    run_gated = gate.gather(1, run_val.long())
    cnt255 = (run_len - 1).clamp(min=0) // 255
    emit = torch.where(run_len > 0, torch.where(run_gated, 2 + cnt255, run_len), 0)
    csum = torch.cumsum(emit, dim=1, dtype=torch.int32)
    offsets = csum - emit
    total = csum[:, -1] + 32
    del emit

    # Output position o past the bitmap belongs to run searchsorted(csum, o, right).
    opos = torch.arange(w - 32, dtype=torch.int32, device=dev).expand(k_dim, w - 32).contiguous()
    rid = torch.searchsorted(csum, opos, right=True).clamp(max=n - 1)
    d = opos - offsets.gather(1, rid)
    r_val = run_val.gather(1, rid)
    r_len = run_len.gather(1, rid)
    gated_byte = torch.where(
        d == 0,
        r_val.int(),
        torch.where(d <= cnt255.gather(1, rid), 255, (r_len - 1).clamp(min=0) % 255),
    )
    body = torch.where(run_gated.gather(1, rid), gated_byte, r_val.int())
    body = torch.where(opos < (total - 32)[:, None], body, 0).to(torch.uint8)
    out = torch.cat([bitmap, body], dim=1)
    return out, total.int()


def rle_decode_batch(data: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor,
                     out_width: int):
    """mrled of each row data[k, :in_lens[k]] to out_lens[k] bytes.

    data [K, M] uint8, in_lens and out_lens [K] int32.  Returns (out
    [K, W] uint8, zero past min(out_lens, decoded length), and ok [K]
    bool), W = ``out_width``.  ok is False when the stream is shorter
    than the bitmap or expands to fewer than out_lens bytes (mrled's
    error return, src/libbz3.c:303-329)."""
    k_dim, m = data.shape
    dev = data.device
    if m < 32:  # the bitmap's columns must exist; no body byte lies below 32
        data = torch.cat([data, data.new_zeros((k_dim, 32 - m))], dim=1)
        m = 32
    w = out_width
    in_lens = in_lens.long()
    out_lens = out_lens.long()
    pos = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    body = (pos < in_lens[:, None]) & (pos >= 32)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    gate = ((data[:, :32, None] >> shifts) & 1).view(k_dim, 256).bool()
    byte_gated = gate.gather(1, data.long())

    # Transition code per byte: bit 0 = next state from NORMAL (a gated
    # byte starts a run), bit 1 = from IN-LENGTH (255 continues it).
    code = (body & byte_gated).to(torch.uint8) | ((body & (data == 255)).to(torch.uint8) << 1)
    d = 1
    while d < m:  # inclusive prefix composition, first byte's map applied first
        nxt = code.clone()
        nxt[:, d:] = _then(code[:, :-d], code[:, d:])
        code, d = nxt, d * 2
    state_after = code & 1  # from the initial NORMAL state
    state_before = torch.zeros_like(state_after)
    state_before[:, 1:] = state_after[:, :-1]
    del code, state_after

    normal = body & (state_before == 0)
    is_header = normal & byte_gated
    is_literal = normal & ~byte_gated
    is_term = body & (state_before == 1) & (data != 255)
    del normal, state_before, byte_gated

    # Each header's terminator is the next terminator after it.
    inf = m + 1
    term_idx = torch.where(is_term, pos, inf)
    nxt_term = torch.cummin(term_idx.flip(1), dim=1).values.flip(1)
    hdr_term = torch.full_like(nxt_term, inf)
    hdr_term[:, :-1] = nxt_term[:, 1:]
    del term_idx, nxt_term
    has_term = hdr_term <= in_lens[:, None] - 1
    term_byte = data.gather(1, hdr_term.clamp(max=m - 1)).long()
    c255 = (hdr_term - pos - 1).clamp(min=0)
    # A stream that ends inside a run's length: mrled adds 255 for each of
    # the k 255s, then the last one again as its terminator (255k + 256);
    # a header that is the stream's last byte runs 0 bytes.
    k_open = (in_lens[:, None] - 1 - pos).clamp(min=0)
    run_total = torch.where(has_term, 255 * c255 + term_byte + 1,
                            torch.where(k_open > 0, 255 * k_open + 256, 0))
    del hdr_term, has_term, term_byte, c255, k_open
    emit = torch.where(is_literal, 1, torch.where(is_header, run_total, 0))
    csum = torch.cumsum(emit, dim=1)  # through each position, inclusive
    total = csum[:, -1]
    del emit, run_total

    # Output position o comes from source index searchsorted(csum, o, right).
    opos = torch.arange(w, dtype=torch.int64, device=dev).expand(k_dim, w).contiguous()
    src = torch.searchsorted(csum, opos, right=True).clamp(max=m - 1)
    out = data.gather(1, src)
    out = torch.where(opos < torch.minimum(total, out_lens)[:, None], out, 0)
    ok = (in_lens >= 32) & (total >= out_lens)
    return out, ok
