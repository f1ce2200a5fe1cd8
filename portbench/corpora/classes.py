"""Class generators of the traffic's members.

Each class takes its parameters and a table seed and returns
``make(n, gen, device) -> uint8 tensor`` of at least ``n`` bytes, drawn
with ``gen`` in a few tensor calls.  Tables are built once on the host
with NumPy from the table seed and moved to the device on first use.
"""

from __future__ import annotations

import numpy as np
import torch


def _latin1(s: str) -> bytes:
    """A table string from JSON as bytes: code points 0-255 are bytes."""
    return s.encode("latin-1")


def _zipf(count: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, count + 1, dtype=np.float64) ** a
    return w / w.sum()


def _words(rng: np.random.Generator, spec: dict) -> list[bytes]:
    """``count`` random words of ``min_len``..``max_len`` symbols of
    ``alphabet`` (a string, or ``"bytes"`` for every byte value)."""
    alpha = spec.get("alphabet", "abcdefghijklmnopqrstuvwxyz")
    letters = (np.arange(256, dtype=np.uint8) if alpha == "bytes"
               else np.frombuffer(_latin1(alpha), np.uint8))
    lens = rng.integers(spec["min_len"], spec["max_len"] + 1, spec["count"])
    flat = rng.choice(letters, int(lens.sum()))
    ends = np.cumsum(lens)
    return [flat[e - n : e].tobytes() for e, n in zip(ends, lens)]


def _table(rng: np.random.Generator, spec: dict) -> tuple[list[bytes], np.ndarray]:
    """One field's strings and their probabilities: ``choices`` (strings,
    optionally ``weights``), ``numbers`` ([lo, hi] formatted by ``format``
    after division by ``div``), ``paths`` (URL paths of seeded words) or a
    ``literal``, each with an optional ``zipf`` exponent (else uniform or
    the weights)."""
    if "literal" in spec:
        return [_latin1(spec["literal"])], np.ones(1)
    if "choices" in spec:
        items = [_latin1(s) for s in spec["choices"]]
    elif "numbers" in spec:
        lo, hi = spec["numbers"]
        fmt, div = spec.get("format", "%d"), spec.get("div", 1)
        items = [(fmt % (v / div if div != 1 else v)).encode() for v in range(lo, hi + 1)]
    elif "paths" in spec:
        p = spec["paths"]
        words = _words(rng, p["words"])
        sufs = [_latin1(s) for s in p["suffixes"]]
        items = []
        for i in range(p["count"]):
            parts = rng.integers(0, len(words), int(rng.integers(p["parts"][0], p["parts"][1] + 1)))
            items.append(b"/" + b"/".join(words[j] for j in parts) + sufs[i % len(sufs)])
    else:
        raise ValueError(f"unknown table kind: {sorted(spec)}")
    pre, suf = _latin1(spec.get("prefix", "")), _latin1(spec.get("suffix", ""))
    items = [pre + s + suf for s in items]
    if "zipf" in spec:
        probs = _zipf(len(items), spec["zipf"])
    else:
        w = np.asarray(spec.get("weights", [1.0] * len(items)), np.float64)
        probs = w / w.sum()
    return items, probs


class _Pieces:
    """A table of byte strings (pieces) on the host, moved to a device on
    first use, and their concatenation by piece ids."""

    def __init__(self, items: list[bytes]):
        lens = np.array([len(s) for s in items], np.int64)
        self.host = (np.frombuffer(b"".join(items), np.uint8).copy(), lens,
                     np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64))
        self.on: dict[str, tuple] = {}

    def dev(self, device: torch.device):
        key = str(device)
        if key not in self.on:
            self.on[key] = tuple(torch.from_numpy(a).to(device) for a in self.host)
        return self.on[key]

    def join(self, ids: torch.Tensor, device: torch.device, where: bool = False):
        """The pieces ``ids`` (1-d) one after another, as uint8; with
        ``where`` also each byte's piece (its index in ``ids``) and its
        offset in that piece."""
        flat, lens, offs = self.dev(device)
        plen = lens[ids]
        total = int(plen.sum())
        which = torch.repeat_interleave(torch.arange(ids.numel(), device=device), plen,
                                        output_size=total)
        at = torch.arange(total, device=device) - (torch.cumsum(plen, 0) - plen)[which]
        out = flat[at + offs[ids][which]]
        return (out, which, at) if where else out


def _draw(cdf: torch.Tensor, k: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(k, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u * cdf[-1]).clamp_(max=cdf.numel() - 1)


def pieces(params: dict, table_seed: int):
    """Words of a seeded vocabulary (``words``: count, min_len, max_len,
    alphabet), Zipf-ranked (``zipf``), each followed by a separator drawn
    from ``seps`` ([string, weight] pairs): ``make_corpus``'s text.  With
    ``random`` ({share, min_len, max_len}), that share of the words is
    replaced by fresh random bytes (addresses and immediates of code)."""
    rng = np.random.default_rng(table_seed)
    words = _words(rng, params["words"])
    pw = _zipf(len(words), params.get("zipf", 1.0))
    seps = [_latin1(s) for s, _ in params["seps"]]
    ps = np.array([w for _, w in params["seps"]], np.float64)
    ps /= ps.sum()
    rnd = params.get("random")
    n_rnd = 0
    if rnd:
        # one piece a random length, its word's bytes drawn anew each time
        n_rnd = rnd["max_len"] - rnd["min_len"] + 1
        words += [b"\0" * n for n in range(rnd["min_len"], rnd["max_len"] + 1)]
        pw = np.concatenate((pw * (1 - rnd["share"]), np.full(n_rnd, rnd["share"] / n_rnd)))
    table = _Pieces([w + s for w in words for s in seps])
    word_len = torch.tensor([len(w) for w in words for _ in seps])
    joint = np.outer(pw, ps).ravel()
    mean = float((joint * table.host[1]).sum())
    first_rnd = (len(words) - n_rnd) * len(seps)
    cdfs: dict[str, tuple] = {}

    def make(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in cdfs:
            cdfs[key] = (torch.from_numpy(np.cumsum(joint)).to(device), word_len.to(device))
        cdf, wl = cdfs[key]
        k = int(n / mean * 1.05) + 64
        outs = []
        while sum(o.numel() for o in outs) < n:
            ids = _draw(cdf, k if not outs else k // 8 + 64, gen, device)
            if not n_rnd:
                outs.append(table.join(ids, device))
                continue
            out, which, at = table.join(ids, device, where=True)
            pid = ids[which]
            noise = torch.randint(0, 256, (out.numel(),), generator=gen, device=device,
                                  dtype=torch.uint8)
            outs.append(torch.where((pid >= first_rnd) & (at < wl[pid]), noise, out))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return make


def lines(params: dict, table_seed: int):
    """Lines of ``fields`` in a fixed order, each drawn from its own table
    (``_table``): ``log_corpus``'s access-log lines, or a database's
    records one a line."""
    rng = np.random.default_rng(table_seed)
    tables = [_table(rng, f) for f in params["fields"]]
    items, base = [], []
    for strs, _ in tables:
        base.append(len(items))
        items += strs
    table = _Pieces(items)
    mean = sum(float((p * np.array([len(s) for s in strs])).sum()) for strs, p in tables)
    cdfs: dict[str, list] = {}

    def make(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in cdfs:
            cdfs[key] = [torch.from_numpy(np.cumsum(p)).to(device) for _, p in tables]
        k = int(n / mean * 1.05) + 16
        cols = [_draw(c, k, gen, device) + b for c, b in zip(cdfs[key], base)]
        out = table.join(torch.stack(cols, 1).reshape(-1), device)
        while out.numel() < n:
            cols = [_draw(c, k // 8 + 16, gen, device) + b for c, b in zip(cdfs[key], base)]
            out = torch.cat((out, table.join(torch.stack(cols, 1).reshape(-1), device)))
        return out

    return make


def sparse(params: dict, table_seed: int):
    """Records of ``len`` [lo, hi) random non-zero bytes after gaps of
    ``gap`` [lo, hi) zero bytes: ``sparse_block``."""
    glo, ghi = params.get("gap", [100, 2000])
    rlo, rhi = params.get("len", [8, 64])

    def make(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
        k = int(n / ((glo + ghi) / 2 + (rlo + rhi) / 2) * 1.2) + 16
        gaps = torch.randint(glo, ghi, (k,), generator=gen, device=device)
        recs = torch.randint(rlo, rhi, (k,), generator=gen, device=device)
        starts = torch.cumsum(gaps + recs, 0) - recs
        total = int(starts[-1] + recs[-1])
        out = torch.zeros(max(n, total), dtype=torch.uint8, device=device)
        which = torch.repeat_interleave(torch.arange(k, device=device), recs)
        pos = torch.arange(which.numel(), device=device) - (torch.cumsum(recs, 0) - recs)[which]
        vals = torch.randint(1, 256, (which.numel(),), generator=gen, device=device,
                             dtype=torch.uint8)
        out[starts[which] + pos] = vals
        return out

    return make


_DTYPES = {"u8": torch.uint8, "i16": torch.int16, "i32": torch.int32, "f32": torch.float32,
           "f64": torch.float64}


def records(params: dict, table_seed: int):
    """Fixed-width binary records, one field after another, each a
    ``type`` (u8, i16, i32, f32, f64) drawn as ``seq`` (a running count
    from a random start), ``uniform`` [lo, hi], ``normal`` [mean, std]
    or ``choices``; or ``zeros`` bytes of padding."""
    fields = params["fields"]

    def width(f: dict) -> int:
        return f["zeros"] if "zeros" in f else torch.empty((), dtype=_DTYPES[f["type"]]).element_size()

    rec = sum(width(f) for f in fields)

    def make(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
        k = n // rec + 1
        cols = []
        for f in fields:
            if "zeros" in f:
                cols.append(torch.zeros((k, f["zeros"]), dtype=torch.uint8, device=device))
                continue
            dt = _DTYPES[f["type"]]
            if "seq" in f:
                start = int(torch.randint(0, 1 << 20, (1,), generator=gen, device=device))
                v = torch.arange(start, start + k, device=device, dtype=torch.float64)
            elif "uniform" in f:
                lo, hi = f["uniform"]
                v = lo + (hi - lo) * torch.rand(k, generator=gen, device=device, dtype=torch.float64)
            elif "normal" in f:
                m, s = f["normal"]
                v = m + s * torch.randn(k, generator=gen, device=device, dtype=torch.float64)
            else:
                ch = torch.tensor(f["choices"], dtype=torch.float64, device=device)
                v = ch[torch.randint(0, len(f["choices"]), (k,), generator=gen, device=device)]
            if not dt.is_floating_point:
                info = torch.iinfo(dt)
                v = v.round().clamp(info.min, info.max)
            cols.append(v.to(dt).contiguous().view(torch.uint8).reshape(k, -1))
        return torch.cat(cols, 1).reshape(-1)

    return make


def image(params: dict, table_seed: int):
    """Frames of ``height`` x ``width`` samples of ``bits`` bits, stored as
    little-endian 16-bit words: a sum of ``waves`` random plane waves
    over a random level, with Gaussian ``noise``."""
    w, h, bits = params["width"], params["height"], params["bits"]
    waves, noise = params.get("waves", 6), params.get("noise", 8.0)
    top = (1 << bits) - 1

    def make(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
        frames = -(-n // (2 * w * h))
        y = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        x = torch.arange(w, device=device, dtype=torch.float32)[None, :]
        out = []
        for _ in range(frames):
            par = torch.rand((waves, 4), generator=gen, device=device)
            level = top * (0.2 + 0.4 * par[0, 3])
            img = torch.full((h, w), float(level), device=device)
            for fx, fy, ph, amp in par:
                img += (top / (4 * waves)) * (1 + 3 * amp) * torch.sin(
                    6.2832 * (fx * x / 64 + fy * y / 64 + ph))
            img += noise * torch.randn((h, w), generator=gen, device=device)
            v = img.round().clamp(0, top).to(torch.int32).reshape(-1, 1)
            out.append(torch.cat((v & 255, v >> 8), 1).to(torch.uint8).reshape(-1))
        return torch.cat(out)

    return make
