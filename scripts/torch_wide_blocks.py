#!/usr/bin/env python3
"""Blocks of 128 to 511 MiB on the card's wave path, and the working set
of the device BWT and of the device chain at those widths.

    python3 scripts/torch_wide_blocks.py [--mib 256 511] [--prepass] [--out FILE]
    python3 scripts/torch_wide_blocks.py --peaks [--checkout DIR ...] [--out FILE]

Round trips (the default): for each block size, as many blocks as one
wave of the port's pipeline holds on the card (``wave_rows`` and
``wave_bytes`` at the block's padded width), through ``compress_file`` /
``decompress_file`` in one batch, each size in a process of its own;
``--prepass`` runs them on the device chain (``device_prepass``, CRC,
RLE and LZP on the card, in the chain's row groups).  Each prints one
JSON line: the rows a wave, K3a/K3b launches (one wave: ceil(width / 16
Mi) each), the BWT, inverse and chain groups, stage times, peak device
memory (allocated and reserved), the host's peak RSS, MiB/s, and MiB/s
over the host-BWT hybrid's, which codes one block at a time whatever the
batch (``--hybrid-mib-s``, encode and decode; by default chip_smoke.py's
main_oversize at -b 144 on an NVIDIA H100 80GB HBM3 at 700 W).  The
blocks are text and log lines (chip_smoke.py's generators): 16 MiB
pieces of 8 text and 4 log bases, each piece under a byte map of its
own (b -> a * b + c mod 256, a odd), so no piece repeats inside a block
and no two blocks are alike.

``--peaks``: on one row of 256 MiB and one of 511 MiB, the forward and
inverse BWT alone through the ``ops/device/bwt.py`` of each
``--checkout`` (default: this one; loaded from its file, so a parent
unpacked under ``_checkouts/`` is measured beside the change in one
call), and this checkout's device chain (``pipeline.chain_rle`` then
``chain_lzp``, ``chain_unlzp`` then ``chain_unrle`` and the CRC, as the
pipeline runs a group of one row): seconds and peak bytes a byte of each
(``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` over
what was there before the call, its input row counted);
inverse(forward(x)) == x, and the chain's decode equal to its input with
its CRC.

Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import io
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MiB = 1 << 20
PIECE = 16 * MiB
# chip_smoke.py's main_oversize, one 144 MiB block through the hybrid
# (NVIDIA H100 80GB HBM3, 700.00 W): encode and decode MiB/s
HYBRID_MIB_S = (2.69, 1.60)


@functools.cache
def _bases() -> list[np.ndarray]:
    """The 12 base pieces: 8 of text, 4 of log lines."""
    import chip_smoke

    bases = [np.frombuffer(chip_smoke.corpus(8 * PIECE, seed=21), np.uint8),
             np.frombuffer(chip_smoke.log_corpus(4 * PIECE, seed=22), np.uint8)]
    return [b[i * PIECE : (i + 1) * PIECE] for b in bases for i in range(len(b) // PIECE)]


def wide_data(block_size: int, blocks: int) -> bytes:
    """``blocks`` blocks of ``block_size`` bytes of text and log lines."""
    bases = _bases()
    per = -(-block_size // PIECE)
    out = np.empty(blocks * block_size, np.uint8)
    ramp = np.arange(256, dtype=np.int64)
    for j in range(blocks):
        row = np.empty(per * PIECE, np.uint8)
        for i in range(per):
            t = j * per + i  # a byte map of its own: (a, c) distinct for t < 32,768
            lut = ((2 * (t % 128) + 1) * ramp + t // 128) % 256
            row[i * PIECE : (i + 1) * PIECE] = lut.astype(np.uint8)[bases[(i + j) % len(bases)]]
        out[j * block_size : (j + 1) * block_size] = row[:block_size]
    return out.tobytes()


def round_trip(mib: int, hybrid: tuple[float, float], prepass: bool) -> dict:
    import torch

    from bzip3_tpu_torch import compress_file, decompress_file
    from bzip3_tpu_torch.engines import DeviceEngine
    from bzip3_tpu_torch.ops.device import cm, cm_cuda
    from bzip3_tpu_torch.pipeline import (bwt_row_groups, chain_row_groups, inverse_row_groups,
                                          wave_bytes, wave_rows)

    bs = mib * MiB
    dev = torch.device("cuda", 0)
    width = -(-bs // 256) * 256
    rows = min(wave_rows([dev]), max(1, wave_bytes([dev], width, prepass) // width))
    t0 = time.perf_counter()
    data = wide_data(bs, rows)
    gen_s = time.perf_counter() - t0
    eng = DeviceEngine("cuda", profile=True, device_prepass=prepass)
    if eng._pipe(bs).oversize:
        raise RuntimeError(f"-b {mib} takes the host-BWT hybrid")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cm_cuda.reset_launches()
    t0 = time.perf_counter()
    comp = io.BytesIO()
    compress_file(io.BytesIO(data), comp, bs, engine=eng, batch_size=rows)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated()
    enc_res = torch.cuda.max_memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    back = io.BytesIO()
    decompress_file(io.BytesIO(comp.getvalue()), back, engine=eng, batch_size=rows)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    if back.getvalue() != data:
        raise RuntimeError(f"-b {mib}: the round trip differs")
    if eng.reencoded_rows:
        raise RuntimeError(f"-b {mib}: {eng.reencoded_rows} rows coded again")
    launches = dict(cm_cuda.LAUNCHES)
    # the rows' CM width: the widest post-prepass row, rounded up to 256
    want = -(-width // cm.default_chunk_steps())
    if not (0 < launches["cm_encode_resume"] <= want and
            launches["cm_encode_resume"] == launches["cm_decode_resume"]):
        raise RuntimeError(f"-b {mib}: launches {launches}, at most {want} each (one wave)")
    total = len(data) / MiB
    enc, dec = total / enc_s, total / dec_s
    return {
        "block_mib": mib, "prepass": prepass, "blocks": rows, "rows_a_wave": rows, "input_bytes": len(data),
        "compressed_bytes": len(comp.getvalue()), "ratio": len(comp.getvalue()) / len(data),
        "data_s": gen_s, "encode_s": enc_s, "decode_s": dec_s,
        "encode_mib_s": enc, "decode_mib_s": dec,
        "hybrid_mib_s": list(hybrid), "over_hybrid": [enc / hybrid[0], dec / hybrid[1]],
        "launches": launches, "reencoded_rows": eng.reencoded_rows,
        "bwt_group_rows": bwt_row_groups(rows, width, dev),
        "inverse_group_rows": inverse_row_groups(rows, width, dev),
        "chain_group_rows": chain_row_groups(rows, width, dev) if prepass else None,
        "peak_device_bytes": {"encode": enc_peak, "decode": torch.cuda.max_memory_allocated()},
        "peak_reserved_bytes": {"encode": enc_res, "decode": torch.cuda.max_memory_reserved()},
        "total_memory": torch.cuda.get_device_properties(dev).total_memory,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "cpu_count": os.cpu_count(),
        "stages_s": {k: round(v, 6) for k, v in eng.timer.totals.items()},
        "stage_calls": dict(eng.timer.counts),
    }


def _peaks(fn, n: int, what: str) -> tuple:
    from chip_smoke import device_peak

    res, sec, peak = device_peak(fn, n)
    return res, {f"{what}_s": sec, f"{what}_peak_bytes_a_byte": peak["allocated"],
                 f"{what}_peak_reserved_bytes_a_byte": peak["reserved"]}


def bwt_sizes(checkout: str, sizes=(256 * MiB, 511 * MiB)) -> dict:
    import torch

    path = os.path.join(os.path.abspath(checkout), "bzip3_tpu_torch", "ops", "device", "bwt.py")
    spec = importlib.util.spec_from_file_location("bwt_under_test", path)
    bwt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bwt)
    out = {"checkout": checkout}
    for n in sizes:
        x = torch.from_numpy(np.frombuffer(wide_data(n, 1), np.uint8).copy())[None].cuda()
        lens = torch.tensor([n], dtype=torch.int32).cuda()
        (u, idx), fwd = _peaks(lambda: bwt.bwt_forward_batch(x, lens), n, "forward")
        back, inv = _peaks(lambda: bwt.bwt_inverse_batch(u, lens, idx), n, "inverse")
        if not torch.equal(back, x):
            raise RuntimeError(f"{checkout}: inverse(forward(x)) != x at {n}")
        out[str(n)] = {**fwd, **inv}
        del x, u, idx, back
        torch.cuda.empty_cache()
    return out


def chain_sizes(sizes=(256 * MiB, 511 * MiB)) -> dict:
    """The device chain's encode (``pipeline.chain_rle``, ``chain_lzp``)
    and decode (``chain_unlzp``, ``chain_unrle``, K4) on one row of each
    size: seconds and peak bytes a byte of the row's padded width."""
    import torch

    from bzip3_tpu_torch.ops.device import crc32_cuda
    from bzip3_tpu_torch.pipeline import chain_lzp, chain_rle, chain_unlzp, chain_unrle
    from bzip3_tpu_torch.utils.profiling import StageTimer

    t = StageTimer(enabled=False)

    def encode(x, lens):
        cur, cur_lens, crc, _, use_rle = chain_rle(x, lens, t)
        cur, cur_lens, _, use_lzp = chain_lzp(cur, cur_lens, t)
        return cur, cur_lens, crc, use_lzp.int() * 2 + use_rle.int() * 4

    def decode(cur, cur_lens, model, lens, w):
        cur, cur_lens, ok = chain_unlzp(cur, cur_lens, model, w, t)
        final, final_lens, rle_ok = chain_unrle(cur, cur_lens, model, lens, w, t)
        return final, final_lens, crc32_cuda.crc32_batch(final, final_lens), ok & rle_ok

    out = {"checkout": ROOT}
    for n in sizes:
        w = -(-n // 256) * 256
        x = torch.zeros((1, w), dtype=torch.uint8, device="cuda")
        x[0, :n] = torch.from_numpy(np.frombuffer(wide_data(n, 1), np.uint8).copy()).cuda()
        lens = torch.tensor([n], dtype=torch.int32).cuda()
        (cur, cur_lens, crc, model), enc = _peaks(lambda: encode(x, lens), w, "encode")
        (final, final_lens, back_crc, ok), dec = _peaks(
            lambda: decode(cur, cur_lens, model, lens, w), w, "decode")
        if not (bool(ok[0]) and int(final_lens[0]) == n and torch.equal(final[0, :n], x[0, :n])
                and int(back_crc[0]) == int(crc[0])):
            raise RuntimeError(f"the device chain's round trip differs at {n}")
        out[str(n)] = {**enc, **dec, "model": int(model[0]), "kept_bytes": int(cur_lens[0])}
        del x, cur, final
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, nargs="+", default=[256, 511])
    ap.add_argument("--peaks", action="store_true")
    ap.add_argument("--prepass", action="store_true")
    ap.add_argument("--checkout", action="append")
    ap.add_argument("--hybrid-mib-s", type=float, nargs=2, default=HYBRID_MIB_S)
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)  # a size in this process
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_blocks: a CUDA card is needed", file=sys.stderr)
        return 2
    if args.one is not None:
        print(json.dumps(round_trip(args.one, tuple(args.hybrid_mib_s), args.prepass)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    lines = []
    if args.peaks:
        lines = [dict(bwt_sizes(c), part="bwt", card=card) for c in args.checkout or [ROOT]]
        lines.append(dict(chain_sizes(), part="chain", card=card))
        for line in lines:
            print(json.dumps(line), flush=True)
    else:
        for mib in args.mib:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", str(mib),
                                "--hybrid-mib-s", *map(str, args.hybrid_mib_s),
                                *(["--prepass"] if args.prepass else [])],
                               capture_output=True, text=True, cwd=ROOT, timeout=3000)
            if r.returncode != 0:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            line = dict(json.loads(r.stdout.strip().splitlines()[-1]), card=card)
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
