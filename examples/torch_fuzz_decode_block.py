#!/usr/bin/env python
"""Adversarial block-decode fuzzer for the PyTorch/CUDA port (the port's
counterpart of ``fuzz_decode_block.py``; cf. the reference's
examples/fuzz-decode-block.c).

Feeds attacker-controlled (orig_size, block) pairs into the port's block
decoder; the contract is the JAX harness's: either a clean Bz3Error or a
correct decode, never a crash, a hang or an out-of-bounds access.  On
the card the CUDA kernels see the damage (K4 and K2 through
``models/block_codec.py`` over ``ops/device/stages.py``; K2, the tensor
inverse BWT and, on the device-prepass route, K6, the tensor RLE and K4
through ``DeviceEngine.decode_blocks``), and every outcome must also
equal the native engine's:

- ``decode_block`` on the device against ``decode_block`` over the host
  C++ stages (``ops.native.STAGES``): the same bytes or the same code;
- batches of 1-8 blocks, damaged and intact mixed, through the default
  and the device-prepass ``DeviceEngine``: the same bytes or the same
  code as the pipeline over the host coder (``torch_harness``), and the
  same bytes, or an error too, from ``NativeEngine``; a
  ``torch.cuda.synchronize()`` after each batch must raise nothing;
- the same batches through the host-BWT hybrid, forced at 65 KiB by
  ``BZ3_TPU_MAX_DEVICE_BLOCK_MIB`` and ``BZ3_TPU_FORCE_OVERSIZE`` (K3c
  decodes the damaged rows; K3a encodes the intact blocks, held to the
  native engine's streams).

Inputs: the JAX harness's three attack classes from its seed (garbage,
bit-flipped and truncated copies of a 2,000-byte random block), then
damage aimed at the card (``aimed_cases``): the BWT index at 0, 1, the
size before the BWT and past it; LZP and RLE sizes at the bound and past
it; ``orig_size`` at 0, 64, the bound and past it; payloads shorter than,
as long as and longer than their padded width; flipped model bits; rows
of 0-2 bytes; and rows crafted to decode, through the CM coder and the
inverse BWT, into malformed or hostile LZP and RLE streams (truncated
tokens, long matches past ``max_out``, runs past the output).

    python examples/torch_fuzz_decode_block.py [seed|path] [iterations] [--device cpu] [--engine native]

``--engine native`` fuzzes the host C++ codec in place of the device
(the CPU lane at volume: the plain CM on the CPU costs ~0.1-0.2 ms a bit
step).

A path runs one AFL-style input (4 bytes of orig_size, then the block).
"""

from __future__ import annotations

import os
import struct
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_harness import (  # noqa: E402
    ReferenceEngine,
    check_batch,
    env,
    outcome,
    require,
    run_main,
    split_device,
    sync,
    trial,
)

from bzip3_tpu_torch import Bz3Codec  # noqa: E402
from bzip3_tpu_torch.container.bound import bound  # noqa: E402
from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine  # noqa: E402
from bzip3_tpu_torch.models.block_codec import decode_block, parse_block_header  # noqa: E402
from bzip3_tpu_torch.ops import native  # noqa: E402

BS = 65 * 1024
_S32 = struct.Struct("<i")


def encode(data: bytes) -> bytes:
    return native.encode_blocks([data])[0]


def jax_inputs(seed: int, iters: int) -> tuple[bytes, list[tuple[bytes, int]]]:
    """The JAX harness's inputs for ``seed``, draw for draw: (the valid
    block of its 2,000-byte seedling, [(block, orig_size)] x iters)."""
    rng = np.random.default_rng(seed)
    seedling = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    valid = encode(seedling)
    out = []
    for it in range(iters):
        mode = it % 3
        if mode == 0:  # pure garbage
            n = int(rng.integers(0, 200))
            block = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif mode == 1:  # bit-flipped valid block
            b = bytearray(valid)
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            block = bytes(b)
        else:  # truncated / extended valid block
            cut = int(rng.integers(0, len(valid) + 20))
            block = valid[:cut] + bytes(int(rng.integers(0, 16)))
        out.append((block, int(rng.integers(0, 3 * len(seedling)))))
    return valid, out


def seed_blocks() -> list[bytes]:
    """Sources of the valid blocks the aimed damage starts from: random
    bytes (no RLE, no LZP), log lines (RLE and LZP kept) and runs (RLE
    kept)."""
    rng = np.random.default_rng(7)
    rand = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    lines = b"".join(b"GET /index.html HTTP/1.1 200 " + str(i % 7).encode() * (i % 5 + 1)
                     + b"\n" for i in range(80))
    syms, lens = rng.integers(97, 100, 200), rng.integers(1, 30, 200)
    runs = b"".join(bytes([int(c)]) * int(n) for c, n in zip(syms, lens))
    return [rand, lines, runs]


def _with(block: bytes, off: int, value: int) -> bytes:
    b = bytearray(block)
    _S32.pack_into(b, off, value)
    return bytes(b)


def crafted(row: bytes, model: int, orig_size: int, bnd: int) -> tuple[bytes, int]:
    """A block whose CM payload and BWT index decode exactly to ``row``,
    with ``model``'s stages to run on it: the LZP and RLE decoders meet
    ``row`` as it is.  Where the host stages decode it, the block's CRC
    and ``orig_size`` are the decoded bytes', so the block is valid."""
    st = native.STAGES
    u, idx = st.bwt_forward(row)
    mid = st.lzp_decode(row, bnd) if model & 2 else row
    y = st.rle_decode(mid, orig_size) if model & 4 and mid is not None else mid
    crc = st.crc32(y) if y is not None else 0x5EED
    if y is not None and not model & 4:
        orig_size = len(y)
    head = struct.pack("<Ii", crc, idx) + bytes([model])
    if model & 2:
        head += _S32.pack(len(row))
    if model & 4:
        head += _S32.pack(len(mid) if mid is not None else 32)
    return head + st.cm_encode(u), orig_size


def lzp_rows() -> list[bytes]:
    """LZP streams for the decoder: an encoder's stream cut right after
    its first 0xF2 bytes and inside a long match's run of 254s, streams
    shorter than the 4-byte context, arbitrary streams of 0xF2, 254, 255
    and two letters, and a match that runs far past the output bound."""
    text = b"".join(b"the quick brown fox jumps over the lazy dog %d; " % (i % 3)
                    for i in range(60))
    enc = native.STAGES.lzp_encode(text)
    out = [enc] if enc else []
    if enc:
        out += [enc[: j + 1] for j in range(4, len(enc)) if enc[j] == 0xF2][:3]
        k = enc.find(bytes([0xF2, 254]), 4)
        if k >= 0:
            out.append(enc[: k + 2])
    rng = np.random.default_rng(44)
    alphabet = np.array([0xF2, 254, 255, 0x61, 0x62], np.uint8)
    out += [bytes(rng.choice(alphabet, n)) for n in (1, 3, 4, 40, 300, 1000)]
    # "aaaa" twice (the slot of its hash is set), then one match of
    # 40 + 254 * 300 bytes: past bound(BS) and past the block's width
    out.append(b"aaaaaaaa" + bytes([0xF2]) + bytes([254]) * 300 + b"\x00")
    return out


def rle_rows() -> list[bytes]:
    """RLE streams: shorter than the 32-byte gate map, runs past the
    output, a stream that ends inside a run's length, random gates."""
    rng = np.random.default_rng(45)
    gate_all = b"\xff" * 32
    out = [b"\x01" * 31, gate_all, gate_all + b"a", gate_all + b"a" + b"\xff" * 40,
           gate_all + b"ab" * 50, gate_all + b"a\xff\xff\xff\x07"]
    out += [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (32, 33, 100, 1000)]
    return out


def aimed_cases(bs: int = BS) -> list[tuple[bytes, int]]:
    """(block, orig_size) pairs of damage aimed at the card's kernels and
    tensor code; see the module docstring."""
    bnd = bound(bs)
    cases = []
    for data in seed_blocks():
        v = encode(data)
        n = len(data)
        hdr = parse_block_header(v)
        sbb = hdr.lzp_size if hdr.model & 2 else hdr.rle_size if hdr.model & 4 else n
        hs = hdr.header_size()
        pay = v[hs:]
        for idx in (0, 1, sbb - 1, sbb, sbb + 1, -2, 2**31 - 1):
            cases.append((_with(v, 4, idx), n))
        off = 9
        for bit in (2, 4):
            if hdr.model & bit:
                for size in (0, 1, 4, 32, sbb - 1, sbb + 1, bs, bnd, bnd + 1, -5):
                    cases.append((_with(v, off, size), n))
                off += 4
        for osize in (0, 1, 63, 64, 65, n - 1, n + 1, bs, bnd, bnd + 1):
            cases.append((v, osize))
        w = -(-len(pay) // 16) * 16
        for p in (b"", pay[:1], pay[:15], pay[:16], pay[: len(pay) // 16 * 16], pay[:-1],
                  pay + bytes(w - len(pay)), pay + bytes(w - len(pay) + 16), pay + bytes(256)):
            cases.append((v[:hs] + p, n))
        for flip in (2, 4, 6, 1, 0x80):
            b = bytearray(v)
            b[8] ^= flip
            cases.append((bytes(b), n))
    for row in lzp_rows():
        for model in (2, 6):
            cases.append(crafted(row, model, 2 * len(row) + 64, bnd))
    for row in rle_rows():
        for osize in (0, 64, 4 * len(row), bs):
            cases.append(crafted(row, 4, osize, bnd))
    for row in (b"", b"a", b"ab"):
        u, _ = native.STAGES.bwt_forward(row)
        pay = native.STAGES.cm_encode(u)
        for idx in (0, 1, 2, 3):
            head = struct.pack("<Ii", native.STAGES.crc32(row), idx) + b"\x00"
            cases.append((head + pay, len(row)))
    return cases


def check_block(seed, index, block, osize, codec, device, stats) -> tuple:
    """``codec.decode_block`` held to the block codec over the host C++
    stages: the same bytes or the same error code."""
    got = outcome(codec.decode_block, block, osize)
    sync(device)
    want = outcome(decode_block, block, osize, codec.block_size, native.STAGES)
    require(got == want, seed, index, f"decode_block: {got[0]} "
            f"{got[1] if got[0] == 'err' else len(got[1])} against the host stages' "
            f"{want[0]} {want[1] if want[0] == 'err' else len(want[1])}")
    stats[got[1] if got[0] == "err" else "ok"] += 1
    return got


def batches(rng, cases: list, intact: list, max_k: int = 8) -> list[list[tuple[bytes, int]]]:
    """``cases`` cut into batches of 1-``max_k`` blocks, each damaged
    block with a chance of an intact block before it while the batch has
    room."""
    out, i = [], 0
    while i < len(cases):
        chunk = cases[i : i + int(rng.integers(1, max_k + 1))]
        batch = []
        for j, case in enumerate(chunk):
            if len(batch) + len(chunk) - j < max_k and rng.random() < 0.35:
                batch.append(intact[int(rng.integers(0, len(intact)))])
            batch.append(case)
        out.append(batch)
        i += len(chunk)
    return out


# The forcing variables that send a 65 KiB block to the host-BWT hybrid
# (K3a encodes, K3c decodes) on any device, as the tests rehearse it.
HYBRID_ENV = {"BZ3_TPU_MAX_DEVICE_BLOCK_MIB": "0.0005", "BZ3_TPU_FORCE_OVERSIZE": "1"}
ROUTES = ("default", "prepass", "hybrid")


def route_env(route: str):
    return env(**(HYBRID_ENV if route == "hybrid" else dict.fromkeys(HYBRID_ENV)))


def run(seed: int = 0, iters: int = 300, device="cuda", aimed: bool = True,
        routes=ROUTES, engine: str = "device", log=print) -> dict:
    """The fuzz campaign: ``iters`` JAX-harness inputs of ``seed`` and the
    aimed cases through ``Bz3Codec.decode_block`` on ``device``, then all
    of them in batches through each of ``routes``: the default pipeline,
    the device prepass and the forced host-BWT hybrid (whose encode of the
    intact blocks, K3a, must give the native engine's streams).  Returns
    the counts.  ``engine="native"`` fuzzes the host C++ instead (the
    block codec over its stages, and ``NativeEngine`` in batches held to
    the pipeline's bytes): the CPU lane at volume."""
    if engine == "native":
        codec, routes = Bz3Codec(BS, engine=native.STAGES), ("native",)
    else:
        codec = Bz3Codec(BS, device=device)
    valid, cases = jax_inputs(seed, iters)
    if aimed:
        cases += aimed_cases(BS)
    stats: Counter = Counter()
    for i, (block, osize) in enumerate(cases):
        trial(seed, i, check_block, seed, i, block, osize, codec, device, stats)
        if (i + 1) % 100 == 0:
            log(f"{i + 1}/{len(cases)} blocks ok")
    sources = seed_blocks()
    intact = [(valid, 2000)] + [(encode(d), len(d)) for d in sources]
    nat = NativeEngine(0)
    rng = np.random.default_rng(seed + 1)
    by_route: dict[str, Counter] = {}
    for route in routes:
        with route_env(route):
            eng = nat if route == "native" else DeviceEngine(
                device, device_prepass=route == "prepass", host_crc=True,
                device_crc_verify=False)
            ref = ReferenceEngine(device_prepass=route == "prepass")
            if route == "hybrid":
                got = eng.encode_blocks(sources, BS)
                sync(device)
                require(got == [b for b, _ in intact[1:]], seed, "hybrid encode",
                        "the forced hybrid's blocks differ from the native engine's")
            seen: Counter = Counter()
            for j, batch in enumerate(batches(rng, cases, intact)):
                where = f"{route} batch {j}"
                got = trial(seed, where, check_batch, seed, where, batch, BS, eng, ref, nat,
                            device)
                seen[got[1] if got[0] == "err" else "ok"] += 1
        by_route[route] = seen
        log(f"{route}: {sum(seen.values())} batches ok")
    return {"blocks": len(cases), "outcomes": dict(stats),
            "batches": {r: dict(c) for r, c in by_route.items()}}


def main() -> int:
    device, argv = split_device(sys.argv[1:])
    engine = "device"
    if "--engine" in argv:
        i = argv.index("--engine")
        engine = argv[i + 1]
        del argv[i : i + 2]
    arg = argv[0] if argv else "0"
    iters = int(argv[1]) if len(argv) > 1 else 300
    if os.path.exists(arg):
        raw = open(arg, "rb").read()
        osize = int.from_bytes(raw[:4], "little") % (2 * BS) if len(raw) >= 4 else 0
        trial(arg, 0, check_block, arg, 0, raw[4:], osize, Bz3Codec(BS, device=device),
              device, Counter())
        print("ok")
        return 0
    res = run(int(arg), iters, device, engine=engine)
    print(f"all ok: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(run_main(main))
