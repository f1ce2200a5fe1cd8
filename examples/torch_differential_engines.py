#!/usr/bin/env python
"""Randomized cross-engine differential for the PyTorch/CUDA port (the
port's counterpart of ``differential_engines.py``): the port's
``DevicePipeline`` against its ``native`` and ``oracle`` engines.

Each trial draws a block size (66,560 or 131,072), 1-4 blocks of one of
the JAX file's seven data classes (random, runny, small alphabet,
repeated phrase, zeros, the <64-byte literal region, text) and runs
them through three routes of the pipeline on ``cuda`` (``--device cpu``
for the plain versions):

- ``default``: host pre-pass, K1, K2 and the tensor BWT;
- ``prepass``: the device chain (``device_prepass=True``: K4, the tensor
  RLE, K5, K6);
- ``parallel``: ``BZ3_TPU_CM=parallel`` (the parallel CM encoder, P1 and
  P2; K2 decodes).

Every route's stream must equal the native engine's byte for byte and
decode back to the input, and the native engine must decode it too.
The port's ``oracle`` engine (the block codec over the plain versions on
the CPU, ~0.1-0.2 ms a CM bit step there) encodes and decodes each block
whose CM row is at most ``--oracle-row`` bytes (default 2,048), the same
bytes again; larger rows are held to the oracle through the native
engine, which the CPU tests hold to the JAX package's numpy oracle.

Block sizes are two, so each route keeps one pipeline a size.  The JAX
file runs long campaigns as fresh-process chunks because XLA:CPU's JIT
section mappings accumulate per process; that does not hold here: the
port compiles nothing at run time beyond its one kernel library, so one
process runs any number of trials.

    python examples/torch_differential_engines.py [seed] [trials] [--device cpu] [--routes default,prepass,parallel] [--oracle-row N]

``--routes none`` holds the native engine to the oracle alone (the CPU
lane at volume: the device routes' plain CM costs ~0.1-0.2 ms a bit step
on the CPU).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_harness import (  # noqa: E402
    env,
    make_corpus,
    require,
    run_main,
    split_device,
    sync,
    trial,
)

from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine, OracleEngine  # noqa: E402
from bzip3_tpu_torch.models.block_codec import parse_block_header, size_before_bwt  # noqa: E402

ROUTES = ("default", "prepass", "parallel")
ORACLE_ROW = 2048


def make_data(rng) -> bytes:
    """One block's data: the JAX file's seven classes, draw for draw."""
    n = int(rng.integers(0, 130000))
    kind = int(rng.integers(0, 7))
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:  # runny
        if n == 0:
            return b""
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        fresh = rng.random(n) < 0.08
        fresh[0] = True
        return raw[np.maximum.accumulate(np.where(fresh, np.arange(n), 0))].tobytes()
    if kind == 2:
        return rng.integers(97, 97 + int(rng.integers(2, 9)), n, dtype=np.uint8).tobytes()
    if kind == 3:
        base = rng.integers(32, 127, int(rng.integers(3, 400)), dtype=np.uint8).tobytes()
        return (base * (n // max(1, len(base)) + 1))[:n]
    if kind == 4:
        return bytes(n)
    if kind == 5:  # literal-path boundary region
        return rng.integers(0, 256, int(rng.integers(0, 130)), dtype=np.uint8).tobytes()
    return make_corpus(n, seed=int(rng.integers(1 << 30)))


def trials(seed: int, n: int) -> list[tuple[int, list[bytes]]]:
    """(block size, blocks) of each trial, the JAX file's draws."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bs = 66560 if int(rng.integers(0, 2)) == 0 else 131072
        k = int(rng.integers(1, 5))
        out.append((bs, [make_data(rng)[:bs] for _ in range(k)]))
    return out


def route_env(route: str):
    return env(BZ3_TPU_CM="parallel" if route == "parallel" else None)


class Routes:
    """One ``DeviceEngine`` a route on ``device``, and the references."""

    def __init__(self, device, routes=ROUTES, oracle_row: int = ORACLE_ROW):
        self.device = device
        self.engines = {
            r: DeviceEngine(device, device_prepass=r == "prepass", host_crc=True,
                            device_crc_verify=False)
            for r in routes
        }
        self.nat = NativeEngine(0)
        self.oracle = OracleEngine()
        self.oracle_row = oracle_row
        self.oracle_blocks = 0


def one_trial(seed, index, bs: int, blocks: list[bytes], rt: Routes) -> None:
    lens = [len(b) for b in blocks]
    want = rt.nat.encode_blocks(blocks, bs)
    require(rt.nat.decode_blocks(list(zip(want, lens)), bs) == blocks, seed, index,
            f"native round trip (bs={bs})")
    for route, eng in rt.engines.items():
        with route_env(route):
            enc = eng.encode_blocks(blocks, bs)
            sync(rt.device)
            require(enc == want, seed, index, f"{route}: encode differs from the native "
                    f"engine's (bs={bs}, blocks of {lens} bytes)")
            dec = eng.decode_blocks(list(zip(enc, lens)), bs)
            sync(rt.device)
        require(dec == blocks, seed, index, f"{route}: decode mismatch (bs={bs})")
    for blk, data in zip(want, blocks):
        hdr = parse_block_header(blk)
        row = len(data) if hdr.is_literal else size_before_bwt(hdr, len(data))
        if row > rt.oracle_row:
            continue
        require(rt.oracle.encode_blocks([data], bs) == [blk], seed, index,
                f"oracle: encode differs ({len(data)} bytes)")
        require(rt.oracle.decode_blocks([(blk, len(data))], bs) == [data], seed, index,
                f"oracle: decode differs ({len(data)} bytes)")
        rt.oracle_blocks += 1


def run(seed: int = 0, n: int = 40, device="cuda", routes=ROUTES,
        oracle_row: int = ORACLE_ROW, log=print) -> dict:
    rt = Routes(device, routes, oracle_row)
    blocks = 0
    for t, (bs, blks) in enumerate(trials(seed, n)):
        trial(seed, t, one_trial, seed, t, bs, blks, rt)
        blocks += len(blks)
        if (t + 1) % 10 == 0:
            log(f"{t + 1}/{n} ok")
    return {"trials": n, "blocks": blocks, "routes": list(routes),
            "oracle_blocks": rt.oracle_blocks}


def main() -> int:
    device, argv = split_device(sys.argv[1:])
    routes, oracle_row, rest, it = ROUTES, ORACLE_ROW, [], iter(argv)
    for a in it:
        if a == "--routes":
            routes = tuple(r for r in next(it).split(",") if r not in ("", "none"))
        elif a == "--oracle-row":
            oracle_row = int(next(it))
        else:
            rest.append(a)
    seed = int(rest[0]) if rest else 0
    n = int(rest[1]) if len(rest) > 1 else 40
    res = run(seed, n, device, routes, oracle_row)
    print(f"all ok: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(run_main(main))
