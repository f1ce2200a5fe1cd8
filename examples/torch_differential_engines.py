#!/usr/bin/env python
"""Randomized cross-engine differential for the PyTorch/CUDA port (the
port's counterpart of ``differential_engines.py``): the port's
``DevicePipeline`` against its ``native`` and ``oracle`` engines and its
plain versions.

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
Two more legs hold that stream:

- ``oracle``: the port's ``oracle`` engine (the block codec over the
  executable spec ``ops/ref``, NumPy and Python sharing no code with the
  tensor code, the kernels or the host C++) encodes and decodes **every**
  block, whole, whatever its row: the same bytes again.  It is CPU work
  only, so it runs on spawned processes (half the machine's cores, at
  most 4) beside the card's work, and is checked when the run ends.
- ``plain``: the block codec over the plain versions on the CPU
  (``block_stages("cpu")``, ~0.1-0.2 ms a CM bit step there) encodes and
  decodes each block whose CM row is at most ``--plain-row`` bytes
  (default 2,048), the same bytes again.

Block sizes are two, so each route keeps one pipeline a size.  The JAX
file runs long campaigns as fresh-process chunks because XLA:CPU's JIT
section mappings accumulate per process; that does not hold here: the
port compiles nothing at run time beyond its one kernel library, so one
process runs any number of trials.

    python examples/torch_differential_engines.py [seed] [trials] [--device cpu] [--routes default,prepass,parallel] [--plain-row N]

``--routes none`` holds the native engine to the oracle and the plain
versions alone (the CPU lane at volume: the device routes' plain CM
costs ~0.1-0.2 ms a bit step on the CPU).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_harness import (  # noqa: E402
    HarnessFailure,
    env,
    make_corpus,
    require,
    run_main,
    split_device,
    sync,
    trial,
)

from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine, OracleEngine  # noqa: E402
from bzip3_tpu_torch.models.block_codec import (  # noqa: E402
    decode_block,
    encode_block,
    parse_block_header,
    size_before_bwt,
)
from bzip3_tpu_torch.ops.device.stages import block_stages  # noqa: E402

ROUTES = ("default", "prepass", "parallel")
PLAIN_ROW = 2048


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


def oracle_block(data: bytes, blk: bytes, bs: int) -> tuple[bool, bool, float]:
    """The oracle leg of one block: whether the oracle engine encodes
    ``data`` to ``blk`` and decodes ``blk`` to ``data``, and the seconds
    it took.  A function of the module, so that a spawned worker runs it."""
    t0 = time.perf_counter()
    eng = OracleEngine()
    enc = eng.encode_blocks([data], bs) == [blk]
    dec = eng.decode_blocks([(blk, len(data))], bs) == [data]
    return enc, dec, time.perf_counter() - t0


class OracleLeg:
    """Every block of a run through ``oracle_block`` on ``WORKERS``
    spawned processes (a spawned worker shares no CUDA context and no lock
    with the card's threads), checked in ``finish``."""

    WORKERS = max(1, min(4, (os.cpu_count() or 2) // 2))

    def __init__(self):
        self.pool = ProcessPoolExecutor(self.WORKERS,
                                        mp_context=multiprocessing.get_context("spawn"))
        self.jobs = []
        self.t0 = self.done = None

    def _mark(self, _fut=None) -> None:
        self.done = time.perf_counter()

    def submit(self, seed, index, data: bytes, blk: bytes, bs: int, row: int | None) -> None:
        """One block; ``row`` is its CM row, None for a literal block."""
        if self.t0 is None:
            self.t0 = time.perf_counter()
        fut = self.pool.submit(oracle_block, data, blk, bs)
        fut.add_done_callback(self._mark)
        self.jobs.append((seed, index, len(data), row, fut))

    def close(self) -> None:
        """Stop the workers, dropping blocks not yet begun."""
        self.pool.shutdown(cancel_futures=True)

    @staticmethod
    def _check(seed, index, n: int, fut) -> tuple:
        res = fut.result()
        require(res[0], seed, index, f"oracle: encode differs ({n} bytes)")
        require(res[1], seed, index, f"oracle: decode differs ({n} bytes)")
        return res

    def finish(self) -> dict:
        """Wait for every block and check each one: a worker's exception
        (the oracle's ``Bz3Error`` on a block, a broken pool) becomes a
        ``HarnessFailure`` naming the block's seed and index, as a
        mismatch does, raised after every block was checked.  Else the
        blocks and bytes held, those found equal, the leg's wall time from
        its first block to its last result, and the seconds ``finish``
        waited."""
        t_wait = time.perf_counter()
        results, failures = [], []
        try:
            for seed, index, n, _, fut in self.jobs:
                try:
                    results.append(trial(seed, index, self._check, seed, index, n, fut))
                except HarnessFailure as e:
                    failures.append(e)
        finally:
            self.close()
        if failures:
            raise HarnessFailure(f"{failures[0]}\n({len(failures)} of {len(self.jobs)} "
                                 f"blocks failed the oracle)")
        coded = [j[3] for j in self.jobs if j[3] is not None]
        return {"blocks": len(self.jobs), "compressed_blocks": len(coded),
                "bytes": sum(j[2] for j in self.jobs), "max_row": max(coded, default=0),
                "equal": len(results), "workers": self.WORKERS,
                "wall_s": (self.done - self.t0) if self.jobs else 0.0,
                "cpu_s": sum(r[2] for r in results),
                "wait_s": time.perf_counter() - t_wait}


class Routes:
    """One ``DeviceEngine`` a route on ``device``, and the references."""

    def __init__(self, device, routes=ROUTES, plain_row: int = PLAIN_ROW,
                 oracle: OracleLeg | None = None):
        self.device = device
        self.engines = {
            r: DeviceEngine(device, device_prepass=r == "prepass", host_crc=True,
                            device_crc_verify=False)
            for r in routes
        }
        self.nat = NativeEngine(0)
        self.oracle = oracle
        self.plain = block_stages("cpu")
        self.plain_row = plain_row
        self.plain_blocks = 0


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
        if rt.oracle is not None:
            rt.oracle.submit(seed, index, data, blk, bs, None if hdr.is_literal else row)
        if row > rt.plain_row:
            continue
        require(encode_block(data, rt.plain) == blk, seed, index,
                f"plain: encode differs ({len(data)} bytes)")
        require(decode_block(blk, len(data), bs, rt.plain) == data, seed, index,
                f"plain: decode differs ({len(data)} bytes)")
        rt.plain_blocks += 1


def run(seed: int = 0, n: int = 40, device="cuda", routes=ROUTES,
        plain_row: int = PLAIN_ROW, log=print, leg: OracleLeg | None = None) -> dict:
    """``n`` trials of ``seed``; the oracle leg goes to ``leg`` where one
    is given, and its caller finishes it."""
    rt = Routes(device, routes, plain_row, leg)
    blocks = 0
    for t, (bs, blks) in enumerate(trials(seed, n)):
        trial(seed, t, one_trial, seed, t, bs, blks, rt)
        blocks += len(blks)
        if (t + 1) % 10 == 0:
            log(f"{t + 1}/{n} ok")
    return {"trials": n, "blocks": blocks, "routes": list(routes),
            "plain_blocks": rt.plain_blocks}


def main() -> int:
    device, argv = split_device(sys.argv[1:])
    routes, plain_row, rest = ROUTES, PLAIN_ROW, []
    it = iter(argv)
    for a in it:
        if a == "--routes":
            routes = tuple(r for r in next(it).split(",") if r not in ("", "none"))
        elif a == "--plain-row":
            plain_row = int(next(it))
        else:
            rest.append(a)
    seed = int(rest[0]) if rest else 0
    n = int(rest[1]) if len(rest) > 1 else 40
    leg = OracleLeg()
    try:
        res = run(seed, n, device, routes, plain_row, leg=leg)
        res["oracle"] = leg.finish()
    finally:
        leg.close()
    print(f"all ok: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(run_main(main))
