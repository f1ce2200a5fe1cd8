"""Block data parallelism over the devices of one process (counterpart
of the JAX package's ``parallel/sharding.py``).

The JAX package maps its device cores over a 1-D ``dp`` mesh with
``shard_map``.  Here a mesh is a list of ``torch.device``, and the cores
of ``sharded_pipeline`` split each wave's rows into ``len(mesh)``
contiguous shares.  Each share runs the one-device core
(``DevicePipeline.encode_steps`` / ``decode_steps``) on its device.  On
a card it runs in its own thread, under ``torch.cuda.device`` and on its
own ``torch.cuda.Stream``, and uploads its rows and downloads its
results in that thread, so that no tensor crosses streams.  A mesh may
name one device several times: two shares of one card run on two
streams.  Shares on the CPU run one after another in the calling
thread: the plain versions are Python loops that hold the interpreter
lock, so threads would only add switching between them.

The shares advance stage by stage together.  The pipeline's timer times
each stage across every share (its sync waits for every card of the
mesh), and while it is on each share on a card records CUDA events on
its stream around each of its stages (``ShardedCores.share_ms``).  A
share that raises makes the call raise once every share has ended that
stage.  The JAX package's ``psum`` of compressed bytes is a host sum
over the shares (the encode core's ``total``).  A wave holds up to
``wave_rows(mesh)`` rows, each distinct device's (one a streaming
multiprocessor of a card), and ``wave_bytes(mesh)``, each distinct
device's budget: shares of one device split it.  Each share runs the
forward and inverse BWT in its own row groups; its inverse groups' rows
go to the pipeline's host pool as they come down.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from ..ops import host
from ..pipeline import DevicePipeline, resolve_device, wave_bytes, wave_rows
from ..utils.profiling import StageTimer, device_sync

__all__ = ["make_mesh", "wave_bytes", "wave_rows", "ShardedCores", "sharded_pipeline",
           "dryrun_multichip"]


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """A 1-D mesh: ``devices`` (a device may repeat, for several shares
    of it), by default every visible card, cut to the first
    ``n_devices``.  Without a card the default raises: there is no CPU
    fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu', ...] to shard on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _shares(n: int, m: int) -> list[tuple[int, int, int]]:
    """(share, first row, end row) of n rows over m shares, contiguous,
    the first n % m shares one row longer; shares with no row left out."""
    q, r = divmod(n, m)
    out, a = [], 0
    for s in range(m):
        b = a + q + (s < r)
        if b > a:
            out.append((s, a, b))
        a = b
    return out


def _next(steps) -> tuple[bool, object]:
    """(False, next stage's name) of a core, or (True, its result)."""
    try:
        return False, next(steps)
    except StopIteration as done:
        return True, done.value


class ShardedCores:
    """The encode and decode cores of ``pipe`` over ``mesh``."""

    def __init__(self, pipe: DevicePipeline, mesh: list[torch.device]):
        self.pipe = pipe
        self.mesh = mesh
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in mesh]
        # the parallel CM encoder's own stages are not timed inside a share
        self._quiet = StageTimer(enabled=False)
        self._events = [defaultdict(list) for _ in mesh]

    def encode(self, rows: list[bytes], raws: list[bytes] | None) -> dict:
        """``encode_core_fn``: each share's ``encode_steps``, the columns
        joined in row order, ``reencoded`` and ``total`` (the payload
        bytes) summed over the shares."""
        res = self._run([
            (s, self.pipe.encode_steps(rows[a:b], None if raws is None else raws[a:b],
                                       self.mesh[s], self._quiet))
            for s, a, b in _shares(len(rows), len(self.mesh))
        ])
        out = {k: [x for r in res for x in r[k]] if isinstance(v, list) else sum(r[k] for r in res)
               for k, v in res[0].items()}
        out["total"] = sum(sum(map(len, r["body"])) for r in res)
        return out

    def decode(self, payloads: list[bytes], sizes: list[int], indices: list[int],
               on_rows=None) -> list[bytes]:
        """``decode_core_fn``: each share's ``decode_steps``, the rows in
        order; each share hands its inverse groups' rows to ``on_rows``
        (from its thread) at their rows in the wave."""
        def shifted(a: int):
            return None if on_rows is None else lambda s, rows: on_rows(a + s, rows)

        res = self._run([
            (s, self.pipe.decode_steps(payloads[a:b], sizes[a:b], indices[a:b], self.mesh[s],
                                       shifted(a)))
            for s, a, b in _shares(len(payloads), len(self.mesh))
        ])
        return [row for r in res for row in r]

    def _run(self, cores: list[tuple[int, object]]) -> list:
        """Advance every share's core one stage at a time, all together,
        each stage under the pipeline's timer; their results in share
        order."""
        live, done, names = dict(cores), {}, {}
        threaded = any(self.mesh[s].type == "cuda" for s in live)
        with ThreadPoolExecutor(len(live)) if threaded else contextlib.nullcontext() as pool:
            name = None
            while True:
                if name is None:
                    outs = self._advance(pool, live, None)
                else:
                    with self.pipe.timer.stage(name):
                        outs = self._advance(pool, live, name)
                for s, (end, value) in outs.items():
                    if end:
                        done[s] = value
                        del live[s]
                    else:
                        names[s] = value
                if not live:
                    return [done[s] for s, _ in cores]
                name = names[min(live)]

    def _advance(self, pool, live: dict, name: str | None) -> dict:
        """Each live share's next stage, in its thread where there is a
        pool; raises the first share's error once all have ended."""
        if pool is None:
            return {s: self._step(s, steps, name) for s, steps in live.items()}
        futs = {s: pool.submit(self._step, s, steps, name) for s, steps in live.items()}
        wait(futs.values())
        return {s: f.result() for s, f in futs.items()}

    def _step(self, s: int, steps, name: str | None):
        stream = self.streams[s]
        if stream is None:
            return _next(steps)
        timed = name is not None and self.pipe.timer.enabled
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            if not timed:
                return _next(steps)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = _next(steps)
            t1.record()
        self._events[s][name].append((t0, t1))
        return out

    def share_ms(self) -> list[dict[str, float]]:
        """Each share's milliseconds on its stream by stage, summed over
        the stages run while the timer was on (CUDA events; none on the
        CPU)."""
        sync = device_sync(self.mesh)
        if sync is not None:
            sync()
        return [{k: sum(a.elapsed_time(b) for a, b in ev) for k, ev in share.items()}
                for share in self._events]


def sharded_pipeline(block_size: int, mesh=None, timer: StageTimer | None = None,
                     host_crc: bool | None = None,
                     device_crc_verify: bool | None = None,
                     threads: int | None = None) -> DevicePipeline:
    """A ``DevicePipeline`` whose cores run over ``mesh`` (``make_mesh``'s
    devices; by default every card), as the JAX package's.

    - The host pre-pass and post-pass always run: the device prepass
      chain (``device_prepass``, ``BZ3_TPU_DEVICE_PREPASS``) does not
      apply, as the JAX package's ``_full_cores`` is False for overridden
      cores.
    - ``host_crc`` (default ``BZ3_TPU_HOST_CRC``, 1): the encode CRCs on
      the host; False runs K4 inside each share, as the JAX package's
      ``sharded_encode_core`` computes ``crc32_batch`` per shard.
    - ``device_crc_verify`` (default ``BZ3_TPU_DEVICE_CRC_VERIFY``, 0):
      every decoded block's CRC through K4 at the end, on the mesh's
      first device, as the JAX package's verify runs on one device.
    - Oversize blocks take the one-block-at-a-time hybrid on the mesh's
      first device: the JAX package's override never reaches it either.

    The bytes are the same on every route.  ``timer`` defaults to a
    ``StageTimer`` whose sync waits for every card of the mesh;
    ``threads`` sizes the host pool.
    """
    mesh = make_mesh(devices=mesh)
    if timer is None:
        timer = StageTimer(sync=device_sync(mesh))
    pipe = DevicePipeline(block_size, mesh[0], timer=timer, device_prepass=False,
                          host_crc=host_crc, device_crc_verify=device_crc_verify,
                          threads=threads)
    cores = ShardedCores(pipe, mesh)
    pipe.mesh = mesh
    pipe.encode_core_fn = cores.encode
    pipe.decode_core_fn = cores.decode
    pipe.shards = cores
    return pipe


def dryrun_multichip(n_devices: int, device="cpu") -> None:
    """The sharded encode and decode cores on ``n_devices`` shares of
    ``device`` at 2 * n_devices rows of 512 bytes (the JAX package's
    ``__graft_entry__.dryrun_multichip``): every row certified, the round
    trip exact and every CRC (K4 in each share) equal to the host's.
    Raises on any difference."""
    k, n = 2 * n_devices, 512
    rng = np.random.default_rng(0)
    rows = [r.tobytes() for r in rng.integers(97, 123, (k, n), dtype=np.uint8)]
    pipe = sharded_pipeline(n, [device] * n_devices, host_crc=False)
    enc = pipe.encode_core_fn(rows, rows)
    if not all(enc["ok"]) or enc["reencoded"]:
        raise RuntimeError("multichip encode reported non-exact rows")
    if pipe.decode_core_fn(enc["body"], [n] * k, enc["idx"]) != rows:
        raise RuntimeError("multichip round-trip mismatch")
    if enc["crc"] != [host.crc32(r) for r in rows]:
        raise RuntimeError("multichip crc mismatch")
