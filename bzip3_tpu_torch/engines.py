"""Engine registry of the port: pluggable block codec backends
(counterpart of the JAX package's ``engines.py``).

Every engine serves the batch interface of the frame, stream and CLI
layers:

    encode_blocks(blocks: list[bytes], block_size=None) -> list[bytes]
    decode_blocks(pairs: list[(block_bytes, orig_size)], block_size) -> list[bytes]

and names in ``stages`` the single-block stage namespace that recover
mode decodes a damaged block through.

- ``oracle``: the block codec (``models/block_codec.py``) over the
  executable spec ``ops/ref`` (NumPy and Python, on the host, sharing no
  code with the tensor code or the kernels); slow, the port's reference.
- ``native``: the host C++ codec with a pthread block pool
  (``ops/native``).
- ``device``: the batched block pipeline (``pipeline.py``) on ``device``:
  ``"cuda"`` by default, ``"cpu"`` only when the caller asks for it.
- ``sharded``: the device pipeline with each wave's rows split over every
  card (``parallel/sharding.py``); with ``device="cpu"`` one CPU share.
- ``hybrid``: the native pool and the device pipeline splitting one
  batch and working at once.
- ``auto``: native if its library builds, else oracle.

All engines produce byte-identical BZ3v1 streams.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from .models.block_codec import decode_block, encode_block
from .ops import native, ref
from .ops.build import BuildError
from .ops.device.stages import block_stages
from .parallel.sharding import make_mesh, sharded_pipeline
from .pipeline import DevicePipeline, resolve_device
from .utils.profiling import StageTimer, device_sync

NAMES = ("device", "sharded", "oracle", "native", "hybrid", "auto")


class OracleEngine:
    name = "oracle"
    stages = ref

    def encode_blocks(self, blocks, block_size=None):
        return [encode_block(b, self.stages) for b in blocks]

    def decode_blocks(self, pairs, block_size):
        return [decode_block(b, osize, block_size, self.stages) for b, osize in pairs]


class NativeEngine:
    """The host C++ codec on ``n_threads`` workers (0: one a core)."""

    name = "native"
    stages = native.STAGES

    def __init__(self, n_threads: int = 0):
        native.load()
        self.n_threads = n_threads

    def encode_blocks(self, blocks, block_size=None):
        return native.encode_blocks(blocks, self.n_threads)

    def decode_blocks(self, pairs, block_size):
        return native.decode_blocks(pairs, block_size, self.n_threads)


class DeviceEngine:
    """The block pipeline on ``device``.  ``device_prepass``, ``host_crc``
    and ``device_crc_verify`` pass through to the pipelines
    (``pipeline.py``); None reads the JAX package's variables.  ``profile``
    turns the stage timer (``timer``) on; None reads ``BZ3_TPU_PROFILE``.

    ``sharded`` runs ``sharded_pipeline`` over ``mesh`` (``make_mesh``'s
    devices): by default every card, or with ``device="cpu"`` one CPU
    share; a ``mesh`` given implies ``sharded``.  There the host passes
    always run, so ``device_prepass`` does not apply (``sharded_pipeline``
    says what the CRC switches do).  ``n_threads`` sizes the pipelines'
    host pool (0: ``os.cpu_count()``), as ``-j`` does for the other
    engines."""

    name = "device"

    def __init__(
        self,
        device="cuda",
        profile: bool | None = None,
        device_prepass: bool | None = None,
        host_crc: bool | None = None,
        device_crc_verify: bool | None = None,
        sharded: bool = False,
        mesh=None,
        n_threads: int = 0,
    ):
        self.device = resolve_device(device)
        self.mesh = None
        if sharded or mesh is not None:
            if mesh is None and self.device.type == "cpu":
                mesh = [self.device]
            self.mesh = make_mesh(devices=mesh)
            self.device = self.mesh[0]
            self.name = "sharded"
        self.timer = StageTimer(enabled=profile, sync=device_sync(self.mesh or [self.device]))
        self._switches = {
            "device_prepass": device_prepass,
            "host_crc": host_crc,
            "device_crc_verify": device_crc_verify,
        }
        self.n_threads = n_threads
        self._pipes: dict[int, DevicePipeline] = {}
        self.stages = block_stages(self.device)

    def _pipe(self, block_size: int) -> DevicePipeline:
        if block_size not in self._pipes:
            if self.mesh is None:
                pipe = DevicePipeline(block_size, self.device, timer=self.timer,
                                      threads=self.n_threads, **self._switches)
            else:
                pipe = sharded_pipeline(block_size, self.mesh, timer=self.timer,
                                        host_crc=self._switches["host_crc"],
                                        device_crc_verify=self._switches["device_crc_verify"],
                                        threads=self.n_threads)
            self._pipes[block_size] = pipe
        return self._pipes[block_size]

    def share_ms(self) -> list[dict[str, float]]:
        """A sharded engine's milliseconds of each share on its stream by
        stage (``ShardedCores.share_ms``), over its pipelines."""
        out = [{} for _ in self.mesh or ()]
        for pipe in self._pipes.values():
            for acc, ms in zip(out, pipe.shards.share_ms()):
                for k, v in ms.items():
                    acc[k] = acc.get(k, 0.0) + v
        return out

    @property
    def reencoded_rows(self) -> int:
        """Rows re-encoded by the plain CM because the device payload
        overflowed its buffer (0 on any sane input)."""
        return sum(p.reencoded_rows for p in self._pipes.values())

    def encode_blocks(self, blocks, block_size=None):
        bs = block_size or max((len(b) for b in blocks), default=64)
        return self._pipe(bs).encode_blocks(blocks)

    def decode_blocks(self, pairs, block_size):
        return self._pipe(block_size).decode_blocks(pairs)


class HybridEngine:
    """The native pool and the device pipeline on one batch at once.

    The first ``device_share`` of a batch's blocks go to the device
    pipeline while the native pool works the rest on a second thread (its
    ctypes call releases the GIL); streams are byte-identical across
    engines, so the split does not show in the output.  ``device_share``
    defaults to ``BZ3_TPU_HYBRID_SHARE`` (0.07), and a batch under
    ``BZ3_TPU_HYBRID_MIN_MIB`` (1024) MiB goes to the native pool alone:
    the JAX package's values and gate (its engines.py:124-138).
    """

    name = "hybrid"

    def __init__(self, n_threads: int = 0, device_share: float | None = None,
                 device="cuda"):
        self._native = NativeEngine(n_threads)
        self._device = DeviceEngine(device, n_threads=n_threads)
        self.stages = self._native.stages
        if device_share is None:
            device_share = float(os.environ.get("BZ3_TPU_HYBRID_SHARE", "0.07"))
        self.device_share = min(1.0, max(0.0, device_share))

    def _run(self, items, block_size, dev_fn, nat_fn):
        min_b = int(float(os.environ.get("BZ3_TPU_HYBRID_MIN_MIB", "1024")) * (1 << 20))
        total = sum(len(it[0]) if isinstance(it, tuple) else len(it) for it in items)
        d = int(round(len(items) * self.device_share))
        if d == 0 or len(items) < 2 or total < min_b:
            return nat_fn(items, block_size)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(nat_fn, items[d:], block_size)
            dev_out = dev_fn(items[:d], block_size)
            return dev_out + fut.result()

    def encode_blocks(self, blocks, block_size=None):
        bs = block_size or max((len(b) for b in blocks), default=64)
        return self._run(blocks, bs, self._device.encode_blocks, self._native.encode_blocks)

    def decode_blocks(self, pairs, block_size):
        return self._run(pairs, block_size, self._device.decode_blocks,
                         self._native.decode_blocks)


def get_engine(name: str = "auto", n_threads: int = 0, device="cuda"):
    """The engine called ``name`` (``NAMES``); ``device`` places the
    device, sharded and hybrid engines."""
    if name == "auto":
        try:
            return NativeEngine(n_threads)
        except BuildError:  # no host compiler: the executable spec
            return OracleEngine()
    if name == "oracle":
        return OracleEngine()
    if name == "native":
        return NativeEngine(n_threads)
    if name == "device":
        return DeviceEngine(device, n_threads=n_threads)
    if name == "sharded":
        return DeviceEngine(device, sharded=True, n_threads=n_threads)
    if name == "hybrid":
        return HybridEngine(n_threads, device=device)
    raise ValueError(f"unknown engine {name!r}")
