"""Block engine of the port (counterpart of the JAX package's
``engines.py:56-80``).

The engine interface shared by the frame, stream and CLI layers:

    encode_blocks(blocks: list[bytes], block_size=None) -> list[bytes]
    decode_blocks(pairs: list[(block_bytes, orig_size)], block_size) -> list[bytes]

``DeviceEngine`` runs the block pipeline on ``device``: ``"cuda"`` by
default, ``"cpu"`` only when the caller asks for it.  ``device_prepass``,
``host_crc`` and ``device_crc_verify`` pass through to the pipelines
(``pipeline.py``); None reads the JAX package's variables.
"""

from __future__ import annotations

import torch

from .pipeline import DevicePipeline, resolve_device
from .utils.profiling import StageTimer


class DeviceEngine:
    name = "device"

    def __init__(
        self,
        device="cuda",
        profile: bool = False,
        device_prepass: bool | None = None,
        host_crc: bool | None = None,
        device_crc_verify: bool | None = None,
    ):
        self.device = resolve_device(device)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else None
        self.timer = StageTimer(enabled=profile, sync=sync)
        self._switches = {
            "device_prepass": device_prepass,
            "host_crc": host_crc,
            "device_crc_verify": device_crc_verify,
        }
        self._pipes: dict[int, DevicePipeline] = {}

    def _pipe(self, block_size: int) -> DevicePipeline:
        if block_size not in self._pipes:
            self._pipes[block_size] = DevicePipeline(
                block_size, self.device, timer=self.timer, **self._switches
            )
        return self._pipes[block_size]

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
