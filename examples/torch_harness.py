"""Shared parts of the port's hardening harnesses (``examples/torch_*.py``).

The harnesses drive ``bzip3_tpu_torch`` on ``cuda`` unless ``--device
cpu`` is given, and hold every outcome of the card to the port's host
C++ engine (``native``).  An outcome is the decoded bytes, or the code of
the ``Bz3Error`` raised; any other exception is a failure of the harness
run, reported with the seed and the index of the input that caused it.

Two references serve a batch decode:

- ``NativeEngine`` (the host C++ codec): its decoded bytes, and whether
  it raised.  Its error codes are the JAX package's native engine's (a
  CRC error, or malformed header for any other), raised for the first
  failed block in block order, so they are not the pipeline's codes.
- ``ReferenceEngine``: the port's own ``DevicePipeline`` on the CPU, with
  the CM decoder on the host C++ coder (``HostCmPipeline``; the host
  coder equals K2's plain version byte for byte and runs thousands of
  times faster on the CPU).  It runs the pipeline's checks in its order (every
  header, then each wave's stage checks, then its CRCs), so a batch on
  the card must raise exactly its error code.

Usable as a module by the harnesses, by ``chip_smoke.py``'s ``harden``
phase and by the tests; it imports ``torch`` and ``bzip3_tpu_torch``
only.
"""

from __future__ import annotations

import contextlib
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bzip3_tpu_torch.errors import Bz3Error  # noqa: E402
from bzip3_tpu_torch.ops import native  # noqa: E402
from bzip3_tpu_torch.pipeline import DevicePipeline, resolve_device  # noqa: E402


class HarnessFailure(AssertionError):
    """An outcome differed from its reference, or an input crashed the
    code under test; the message names the seed and the input's index."""


def split_device(argv: list[str]) -> tuple[torch.device, list[str]]:
    """``--device cuda|cpu`` (default ``cuda``) taken out of ``argv``.  A
    card asked for and absent raises: nothing falls back to the CPU."""
    dev, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            dev = next(it, "")
        elif a.startswith("--device="):
            dev = a.split("=", 1)[1]
        else:
            rest.append(a)
    return resolve_device(dev), rest


def sync(device) -> None:
    """Wait for the card (a no-op on the CPU): a fault of an asynchronous
    launch surfaces here, charged to the batch that launched it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def outcome(fn, *args, **kwargs):
    """("ok", result as bytes or a tuple of bytes) or ("err", code)."""
    try:
        r = fn(*args, **kwargs)
    except Bz3Error as e:
        return ("err", e.code)
    return ("ok", bytes(r) if isinstance(r, (bytes, bytearray)) else tuple(map(bytes, r)))


def same_verdict(a, b) -> bool:
    """Both decoded to equal bytes, or both raised (any code)."""
    return a == b if a[0] == "ok" or b[0] == "ok" else True


def trial(seed, index, fn, *args, **kwargs):
    """Run one input; any exception but a HarnessFailure becomes one
    naming ``seed`` and ``index`` (a CUDA fault, an IndexError, a
    failed check)."""
    try:
        return fn(*args, **kwargs)
    except HarnessFailure:
        raise
    except Exception as e:  # noqa: BLE001 -- every crash is a finding
        raise HarnessFailure(
            f"seed {seed} index {index}: {type(e).__name__}: {e}\n{traceback.format_exc()}"
        ) from e


def require(cond, seed, index, what) -> None:
    if not cond:
        raise HarnessFailure(f"seed {seed} index {index}: {what}")


def run_main(main) -> int:
    """The harnesses' ``__main__``: a failure prints its seed and index
    and exits 1."""
    try:
        return main() or 0
    except HarnessFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1


@contextlib.contextmanager
def env(**kv):
    """Set (a str) or clear (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class HostCmPipeline(DevicePipeline):
    """``DevicePipeline`` whose CM decode is the host C++ coder: every
    other stage, check and the error order are the pipeline's own, on the
    CPU its plain versions (tensor BWT and RLE, the plain K4 and K6).
    ``device`` may be a card, for a row too wide for the CPU's tensor
    BWT: then only the CM decode differs from the pipeline under test."""

    def __init__(self, block_size: int, device_prepass: bool = False, device="cpu"):
        super().__init__(block_size, device, device_prepass=device_prepass, host_crc=True,
                         device_crc_verify=False, threads=2)

    def _decode_cm(self, payloads, sizes, indices, device):
        yield "decode/cm"
        u = np.zeros((len(sizes), -(-max(sizes, default=0) // 256) * 256), np.uint8)
        for j, (p, s) in enumerate(zip(payloads, sizes)):
            u[j, :s] = np.frombuffer(native.cm_decode(p, s), np.uint8)
        as_t = lambda v: torch.tensor(v, dtype=torch.int32).to(device)  # noqa: E731
        return torch.from_numpy(u).to(device), as_t(sizes), as_t(indices)

    def _cm_decode_to_host(self, payload: bytes, sbb: int) -> bytes:
        return native.cm_decode(payload, sbb)


class ReferenceEngine:
    """``decode_blocks`` of ``HostCmPipeline``, one pipeline a block size."""

    name = "reference"

    def __init__(self, device_prepass: bool = False, device="cpu"):
        self.device_prepass = device_prepass
        self.device = device
        self._pipes: dict[int, HostCmPipeline] = {}

    def decode_blocks(self, pairs, block_size):
        if block_size not in self._pipes:
            self._pipes[block_size] = HostCmPipeline(block_size, self.device_prepass,
                                                     self.device)
        return self._pipes[block_size].decode_blocks(pairs)


def check_batch(seed, index, pairs, bs, engine, reference, native_engine, device) -> tuple:
    """One batch decode on ``engine``, held to ``reference`` (the same
    outcome: bytes or error code) and to ``native_engine`` (the same bytes,
    or both raise), then a synchronise.  Returns the engine's outcome.
    Where ``engine`` is the native engine itself, its codes are its own
    (see the module docstring): the reference's bytes, or an error too."""
    got = outcome(engine.decode_blocks, pairs, bs)
    sync(device)
    want = outcome(reference.decode_blocks, pairs, bs)
    nat = outcome(native_engine.decode_blocks, pairs, bs)
    exact = getattr(engine, "name", "") != "native"
    require(got == want if exact else same_verdict(got, want), seed, index,
            f"batch of {len(pairs)}: {_short(got)} against the pipeline over the host coder's "
            f"{_short(want)}")
    require(same_verdict(got, nat), seed, index,
            f"batch of {len(pairs)}: {_short(got)} against the native engine's {_short(nat)}")
    return got


def _short(o) -> str:
    if o[0] == "err":
        return f"error {o[1]}"
    if isinstance(o[1], bytes):
        return f"{len(o[1])} bytes"
    return f"blocks of {[len(b) for b in o[1]]} bytes"


def make_corpus(size: int, seed: int = 0) -> bytes:
    """Deterministic text-like data with enwik-ish compressibility (a copy
    of ``bench.py``'s corpus generator)."""
    rng = np.random.default_rng(seed)
    vocab = []
    # synthetic vocabulary with zipf-ish frequencies
    letters = np.array(list(b"abcdefghijklmnopqrstuvwxyz"), dtype=np.uint8)
    for i in range(4096):
        ln = int(rng.integers(2, 11))
        vocab.append(bytes(rng.choice(letters, ln)))
    ranks = np.arange(1, len(vocab) + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    markup = [b"<page>", b"</page>", b"[[", b"]]", b"{{", b"}}", b"==", b"&quot;"]
    parts = []
    total = 0
    idx = rng.choice(len(vocab), size=size // 5, p=probs)
    punct = rng.integers(0, 100, size=size // 5)
    for w, pn in zip(idx, punct):
        parts.append(vocab[w])
        if pn < 3:
            parts.append(markup[pn % len(markup)])
        elif pn < 6:
            parts.append(b". ")
        elif pn < 8:
            parts.append(str(int(pn) * 251).encode())
            parts.append(b" ")
        else:
            parts.append(b" ")
        total += 8
        if total >= size + 4096:
            break
    return b"".join(parts)[:size]
