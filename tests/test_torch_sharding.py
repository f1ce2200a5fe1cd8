"""The port's block data parallelism on the CPU: ``sharded_pipeline`` on
meshes of CPU shares against the JAX package's ``sharded_pipeline`` on
its 8-device CPU mesh, the JAX oracle codec and the port's unsharded
pipeline; the share scheduler, the wave budget, the switches, the
re-encode rule and the error order inside shares; ``dryrun_multichip``;
the multi-host helpers in one process; the ``sharded`` engine and CLI
name; and launch counts and stage times kept exact across threads.

The plain CM costs ~0.1-0.2 ms a bit step and CPU shares run one after
another, so beside the JAX test's 8 blocks the rows here are short or
collapse under RLE.
"""

import contextlib
import struct
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bzip3_tpu.models.block_codec import encode_block as jax_encode_block
from bzip3_tpu.parallel.sharding import make_mesh as jax_make_mesh
from bzip3_tpu.parallel.sharding import sharded_pipeline as jax_sharded_pipeline
from bzip3_tpu_torch import pipeline
from bzip3_tpu_torch.cli import main
from bzip3_tpu_torch.engines import DeviceEngine, get_engine
from bzip3_tpu_torch.errors import BZ3_ERR_CRC, BZ3_ERR_MALFORMED_HEADER, Bz3Error
from bzip3_tpu_torch.models.block_codec import parse_block_header
from bzip3_tpu_torch.ops.device import cm_cuda
from bzip3_tpu_torch.parallel import multihost as mh
from bzip3_tpu_torch.parallel import sharding
from bzip3_tpu_torch.parallel.sharding import (
    dryrun_multichip,
    make_mesh,
    sharded_pipeline,
    wave_bytes,
)
from bzip3_tpu_torch.pipeline import DevicePipeline
from bzip3_tpu_torch.utils.profiling import StageTimer

BS = 1024
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def blocks(text_data):
    """tests/test_pipeline.py's blocks, built as its fixture builds them."""
    return [
        text_data[:BS],
        bytes(RNG.integers(0, 256, BS, dtype=np.uint8)),
        b"ab" * (BS // 2),
        b"x" * 40,  # literal path (< 64 bytes)
        text_data[BS : 2 * BS],
        b"\x00" * BS,
        bytes(RNG.integers(0, 16, 700, dtype=np.uint8)),
        b"",
    ]


@pytest.fixture(scope="module")
def jax_sharded(blocks):
    """The JAX sharded pipeline on its 8-device CPU mesh, once (the
    compile tests/test_pipeline.py's sharded tests also make)."""
    return jax_sharded_pipeline(BS, jax_make_mesh(8)).encode_blocks(blocks)


def _small(n: int, seed: int = 0) -> list[bytes]:
    """n blocks of 64-400 bytes that RLE collapses to a few dozen, so the
    plain CM of a share stays cheap."""
    rng = np.random.default_rng(seed)
    return [b"%03d the quick brown fox " % i + bytes([97 + i % 26]) * int(rng.integers(40, 370))
            for i in range(n)]


def _spy(monkeypatch, pipe) -> list[int]:
    """The row counts of each share's encode core, call by call."""
    calls, real = [], pipe.encode_steps

    def steps(rows, *args):
        calls.append(len(rows))
        return real(rows, *args)

    monkeypatch.setattr(pipe, "encode_steps", steps)
    return calls


def test_jax_blocks_on_eight_cpu_shares(blocks, jax_sharded):
    pipe = sharded_pipeline(BS, ["cpu"] * 8)
    enc = pipe.encode_blocks(blocks)
    assert enc == jax_sharded
    assert enc == [jax_encode_block(b) for b in blocks]
    assert enc == DevicePipeline(BS, device="cpu").encode_blocks(blocks)
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks
    assert pipe.reencoded_rows == 0


@pytest.mark.parametrize("n,m,shares", [(5, 8, [1] * 5), (13, 4, [4, 3, 3, 3])])
def test_counts_not_a_multiple_of_the_mesh(monkeypatch, n, m, shares):
    blocks = _small(n)
    pipe = sharded_pipeline(BS, ["cpu"] * m)
    calls = _spy(monkeypatch, pipe)
    enc = pipe.encode_blocks(blocks)
    assert calls == shares
    assert enc == [jax_encode_block(b) for b in blocks]
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks


def test_several_waves(monkeypatch):
    blocks = _small(6, seed=1)
    monkeypatch.setattr(pipeline, "WAVE_BYTES", 2 * 256)  # two 256-byte rows a wave
    pipe = sharded_pipeline(BS, ["cpu"] * 2)
    calls = _spy(monkeypatch, pipe)
    enc = pipe.encode_blocks(blocks)
    assert calls == [1] * 6  # three waves of two rows, one a share
    assert enc == [jax_encode_block(b) for b in blocks]
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks


def test_wave_budget_counts_distinct_devices(monkeypatch):
    # each card's budget comes from its memory (an H100's, read here as given)
    monkeypatch.setattr(pipeline, "_card", lambda dev: SimpleNamespace(
        multi_processor_count=132, total_memory=85_045_846_016))
    cuda = [torch.device("cuda", i) for i in range(3)]
    w = pipeline.device_wave_bytes(cuda[0])
    assert wave_bytes(cuda[:1]) == w
    assert wave_bytes(cuda) == 3 * w
    assert wave_bytes([cuda[0], cuda[0]]) == w  # two shares of one card split its budget
    assert wave_bytes([cuda[0], cuda[1], cuda[1], cuda[2]]) == 3 * w
    assert wave_bytes(["cpu"] * 8) == pipeline.WAVE_BYTES
    assert DevicePipeline(BS, device="cpu").mesh == [torch.device("cpu")]


@pytest.mark.parametrize("cm,switches", [("parallel", {}),
                                         ("auto", {"host_crc": False, "device_crc_verify": True})])
def test_switches_keep_the_bytes(monkeypatch, cm, switches):
    """The parallel CM encoder and K4 (the encode CRCs and the verify)
    inside the shares give the bytes of the default route."""
    monkeypatch.setenv("BZ3_TPU_CM", cm)
    blocks = _small(3, seed=2) + [b"y" * 30]
    pipe = sharded_pipeline(BS, ["cpu"] * 2, **switches)
    enc = pipe.encode_blocks(blocks)
    assert enc == [jax_encode_block(b) for b in blocks]
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks
    assert pipe.reencoded_rows == 0


def test_failed_row_is_reencoded_in_its_share(monkeypatch):
    """A row whose payload overflows its buffer (K1's ok False) is coded
    again inside its share and counted."""
    real = cm_cuda.cm_encode

    def capped(data, lengths, out_width=None):
        return real(data, lengths, 48 if out_width is None else out_width)

    monkeypatch.setattr(cm_cuda, "cm_encode", capped)
    blocks = _small(3, seed=3) + [bytes(RNG.integers(97, 123, 120, dtype=np.uint8))]
    pipe = sharded_pipeline(BS, ["cpu"] * 2)
    enc = pipe.encode_blocks(blocks)
    assert enc == [jax_encode_block(b) for b in blocks]
    long = [len(e) - parse_block_header(e).header_size() > 48 for e in enc]
    assert long[3] and pipe.reencoded_rows == sum(long)


def test_host_total_is_the_payload_sum():
    """The JAX package's psum of compressed bytes: a host sum over the
    shares of the encode core's payloads."""
    rows = [r[:200] for r in _small(5, seed=4)]
    pipe = sharded_pipeline(BS, ["cpu"] * 3)
    res = pipe.encode_core_fn(rows, None)
    assert len(res["body"]) == len(res["idx"]) == 5 and res["reencoded"] == 0
    assert res["total"] == sum(map(len, res["body"]))
    one = pipe.encode_steps(rows, None, torch.device("cpu"), StageTimer(enabled=False))
    assert res["body"] == pipeline.run_core(one, StageTimer(enabled=False))["body"]


def _raised(decode, pairs) -> int:
    with pytest.raises(Bz3Error) as err:
        decode(pairs)
    return err.value.code


def test_errors_match_the_unsharded_pipeline():
    """The F1 input (a literal's bad CRC before a malformed header) and a
    broken CRC raise what the unsharded pipeline raises, whose order
    tests/test_torch_pipeline.py holds to the JAX package's."""
    bs = 65536
    literal = struct.pack("<Ii", 0xDEADBEEF, -1) + b"abc"
    coded = struct.pack("<IiB", 0, 5000, 0) + bytes(range(100))
    f1 = [(literal, 3), (coded, 200)]
    assert _raised(sharded_pipeline(bs, ["cpu"] * 2).decode_blocks, f1) == BZ3_ERR_MALFORMED_HEADER
    assert _raised(DevicePipeline(bs, device="cpu").decode_blocks, f1) == BZ3_ERR_MALFORMED_HEADER

    blocks = _small(4, seed=5) + [b"z" * 20]
    enc = [jax_encode_block(b) for b in blocks]
    for i in (1, 4):  # a coded block and the literal
        bad = list(enc)
        bad[i] = bytes([bad[i][0] ^ 1]) + bad[i][1:]
        pairs = [(e, len(b)) for e, b in zip(bad, blocks)]
        assert _raised(sharded_pipeline(BS, ["cpu"] * 2).decode_blocks, pairs) == BZ3_ERR_CRC
        assert _raised(DevicePipeline(BS, device="cpu").decode_blocks, pairs) == BZ3_ERR_CRC


def test_dryrun_multichip():
    dryrun_multichip(8)


class _Fake:
    """A core of two stages that meets the other shares at a barrier in
    its first stage and may raise in its second."""

    def __init__(self, barrier, fail=False):
        self.barrier, self.fail, self.ended = barrier, fail, False

    def steps(self, s):
        yield "a"
        self.barrier.wait(timeout=20)  # every share's stage "a" at once
        yield "b"
        if self.fail:
            raise ValueError("share failed")
        self.ended = True
        return s * 10


def test_card_shares_run_in_threads_together():
    """On a card the shares' stages run at once, one thread each, the
    results come back in share order and a share's error is raised once
    every share has ended its stage (the cores are fakes here: a CPU
    pipeline whose mesh names cards)."""
    timer = StageTimer(enabled=True)
    pipe = sharded_pipeline(BS, ["cpu"] * 3, timer=timer)
    cores = pipe.shards
    cores.mesh = [torch.device("cuda", 0)] * 3  # threads, as on a card
    barrier = threading.Barrier(3)
    fakes = [_Fake(barrier) for _ in range(3)]
    assert cores._run([(s, f.steps(s)) for s, f in enumerate(fakes)]) == [0, 10, 20]
    assert dict(timer.counts) == {"a": 1, "b": 1}
    fakes = [_Fake(barrier, fail=s == 0) for s in range(3)]
    with pytest.raises(ValueError, match="share failed"):
        cores._run([(s, f.steps(s)) for s, f in enumerate(fakes)])
    assert [f.ended for f in fakes] == [False, True, True]


def test_launch_counts_and_stages_stay_exact_across_threads(monkeypatch):
    """Launches and stages from many threads at once (the shares of a
    card) lose no count; the launch is faked, as a CUDA kernel cannot run
    on the CPU."""
    monkeypatch.setattr(cm_cuda, "route", lambda *ts: "cuda")
    monkeypatch.setattr(cm_cuda, "entry", lambda name, *a, **k: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: SimpleNamespace(cuda_stream=0))
    data, lens = torch.zeros((1, 16), dtype=torch.uint8), torch.ones(1, dtype=torch.int32)
    timer = StageTimer(enabled=True)

    def work(_):
        for _ in range(300):
            with timer.stage("s"):
                cm_cuda.cm_encode(data, lens)

    cm_cuda.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            list(ex.map(work, range(16)))
    finally:
        sys.setswitchinterval(old)
    assert cm_cuda.LAUNCHES["cm_encode"] == 16 * 300
    assert timer.counts["s"] == 16 * 300
    cm_cuda.reset_launches()


def test_multihost_helpers_single_process(monkeypatch):
    """The JAX package's single-process test of its multi-host layer
    (tests/test_pipeline.py), on the port's helpers."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    mh.initialize()  # no-op without MASTER_ADDR
    assert not torch.distributed.is_initialized()
    assert mh.global_mesh("cpu") == [torch.device("cpu")]
    assert list(mh.host_stripe(5)) == [0, 1, 2, 3, 4]
    rows = np.arange(16 * 4, dtype=np.uint8).reshape(16, 4)
    p, l = mh.gather_to_writer(torch.from_numpy(rows), np.arange(16, dtype=np.int32))
    assert (p == rows).all() and (l == np.arange(16)).all()


def test_sharded_engine_and_cli_equal_device(tmp_path, text_data, capfdbinary):
    eng = get_engine("sharded", device="cpu")
    assert isinstance(eng, DeviceEngine) and eng.mesh == [torch.device("cpu")]
    assert eng.name == "sharded"
    blocks = _small(3, seed=6)
    enc = eng.encode_blocks(blocks, BS)
    assert enc == DeviceEngine("cpu").encode_blocks(blocks, BS)
    assert eng.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)], BS) == blocks
    assert DeviceEngine("cpu", mesh=["cpu", "cpu"]).encode_blocks(blocks, BS) == enc

    src = tmp_path / "in.txt"
    src.write_bytes((text_data[:120] * 600)[:70000])
    out = {}
    for engine in ("sharded", "device"):
        assert main(["-e", "-b", "1", "-c", "--engine", engine, "--device", "cpu", str(src)]) == 0
        out[engine] = capfdbinary.readouterr().out
    assert out["sharded"] == out["device"]
    packed = tmp_path / "in.txt.bz3"
    packed.write_bytes(out["sharded"])
    assert main(["-d", "-c", "--engine", "sharded", "--device", "cpu", str(packed)]) == 0
    assert capfdbinary.readouterr().out == src.read_bytes()


def test_sharded_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is valid")
    for make in (lambda: get_engine("sharded"), lambda: DeviceEngine(sharded=True),
                 make_mesh, lambda: sharded_pipeline(BS), mh.global_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make_mesh(2, ["cpu"] * 3) == [torch.device("cpu")] * 2
    assert sharding._shares(2, 3) == [(0, 0, 1), (1, 1, 2)]
    with pytest.raises(ValueError):
        make_mesh(devices=[])
