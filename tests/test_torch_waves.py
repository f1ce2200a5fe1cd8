"""The port's wave scheduling on the CPU, against the JAX package's
``DevicePipeline``: the wave and BWT group planners and the difficulty
order against JAX's functions; forced small waves, BWT groups and
inverse groups against the JAX pipeline's blocks and the port's one-wave
run; the host pool (thread counts, and the next wave's pre-pass running
while a wave's core runs); the decode error order across inverse groups;
the sharded engine with small groups; the CLI's default batch.

The plain CM costs ~0.1-0.2 ms a bit step and runs a wave's rows in
lockstep, so the rows here are at most ~1 KiB after RLE/LZP.
"""

import os
import threading
import types

import numpy as np
import pytest
import torch

from bzip3_tpu.models.block_codec import encode_block as jax_encode_block
from bzip3_tpu.pipeline import DevicePipeline as JaxPipeline
from bzip3_tpu.pipeline import _bwt_difficulty as jax_difficulty
from bzip3_tpu.pipeline import _bwt_row_groups as jax_row_groups
from bzip3_tpu_torch import cli, pipeline
from bzip3_tpu_torch.errors import BZ3_ERR_CRC, BZ3_ERR_MALFORMED_HEADER, Bz3Error
from bzip3_tpu_torch.parallel.sharding import sharded_pipeline
from bzip3_tpu_torch.pipeline import DevicePipeline
from bzip3_tpu_torch.utils.profiling import StageTimer

BS = 4096
GROUP_VARS = ("BZ3_TPU_WAVE", "BZ3_TPU_WAVE_MIB", "BZ3_TPU_BWT_GROUP_MIB",
              "BZ3_TPU_BWT_GROUP_ROWS", "BZ3_TPU_INV_GROUP_MIB")


@pytest.fixture(autouse=True)
def _no_group_vars(monkeypatch):
    for v in GROUP_VARS:
        monkeypatch.delenv(v, raising=False)


def _env(mp, **kv):
    for k, v in kv.items():
        mp.setenv(k, str(v))


def _sparse(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    out = np.zeros(n, np.uint8)
    for pos in rng.integers(0, n - 16, n // 200):
        out[pos : pos + 8] = rng.integers(1, 256, 8, dtype=np.uint8)
    return out.tobytes()


@pytest.fixture(scope="module")
def mixed(text_data):
    """Ten blocks of up to 4 KiB: text, periodic, random, sparse and a
    literal; every row is at most ~1 KiB after RLE/LZP, and each run of
    five blocks holds a random one, so JAX's two waves of five share one
    width bucket (one compile)."""
    rng = np.random.default_rng(11)
    return [
        text_data[:1024],
        bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
        (b"periodic row " * 400)[:4096],
        b"y" * 40,  # literal path
        _sparse(4096, 1),
        text_data[3000:3900],
        bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
        (b"0123456789abcdef" * 256)[:4000],
        _sparse(3000, 2),
        b"ab" * 1500,
    ]


@pytest.fixture(scope="module")
def jax_blocks(mixed):
    """The JAX pipeline's blocks of ``mixed`` at waves of 5 and BWT groups
    of 2 (read when its core traces)."""
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, BZ3_TPU_WAVE=5, BZ3_TPU_BWT_GROUP_ROWS=2)
        return JaxPipeline(BS).encode_blocks(mixed)


@pytest.fixture(scope="module")
def one_wave(mixed):
    return DevicePipeline(BS, device="cpu").encode_blocks(mixed)


@pytest.fixture(scope="module")
def forced(mixed):
    """The port at waves of 5 rows and BWT groups of 2: (pipeline, blocks)."""
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, BZ3_TPU_WAVE=5, BZ3_TPU_BWT_GROUP_ROWS=2)
        pipe = DevicePipeline(BS, device="cpu")
        return pipe, pipe.encode_blocks(mixed)


# -- planners ------------------------------------------------------------


@pytest.mark.parametrize("mib,rows", [("128", "16"), ("0.01", "3"), ("1", "1"), ("300", "7")])
def test_bwt_row_groups_equal_jax(monkeypatch, mib, rows):
    _env(monkeypatch, BZ3_TPU_BWT_GROUP_MIB=mib, BZ3_TPU_BWT_GROUP_ROWS=rows)
    for k in (1, 2, 5, 8, 17, 32, 132):
        for width in (256, 4096, 1 << 20, 16 << 20, 64 << 20):
            assert pipeline.bwt_row_groups(k, width, "cpu") == jax_row_groups(k, width)


def test_bwt_difficulty_and_order_equal_jax():
    rng = np.random.default_rng(5)
    text = (b"the quick brown fox jumps over the lazy dog " * 400)
    rows = [bytes(rng.integers(0, 256, 6000, dtype=np.uint8)), text[:9000], b"ab" * 5000,
            bytes(rng.integers(0, 4, 5000, dtype=np.uint8)), b"short row", text[3:4100],
            bytes(rng.integers(0, 256, 20000, dtype=np.uint8)) + b"\0" * 20000]
    got = [pipeline.bwt_difficulty(r) for r in rows]
    assert got == [jax_difficulty(r) for r in rows]
    order = pipeline.difficulty_order(got)
    # the JAX rule (pipeline.py:606-620)
    assert order == sorted(range(len(rows)), key=lambda j: got[j])
    assert order != list(range(len(rows)))
    assert pipeline.difficulty_order([0.5, 0.53]) is None
    assert pipeline.difficulty_order([0.9]) is None


def test_wave_plan_on_cards(monkeypatch):
    """A card's wave fills its SMs, bounded by its memory; shares of one
    card split it; the JAX variables override."""
    total = int(79.2 * (1 << 30))
    monkeypatch.setattr(pipeline, "_card", lambda dev: types.SimpleNamespace(
        multi_processor_count=132, total_memory=total))
    h100 = [torch.device("cuda", 0)]
    assert pipeline.wave_rows(h100) == 132
    assert pipeline.wave_rows(h100 * 2) == 132
    assert pipeline.wave_rows([torch.device("cuda", i) for i in range(4)]) == 4 * 132
    g = pipeline.bwt_group_bytes(h100[0])
    assert g == int(total * pipeline.BWT_SHARE / pipeline.BWT_PEAK_BYTES)
    budget = pipeline.device_wave_bytes(h100[0])
    # the resident buffers and one BWT group fit the planned share
    planned = budget * pipeline.RESIDENT_BYTES + g * pipeline.BWT_PEAK_BYTES
    assert planned <= total * pipeline.MEM_SHARE
    assert budget >= 132 * (16 << 20)  # -b 16: the SMs bind, not memory
    waves = pipeline._waves(list(range(200)), lambda i: 16 << 20, 132, budget)
    assert [len(w) for w in waves] == [132, 68]
    big = pipeline._waves(list(range(200)), lambda i: 128 << 20, 132, budget)
    assert 1 < len(big[0]) < 132  # -b 128: memory binds
    assert pipeline.bwt_row_groups(32, 16 << 20, h100[0]) == g // (16 << 20)
    assert pipeline.inverse_row_groups(32, 16 << 20, h100[0]) == pipeline.INV_GROUP_BYTES >> 24
    # the sort key's bound holds for a group at the format's widest row
    assert pipeline.bwt_row_groups(64, 511 << 20, h100[0]) * (511 << 20) ** 2 < 1 << 62
    _env(monkeypatch, BZ3_TPU_WAVE=7, BZ3_TPU_WAVE_MIB=64, BZ3_TPU_BWT_GROUP_MIB=32,
         BZ3_TPU_INV_GROUP_MIB=16)
    assert pipeline.wave_rows(h100) == 7
    assert pipeline.wave_bytes(h100 * 2) == 64 << 20
    assert pipeline.bwt_row_groups(32, 1 << 20, h100[0]) == 32
    assert pipeline.inverse_row_groups(32, 1 << 20, h100[0]) == 16


def test_cpu_defaults():
    cpu = torch.device("cpu")
    assert pipeline.wave_rows([cpu] * 8) == pipeline.CPU_WAVE_ROWS
    assert pipeline.wave_bytes([cpu]) == pipeline.WAVE_BYTES
    assert pipeline.bwt_row_groups(32, 4096, cpu) == 32
    assert pipeline.inverse_row_groups(32, 4096, cpu) == 32


# -- forced waves and groups --------------------------------------------


def test_one_wave_equals_jax(one_wave, jax_blocks, mixed):
    assert one_wave == jax_blocks
    assert one_wave == [jax_encode_block(b) for b in mixed]


@pytest.mark.parametrize("inv_mib", ["0.001", "0.002"])  # inverse groups of 1 and 2 rows
def test_forced_waves_and_groups(monkeypatch, forced, one_wave, jax_blocks, mixed, inv_mib):
    pipe, enc = forced
    assert enc == jax_blocks == one_wave
    assert pipe.reencoded_rows == 0
    _env(monkeypatch, BZ3_TPU_WAVE=5, BZ3_TPU_BWT_GROUP_ROWS=2, BZ3_TPU_INV_GROUP_MIB=inv_mib)
    pipe.timer = StageTimer(enabled=True)
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, mixed)]) == mixed
    # 9 rows: waves of 5 and 4, every wave's inverse in groups of 1 or 2 rows
    assert pipe.timer.counts["decode/cm"] == 2
    assert pipe.timer.counts["decode/bwt"] == (9 if inv_mib == "0.001" else 5)


def test_difficulty_order_keeps_the_bytes(monkeypatch, one_wave, mixed):
    """Rows reordered in a wave (here by a stand-in difficulty, as only
    rows of 4 KiB and more get one) land in their blocks again."""
    seen, real_prepass = [], pipeline.host_prepass
    real = DevicePipeline.encode_steps
    monkeypatch.setattr(pipeline, "bwt_difficulty", lambda cur: -len(cur))

    def steps(self, rows, *args):
        seen.append([len(r) for r in rows])
        return real(self, rows, *args)

    monkeypatch.setattr(DevicePipeline, "encode_steps", steps)
    assert DevicePipeline(BS, device="cpu").encode_blocks(mixed) == one_wave
    natural = [len(real_prepass(b)[3]) for b in mixed if len(b) >= 64]
    assert seen == [sorted(natural, reverse=True)]
    assert natural != seen[0]


# -- the host pool ------------------------------------------------------


def _small(n: int, seed: int = 0) -> list[bytes]:
    """n blocks that RLE collapses to a few dozen bytes."""
    rng = np.random.default_rng(seed)
    return [b"%03d the quick brown fox " % i + bytes([97 + i % 26]) * int(rng.integers(40, 370))
            for i in range(n)]


@pytest.mark.parametrize("threads", [1, 4])
def test_pool_sizes_give_the_same_blocks(threads):
    blocks = _small(6) + [b"z" * 10]
    pipe = DevicePipeline(BS, device="cpu", threads=threads)
    assert pipe.threads == threads
    enc = pipe.encode_blocks(blocks)
    assert enc == [jax_encode_block(b) for b in blocks]
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks


def test_next_waves_prepass_runs_during_a_wave(monkeypatch):
    """Wave 1's first pre-pass starts while wave 0's core runs: the core
    waits for it, and it waits for the core to have started, each with a
    timeout; a batch pre-passed before its first wave would time out."""
    _env(monkeypatch, BZ3_TPU_WAVE=2)
    blocks = _small(4, seed=3)
    core_running, next_prepass, seen = threading.Event(), threading.Event(), []
    real_prepass = pipeline.host_prepass

    def prepass(data, *args):
        if data == blocks[2]:
            next_prepass.set()
            seen.append(("prepass", core_running.wait(timeout=20)))
        return real_prepass(data, *args)

    monkeypatch.setattr(pipeline, "host_prepass", prepass)
    pipe = DevicePipeline(BS, device="cpu", threads=2)
    real_core = pipe.encode_core_fn

    def core(rows, raws):
        if not core_running.is_set():
            core_running.set()
            seen.append(("core", next_prepass.wait(timeout=20)))
        return real_core(rows, raws)

    pipe.encode_core_fn = core
    assert pipe.encode_blocks(blocks) == [jax_encode_block(b) for b in blocks]
    assert sorted(seen) == [("core", True), ("prepass", True)]


def test_engine_threads_reach_the_pool():
    from bzip3_tpu_torch.engines import get_engine

    eng = get_engine("device", 3, device="cpu")
    assert eng._pipe(BS).threads == 3
    assert get_engine("device", device="cpu")._pipe(BS).threads == (os.cpu_count() or 4)


# -- decode errors across inverse groups --------------------------------


@pytest.fixture(scope="module")
def damaged(text_data):
    """tests/test_pipeline.py's blocks at 1 KiB (its JAX decode shapes)
    with block 0's CRC broken and block 5 a sound RLE block whose output,
    1,070 bytes, passes the header check but not the block size; and the
    codes the JAX pipeline raises on it, and on block 0's damage alone."""
    rng = np.random.default_rng(7)
    bs = 1024
    blocks = [text_data[:bs], bytes(rng.integers(0, 256, bs, dtype=np.uint8)), b"ab" * (bs // 2),
              b"x" * 40, text_data[bs : 2 * bs], b"\x00" * bs,
              bytes(rng.integers(0, 16, 700, dtype=np.uint8)), b""]
    pairs = [(jax_encode_block(b), len(b)) for b in blocks]
    pairs[0] = (bytes([pairs[0][0][0] ^ 1]) + pairs[0][0][1:], pairs[0][1])
    crc_only = list(pairs)
    pairs[5] = (jax_encode_block(b"\x00" * 1070), 1070)
    want = {}
    for name, p in (("both", pairs), ("crc_only", crc_only)):
        with pytest.raises(Exception) as err:  # the JAX package's Bz3Error
            JaxPipeline(bs).decode_blocks(p)
        want[name] = err.value.code
    return {"both": pairs, "crc_only": crc_only}, want


@pytest.mark.parametrize("case,group_rows", [("both", None), ("both", "3"), ("both", "1"),
                                             ("crc_only", "1")])
def test_error_order_across_inverse_groups(monkeypatch, damaged, case, group_rows):
    cases, want = damaged
    assert want == {"both": BZ3_ERR_MALFORMED_HEADER, "crc_only": BZ3_ERR_CRC}
    if group_rows is not None:  # rows 0 and 4 (blocks 0 and 5) in different groups
        _env(monkeypatch, BZ3_TPU_BWT_GROUP_ROWS=group_rows)
    pipe = DevicePipeline(1024, device="cpu")
    pipe.timer.enabled = True
    with pytest.raises(Bz3Error) as err:
        pipe.decode_blocks(cases[case])
    assert err.value.code == want[case]
    assert pipe.timer.counts["decode/bwt"] == {None: 1, "3": 2, "1": 6}[group_rows]


# -- the sharded engine and the CLI -------------------------------------


def test_sharded_small_groups_equal_one_device(monkeypatch):
    blocks = _small(7, seed=5) + [b"q" * 20]
    one = DevicePipeline(BS, device="cpu").encode_blocks(blocks)
    _env(monkeypatch, BZ3_TPU_BWT_GROUP_ROWS=1, BZ3_TPU_INV_GROUP_MIB="0.0002")
    pipe = sharded_pipeline(BS, ["cpu", "cpu"])
    enc = pipe.encode_blocks(blocks)
    assert enc == one
    pipe.timer.enabled = True
    assert pipe.decode_blocks([(e, len(b)) for e, b in zip(enc, blocks)]) == blocks
    assert pipe.timer.counts["decode/bwt"] == 4  # two shares of 4 and 3 rows, a row a group


@pytest.mark.parametrize("cpus,jobs,want", [(5, 0, 5), (None, 0, 4), (5, 3, 3)])
def test_cli_default_batch_is_the_cpu_count(monkeypatch, tmp_path, cpus, jobs, want):
    got = []

    def fake(inp, out, *args, batch_size, **kw):
        got.append(batch_size)
        return 0, 0

    monkeypatch.setattr(cli, "compress_file", fake)
    monkeypatch.setattr(cli, "decompress_file", fake)
    monkeypatch.setattr(cli.os, "cpu_count", lambda: cpus)
    src = tmp_path / "f"
    src.write_bytes(b"abc")
    argv = ["-b", "1", "--device", "cpu", "-f"] + (["-j", str(jobs)] if jobs else [])
    assert cli.main(["-e", *argv, str(src), str(tmp_path / "f.bz3")]) == 0
    (tmp_path / "f.bz3").write_bytes(b"")
    assert cli.main(["-d", *argv, str(tmp_path / "f.bz3"), str(tmp_path / "g")]) == 0
    assert got == [want, want]
