"""The port's own spans and counters (``bzip3_tpu_torch/utils/profiling.py``):
``StageTimer.span`` sums host seconds over threads, an off timer records
nothing, the host pool's and the container's spans reach the timer's
totals and a ``torch.profiler`` trace, the RLE/LZP counters equal the
model bits of the blocks made, ``summary()`` prints counters, launches and
library loads only once something was counted, and the CLI prints it
under ``BZ3_TPU_PROFILE=1``.  All on the CPU, blocks of a few KiB."""

import contextlib
import io
import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bzip3_tpu_torch import cli
from bzip3_tpu_torch.container.stream import compress_file, decompress_file
from bzip3_tpu_torch.engines import DeviceEngine, NativeEngine
from bzip3_tpu_torch.models.block_codec import parse_block_header
from bzip3_tpu_torch.ops import build, native
from bzip3_tpu_torch.ops.device import cm, cm_cuda
from bzip3_tpu_torch.utils import profiling
from bzip3_tpu_torch.utils.profiling import StageTimer, trace

POOL = ["pool/encode/crc", "pool/encode/rle", "pool/encode/lzp", "pool/encode/difficulty",
        "pool/decode/lzp", "pool/decode/rle", "pool/decode/crc"]
CONTAINER = ["container/encode/read", "container/encode/write",
             "container/decode/read", "container/decode/write"]
BS = 66560  # the format's smallest block size

_rng = random.Random(5)
PHRASE = bytes(_rng.randrange(256) for _ in range(200))
# RLE and LZP both kept (the round trip's file); then runs, repeats,
# random bytes and a literal (the counters' batch)
BOTH = b"".join(bytes([97 + i % 3]) * 9 + PHRASE[:60] for i in range(40))
MIXED = [
    b"".join(bytes([97 + i % 5]) * (20 + i % 13) for i in range(150)),
    (PHRASE * 20)[:4000],
    bytes(_rng.randrange(256) for _ in range(200)),
    BOTH,
    b"tiny literal",
]


def annotations(events) -> set[str]:
    return {e.get("name") for e in events if e.get("cat") == "user_annotation"}


def main_thread_trace(fn) -> set[str]:
    """The ``record_function`` ranges of a default ``torch.profiler``
    trace (the calling thread only) around ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def host_cm_encode(data, lengths, out_width=None):
    """``cm.cm_encode_batch`` through the host C++ coder (the same bytes)."""
    rows = [native.cm_encode(data[j, :n].numpy().tobytes()) for j, n in enumerate(lengths.tolist())]
    w = out_width if out_width is not None else data.shape[1] + data.shape[1] // 8 + 64
    out = torch.zeros((len(rows), w), dtype=torch.uint8)
    for j, r in enumerate(rows):
        out[j, : min(len(r), w)] = torch.tensor(list(r[:w]), dtype=torch.uint8)
    return out, torch.tensor([len(r) for r in rows], dtype=torch.int32)


def host_cm_decode(data, in_lens, out_lens, out_width):
    """``cm.cm_decode_batch`` through the host C++ coder."""
    out = torch.zeros((data.shape[0], out_width), dtype=torch.uint8)
    for j, (m, n) in enumerate(zip(in_lens.tolist(), out_lens.tolist())):
        out[j, :n] = torch.tensor(list(native.cm_decode(data[j, :m].numpy().tobytes(), n)),
                                  dtype=torch.uint8)
    return out


@contextlib.contextmanager
def host_cm():
    """The plain CM coders replaced by the host C++ coder (the same
    bytes) inside the block: the plain coder's ops a bit step would fill
    a trace and take most of the time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cm, "cm_encode_batch", host_cm_encode)
        mp.setattr(cm, "cm_decode_batch", host_cm_decode)
        yield


def round_trip(eng, data: bytes) -> bytes:
    enc, dec = io.BytesIO(), io.BytesIO()
    compress_file(io.BytesIO(data), enc, BS, engine=eng)
    decompress_file(io.BytesIO(enc.getvalue()), dec, engine=eng)
    return dec.getvalue()


# -- host spans on the timer ------------------------------------------------


def test_spans_sum_thread_seconds_over_a_pool():
    syncs = []
    t = StageTimer(enabled=True, sync=lambda: syncs.append(1))
    start = threading.Barrier(4)

    def task(_):
        start.wait(timeout=10)
        with t.span("pool/x"):
            time.sleep(0.05)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(task, range(4)))
    wall = time.perf_counter() - t0
    assert t.counts["pool/x"] == 4 and not syncs
    assert t.totals["pool/x"] >= 4 * 0.05 * 0.95 > wall


@pytest.mark.parametrize("use", ["stage", "span", "add", "host_span"])
def test_off_timer_records_nothing(use):
    t = StageTimer(enabled=False, sync=lambda: pytest.fail("synchronised"))

    def run():
        if use == "add":
            t.add("x", 3)
        else:
            ctx = profiling.host_span(t, "x") if use == "host_span" else getattr(t, use)("x")
            with ctx:
                torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = {e.name for e in prof.events()}
    assert not t.totals and not t.counts and not t.counters
    # an off timer opens no range; host_span still names its work in a trace
    assert ("x" in names) is (use == "host_span") and "stage:x" not in names


def test_stage_is_a_range_and_keeps_its_synchronise():
    syncs = []
    t = StageTimer(enabled=True, sync=lambda: syncs.append(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage("encode/cm"):
            torch.ones(4).sum()
    assert "stage:encode/cm" in {e.name for e in prof.events()}
    assert syncs == [1] and t.counts["encode/cm"] == 1


def test_trace_records_every_thread(tmp_path):
    t = StageTimer(enabled=True)

    def task(i):
        with t.span(f"pool/t{i}"):
            torch.ones(8).sum()

    with ThreadPoolExecutor(2) as ex:
        ex.submit(lambda: None).result()
        with trace(str(tmp_path)):
            list(ex.map(task, range(2)))
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        names = annotations(json.load(fh)["traceEvents"])
    assert {"pool/t0", "pool/t1"} <= names


# -- the pool's and the container's spans in a round trip -------------------


@pytest.fixture(scope="module")
def traced_round_trip(tmp_path_factory):
    """A CPU DeviceEngine round trip of one block with RLE and LZP kept,
    its timer on, under ``trace`` with the host CM coder: (totals,
    {range: thread ids} of the trace's file)."""
    eng = DeviceEngine("cpu", profile=True)
    d = tmp_path_factory.mktemp("trace")
    with host_cm(), trace(str(d)):
        assert round_trip(eng, BOTH) == BOTH
    (f,) = os.listdir(d)
    with open(d / f) as fh:
        events = json.load(fh)["traceEvents"]
    tids: dict[str, set] = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            tids.setdefault(e["name"], set()).add(e["tid"])
    return dict(eng.timer.totals), tids


@pytest.mark.parametrize("name", POOL + CONTAINER)
def test_span_in_totals_and_trace(traced_round_trip, name):
    totals, tids = traced_round_trip
    assert totals[name] > 0 and name in tids


@pytest.mark.parametrize("name", CONTAINER + ["stage:encode/cm", "stage:decode/cm",
                                              "stage:encode/host_prepass"])
def test_range_on_the_main_thread(traced_round_trip, name):
    tids = traced_round_trip[1]
    assert tids[name] == tids["container/encode/read"] == {threading.get_native_id()}


@pytest.mark.parametrize("name", POOL)
def test_pool_ranges_on_pool_threads(traced_round_trip, name):
    assert threading.get_native_id() not in traced_round_trip[1][name]


def test_container_ranges_through_an_engine_without_timer():
    """The benchmark's kind of trace (the calling thread only) around an
    engine with no timer still holds the container's ranges."""
    got = main_thread_trace(lambda: round_trip(NativeEngine(1), BOTH))
    assert set(CONTAINER) <= got


# -- counters ---------------------------------------------------------------


@pytest.fixture(scope="module", params=["pool", "chain"])
def counted(request):
    """The mixed blocks through a CPU DeviceEngine (host passes, or the
    device prepass chain): (route, the timer's counters, the blocks)."""
    eng = DeviceEngine("cpu", profile=True, device_prepass=request.param == "chain")
    with host_cm():
        enc = eng.encode_blocks(MIXED, 4096)
        assert eng.decode_blocks([(e, len(b)) for e, b in zip(enc, MIXED)], 4096) == MIXED
    return request.param, dict(eng.timer.counters), enc


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("stage,bit", [("rle", 4), ("lzp", 2)])
def test_kept_and_rejected_equal_the_model_bits(counted, direction, stage, bit):
    route, counters, enc = counted
    models = [h.model for h in map(parse_block_header, enc) if not h.is_literal]
    kept = sum(1 for m in models if m & bit)
    assert 0 < kept < len(models)
    assert counters[f"{direction}/{route}/{stage}_kept"] == kept
    assert counters[f"{direction}/{route}/{stage}_rejected"] == len(models) - kept


@pytest.mark.parametrize("name,want", [
    ("encode/literal_blocks", 1), ("decode/literal_blocks", 1), ("encode/waves", 1),
    ("decode/waves", 1), ("encode/bwt_groups", 1), ("decode/inverse_groups", 1),
    ("encode/reencoded_rows", 0)])
def test_batch_counters(counted, name, want):
    assert counted[1][name] == want


def test_chain_groups_counted_on_the_chain_only(counted):
    route, counters, _ = counted
    assert (counters.get("encode/chain_groups"), counters.get("decode/chain_groups")) == (
        (1, 1) if route == "chain" else (None, None))


# -- summary() ----------------------------------------------------------------


def test_summary_of_stages_alone_is_unchanged(monkeypatch):
    monkeypatch.setitem(cm_cuda.LAUNCHES, "cm_encode", 3)
    monkeypatch.setattr(build, "LOADS", {"host": {"load": 0.001}})
    t = StageTimer(enabled=True)
    with t.stage("encode/bwt"):
        pass
    assert t.summary() == f"{'encode/bwt':20s} {t.totals['encode/bwt']*1e3:10.2f} ms  x1"


def test_summary_prints_counters_launches_and_loads(monkeypatch):
    monkeypatch.setitem(cm_cuda.LAUNCHES, "cm_encode", 3)
    monkeypatch.setitem(cm_cuda.LAUNCHES, "cm_decode", 0)
    monkeypatch.setattr(build, "LOADS", {"kernels": {"build": 2.5, "load": 0.004}})
    t = StageTimer(enabled=True)
    t.totals["encode/cm"] += 0.25
    t.counts["encode/cm"] += 1
    t.add("encode/waves", 2)
    lines = t.summary().splitlines()
    assert lines[0].startswith("encode/cm") and lines[1].split() == ["encode/waves", "2"]
    assert ["launches/cm_encode", "3"] in [ln.split() for ln in lines]
    assert not any("launches/cm_decode" in ln for ln in lines)
    assert lines[-2:] == [f"{'lib/kernels/build':30s} {2500.0:10.2f} ms",
                          f"{'lib/kernels/load':30s} {4.0:10.2f} ms"]
    t.clear()
    assert t.summary() == "" and not t.counters


def test_library_build_and_load_seconds(monkeypatch, tmp_path):
    host_so = build.load_host()._name
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "LOADS", {})
    target = str(tmp_path / "libcopy.so")
    build._load("copy", target, build.HOST_SOURCES,
                lambda so, sources: open(so, "wb").write(open(host_so, "rb").read()))
    assert set(build.LOADS["copy"]) == {"build", "load"}
    build._libs.clear()
    build._load("copy", target, build.HOST_SOURCES, lambda so, s: pytest.fail("rebuilt"))
    assert set(build.LOADS["copy"]) == {"load"}


# -- the operator's use: the CLI -----------------------------------------------


@pytest.mark.parametrize("profile_var", ["1", None])
def test_cli_prints_the_summary_under_profile(monkeypatch, tmp_path, capsys, profile_var):
    if profile_var is None:
        monkeypatch.delenv("BZ3_TPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("BZ3_TPU_PROFILE", profile_var)
    src = tmp_path / "f"
    src.write_bytes(BOTH)
    with host_cm():
        assert cli.main(["-e", "-b", "1", "--device", "cpu", str(src)]) == 0
        enc_err = capsys.readouterr().err
        os.remove(src)
        assert cli.main(["-d", "--device", "cpu", str(tmp_path / "f.bz3")]) == 0
        dec_err = capsys.readouterr().err
    assert src.read_bytes() == BOTH
    if profile_var is None:
        assert enc_err == dec_err == ""
        return
    for name in ("container/encode/read", "pool/encode/rle", "encode/cm", "encode/waves",
                 "encode/pool/rle_kept", "lib/host/load"):
        assert name in enc_err
    assert "container/decode/write" in dec_err and "encode/cm" not in dec_err
