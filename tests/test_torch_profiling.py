"""The port's tracing and stage timing (``bzip3_tpu_torch/utils/profiling.py``)
against the JAX package's ``utils/profiling.py``: ``trace`` writes a
``torch.profiler`` Chrome trace into its directory, ``StageTimer`` and
``DeviceEngine`` read ``BZ3_TPU_PROFILE`` as the JAX package does, and
``summary()`` prints the JAX package's lines."""

import json
import os

import pytest
import torch

from bzip3_tpu.utils.profiling import StageTimer as JaxStageTimer
from bzip3_tpu_torch.engines import DeviceEngine
from bzip3_tpu_torch.utils.profiling import StageTimer, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.int64)
    with trace(str(tmp_path / "t")) as prof:
        torch.sort(x.flip(0))
    assert prof is not None
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sort" for e in events)


@pytest.mark.parametrize("env,want", [(None, False), ("0", False), ("1", True)])
def test_stage_timer_reads_profile_variable(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("BZ3_TPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("BZ3_TPU_PROFILE", env)
    assert StageTimer().enabled is JaxStageTimer().enabled is want
    assert StageTimer(enabled=not want).enabled is (not want)
    eng = DeviceEngine(device="cpu")
    assert eng.timer.enabled is want
    assert DeviceEngine(device="cpu", profile=True).timer.enabled


def test_summary_has_the_jax_format():
    ours, theirs = StageTimer(enabled=True), JaxStageTimer(enabled=True)
    for t in (ours, theirs):
        for name, sec in (("encode/cm", 0.25), ("encode/bwt", 1.5), ("encode/cm", 0.125)):
            t.totals[name] += sec
            t.counts[name] += 1
    assert ours.summary() == theirs.summary()
    assert ours.summary().splitlines()[0].startswith("encode/bwt")


def test_engine_stages_under_profile_variable(monkeypatch):
    monkeypatch.setenv("BZ3_TPU_PROFILE", "1")
    eng = DeviceEngine(device="cpu")
    eng.encode_blocks([b"abcabd" * 30], 4096)
    assert eng.timer.counts["encode/cm"] == 1
    assert "encode/cm" in eng.timer.summary()
