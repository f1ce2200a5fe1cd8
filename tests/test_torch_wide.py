"""The device-block cap and the wave planner of the port's pipeline on
faked cards (``pipeline._card`` patched, as ``test_torch_waves.py`` does):
which block sizes take the wave path and which the host-BWT hybrid, on
the default path and under the device prepass, and that every planned
wave of wide rows fits the card's planned share of memory on the encode
side (the forward BWT's widest group), on the decode side (the
inverse's), under the device prepass (the chain's), and with two shares
of one card running their groups at once.  No tensor is made:
arithmetic on the planners only.
"""

import types

import pytest
import torch

from bzip3_tpu_torch import pipeline
from bzip3_tpu_torch.container.bound import BLOCK_SIZE_MAX, MiB
from bzip3_tpu_torch.pipeline import DevicePipeline

H100 = int(79.2 * (1 << 30))  # an H100 80GB's total_memory
SMALL = 16 << 30  # a card of 16 GiB
CARD = torch.device("cuda", 0)
CAP_VARS = ("BZ3_TPU_MAX_DEVICE_BLOCK_MIB", "BZ3_TPU_FORCE_OVERSIZE", "BZ3_TPU_WAVE",
            "BZ3_TPU_WAVE_MIB", "BZ3_TPU_BWT_GROUP_MIB", "BZ3_TPU_BWT_GROUP_ROWS",
            "BZ3_TPU_INV_GROUP_MIB")


@pytest.fixture(autouse=True)
def _no_vars(monkeypatch):
    for v in CAP_VARS:
        monkeypatch.delenv(v, raising=False)


def _fake_card(monkeypatch, total: int) -> None:
    monkeypatch.setattr(pipeline, "_card", lambda dev: types.SimpleNamespace(
        multi_processor_count=132, total_memory=total))


def _plan(width: int, n: int = 200, prepass: bool = False, shares: int = 1) -> list[list]:
    """The waves ``DevicePipeline._waves`` makes of ``n`` rows of ``width``
    bytes on one card, in ``shares`` shares, at blocks of ``width``."""
    pipe = object.__new__(DevicePipeline)
    pipe.mesh, pipe.device_prepass, pipe.width = [CARD] * shares, prepass, width
    return pipe._waves(list(range(n)), lambda i: width)


def _widest_admitted(chain: bool = False) -> int:
    """The widest padded row (a multiple of 256) the wave path takes on
    the faked card."""
    lo, hi = 256, 1 << 40
    while hi - lo > 256:
        mid = (lo + hi) // 512 * 256
        lo, hi = (mid, hi) if not pipeline.oversize_block(mid, CARD, chain) else (lo, mid)
    return lo


def test_format_max_on_an_h100(monkeypatch):
    _fake_card(monkeypatch, H100)
    for chain in (False, True):  # the default path and the device prepass
        assert not pipeline.oversize_block(BLOCK_SIZE_MAX, CARD, chain)
        assert _widest_admitted(chain) >= BLOCK_SIZE_MAX
        for mib in (16, 128, 129, 144, 256):
            assert not pipeline.oversize_block(mib * MiB, CARD, chain)


def test_format_max_on_a_16_gib_card(monkeypatch):
    _fake_card(monkeypatch, SMALL)
    assert pipeline.oversize_block(BLOCK_SIZE_MAX, CARD)
    assert not pipeline.oversize_block(128 * MiB, CARD)
    cap = _widest_admitted()
    assert 128 * MiB < cap < BLOCK_SIZE_MAX
    # the rule is on the padded row
    assert not pipeline.oversize_block(cap, CARD)
    assert pipeline.oversize_block(cap + 1, CARD)
    # the device chain's group peaks above the BWT's: it admits less
    chain_cap = _widest_admitted(chain=True)
    assert 128 * MiB < chain_cap < cap
    assert pipeline.oversize_block(chain_cap + 1, CARD, chain=True)
    assert not pipeline.oversize_block(chain_cap + 1, CARD)


@pytest.mark.parametrize("total", [H100, SMALL], ids=["80GB", "16GiB"])
def test_cap_variable_overrides_both_ways(monkeypatch, total):
    _fake_card(monkeypatch, total)
    monkeypatch.setenv("BZ3_TPU_MAX_DEVICE_BLOCK_MIB", "32")
    assert pipeline.oversize_block(40 * MiB, CARD)
    assert not pipeline.oversize_block(32 * MiB, CARD)
    monkeypatch.setenv("BZ3_TPU_MAX_DEVICE_BLOCK_MIB", "600")
    assert not pipeline.oversize_block(BLOCK_SIZE_MAX, CARD)
    # the variable alone never sends the CPU to the hybrid
    monkeypatch.setenv("BZ3_TPU_MAX_DEVICE_BLOCK_MIB", "0.0005")
    assert not pipeline.oversize_block(1024, "cpu")
    assert pipeline.oversize_block(1024, CARD)


def test_forced_hybrid(monkeypatch):
    """BZ3_TPU_FORCE_OVERSIZE=1 reads the JAX package's cap of 128 MiB
    on any device; on the CPU nothing else selects the hybrid."""
    _fake_card(monkeypatch, H100)
    assert not pipeline.oversize_block(BLOCK_SIZE_MAX, "cpu")
    monkeypatch.setenv("BZ3_TPU_FORCE_OVERSIZE", "1")
    for dev in (CARD, torch.device("cpu")):
        assert pipeline.oversize_block(129 * MiB, dev)
        assert not pipeline.oversize_block(128 * MiB, dev)
    assert DevicePipeline(BLOCK_SIZE_MAX, device="cpu").oversize
    monkeypatch.delenv("BZ3_TPU_FORCE_OVERSIZE")
    assert not DevicePipeline(BLOCK_SIZE_MAX, device="cpu").oversize


@pytest.mark.parametrize("setup", ["default", "prepass", "two_shares"])
@pytest.mark.parametrize("peaks", [None, (110, 80)], ids=["measured", "int64"])
@pytest.mark.parametrize("total", [H100, SMALL], ids=["80GB", "16GiB"])
@pytest.mark.parametrize("mib", [160, 256, 511])
def test_wide_waves_fit_the_card(monkeypatch, mib, total, peaks, setup):
    """Every wave of rows of ``mib`` MiB that the card admits: its rows'
    resident bytes plus the peak of its widest forward group (encode) or
    inverse group (decode) within ``MEM_SHARE`` of the card; under the
    device prepass also its widest chain group; with two shares of the
    card, each share's groups at once.  Also at the peaks of the BWT's
    int64 version (110 and 80 bytes a byte), where a 511 MiB row outgrew
    a group's budget."""
    _fake_card(monkeypatch, total)
    if peaks is not None:
        monkeypatch.setattr(pipeline, "BWT_PEAK_BYTES", peaks[0])
        monkeypatch.setattr(pipeline, "INV_PEAK_BYTES", peaks[1])
    width = mib * MiB
    prepass, shares = setup == "prepass", 2 if setup == "two_shares" else 1
    if pipeline.oversize_block(width, CARD, prepass):  # the hybrid's, one block at a time
        assert total == SMALL  # an H100 80GB takes every width
        return
    waves = _plan(width, prepass=prepass, shares=shares)
    assert sum(map(len, waves)) == 200
    share = total * pipeline.MEM_SHARE
    for wave in waves:
        k = len(wave)
        resident = k * width * pipeline.RESIDENT_BYTES
        busy = min(shares, k)  # shares that hold a row
        part = -(-k // busy)  # a share's rows
        fwd = pipeline.bwt_row_groups(part, width, CARD)
        inv = pipeline.inverse_row_groups(part, width, CARD)
        assert resident + busy * fwd * width * pipeline.BWT_PEAK_BYTES <= share
        assert resident + busy * inv * width * pipeline.INV_PEAK_BYTES <= share
        assert fwd * width < 1 << 31  # the BWT's int32 ranks
        if prepass:
            chain = pipeline.chain_row_groups(k, width, CARD)
            assert resident + chain * width * pipeline.CHAIN_PEAK_BYTES <= share
            assert chain * width < 1 << 31
    if mib == 511 and total == H100 and peaks is None:
        assert len(waves[0]) > 1  # several rows a wave on the H100


def test_b16_plan_unchanged_and_b128_waves(monkeypatch):
    """The plan at -b 16 on an H100 80GB: 132 rows a wave (the SMs
    bind), forward groups of 18 rows, inverse groups of 4; at -b 128 the
    memory binds, and the wave holds no fewer rows than the 52 it held
    at 110 bytes a byte."""
    _fake_card(monkeypatch, H100)
    assert [len(w) for w in _plan(16 * MiB)] == [132, 68]
    assert pipeline.bwt_row_groups(132, 16 * MiB, CARD) == 18
    assert pipeline.inverse_row_groups(132, 16 * MiB, CARD) == 4
    waves = _plan(128 * MiB)
    assert 52 <= len(waves[0]) < 132
    assert pipeline.bwt_row_groups(len(waves[0]), 128 * MiB, CARD) == 2
    assert pipeline.inverse_row_groups(len(waves[0]), 128 * MiB, CARD) == 1
