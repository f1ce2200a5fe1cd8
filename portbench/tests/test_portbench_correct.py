"""``correct`` comes out true on the program and false on each fault the
cells can have and on the control (``harness/faults.py``), driving the
rest of a run at a small size on the CPU."""

import pytest

from portbench.harness import correct, faults

from helpers import cpu_run

CELLS = ["b16-wave.enwik9-rt", "b16-devprep.silesia-rt"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = cpu_run(cell)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("what", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, what):
    r = cpu_run(cell, wrap=faults.FAULTS[what])
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """Half-size blocks under the cell's header: lossless, decodable, and
    not bzip3's stream."""
    r = cpu_run(cell, round_trip=faults.split_round_trip)
    assert not r["correct"]
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert checks["roundtrip_bytes_wrong"] == 0 and checks["failed_ops"] == 0
    assert checks["framing_fields_wrong"] > 0


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 9])
def test_deep_blocks_take_the_longest_row(seed):
    rows = [5, 9, 3, 9, 1, 2]
    deep = correct.deep_blocks(seed, rows)
    assert rows[deep[0]] == 9 and len(set(deep)) == 1 + correct.DEEP_DRAWN
    assert deep == correct.deep_blocks(seed, rows)
