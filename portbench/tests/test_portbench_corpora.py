"""The traffic generators: exact sizes and block counts, the same bytes
for a seed and other bytes for another, and speed."""

import json
import os
import time

import pytest

from portbench import corpora

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 16 << 20


def traffic(name):
    with open(os.path.join(PB, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,size,blocks,last", [
    ("enwik9-rt", 1_000_000_000, 60, 10_144_256),
    ("silesia-rt", 211_957_760, 13, 10_631_168),
])
def test_sizes_and_blocks(name, size, blocks, last):
    total, members = corpora.layout(traffic(name))
    assert total == size
    assert -(-total // BLOCK) == blocks and total - (blocks - 1) * BLOCK == last
    for m, (off, n, head) in zip(traffic(name)["members"], members):
        assert n == m["bytes"] and off >= len(head)


def test_silesia_members_at_published_sizes():
    t = traffic("silesia-rt")
    assert [m["name"] for m in t["members"]] == [
        "dickens", "mozilla", "mr", "nci", "ooffice", "osdb", "reymont", "samba", "sao",
        "webster", "x-ray", "xml"]
    assert sum(m["bytes"] for m in t["members"]) == 211_938_580


@pytest.mark.parametrize("name", ["enwik9-rt", "silesia-rt"])
def test_seeded(name):
    t = traffic(name)
    a = corpora.generate(t, 2**31 + 5, "cpu", scale=0.0003)
    b = corpora.generate(t, 2**31 + 5, "cpu", scale=0.0003)
    c = corpora.generate(t, 2**31 + 6, "cpu", scale=0.0003)
    assert a == b and a != c and len(a) == len(c)
    total, members = corpora.layout(t, 0.0003)
    assert len(a) == total
    for off, n, _ in members:
        assert len(set(a[off : off + n])) > 1  # every member made, none left zero


def test_tar_headers():
    t = traffic("silesia-rt")
    d = corpora.generate(t, 1, "cpu", scale=0.0003)
    for m, (off, n, head) in zip(t["members"], corpora.layout(t, 0.0003)[1]):
        h = d[off - 512 : off]
        assert h == head and h[:len(m["name"])] == m["name"].encode() and h[257:262] == b"ustar"
        assert int(h[124:135], 8) == n
        stored = int(h[148:154], 8)
        assert stored == sum(h[:148]) + 8 * 32 + sum(h[156:])


def test_text_speed():
    """A sixteenth of enwik9 on this CPU in seconds (all of it is made on
    the card in the benchmark's set-up)."""
    t = traffic("enwik9-rt")
    t0 = time.perf_counter()
    d = corpora.generate(t, 7, "cpu", scale=1 / 16)
    dt = time.perf_counter() - t0
    assert len(d) == 62_500_000
    assert dt < 30, f"{dt:.1f} s for 62.5 MB"
