"""The readers of the program's own spans (``host_pool_s.encode``,
``container_{read,write}_s.{encode,decode}``) on hand-made readings: the
value they should give, and None where the program has no such span (a
parent without them)."""

import pytest

from portbench.harness import spec
from portbench.metrics.context import Ctx

OPS = [{"enc_s": 1.0, "dec_s": 1.0}] * 2
# two ops: op.encode [0, 10] and [20, 30], op.decode [10, 20] and [30, 40]
OP_SPANS = [("op.encode", 0.0, 10.0), ("op.decode", 10.0, 20.0),
            ("op.encode", 20.0, 30.0), ("op.decode", 30.0, 40.0)]
PROGRAM = [
    ("container/encode/read", 0.5, 1.0), ("container/encode/read", 1.0, 1.25),
    ("container/encode/write", 9.0, 9.5), ("container/encode/read", 20.0, 20.5),
    ("container/encode/write", 29.0, 30.0),
    ("container/decode/read", 10.0, 10.25), ("container/decode/write", 19.0, 19.75),
    ("container/decode/read", 30.0, 30.75), ("container/decode/write", 39.0, 39.25),
    ("container/encode/read", 50.0, 51.0),  # outside every op: not counted
]
POOL = {"pool/encode/crc": 0.5, "pool/encode/rle": 1.0, "pool/encode/lzp": 2.0,
        "pool/encode/difficulty": 0.5, "pool/decode/lzp": 9.0, "encode/host_prepass": 7.0}


def ctx(spans, stages):
    return Ctx(OPS, stages, [], spans, [], [])


@pytest.mark.parametrize("metric,want", [
    ("container_read_s.encode", (0.75 + 0.5) / 2),
    ("container_write_s.encode", (0.5 + 1.0) / 2),
    ("container_read_s.decode", (0.25 + 0.75) / 2),
    ("container_write_s.decode", (0.75 + 0.25) / 2),
    ("host_pool_s.encode", 4.0 / 2),
])
def test_reader_value_and_none_without_its_spans(metric, want):
    read = spec.reader(metric)
    assert read(ctx(OP_SPANS + PROGRAM, POOL)) == pytest.approx(want)
    assert read(ctx(OP_SPANS, {"encode/host_prepass": 7.0})) is None


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_container_spans_within_container_s(direction):
    spans = OP_SPANS + PROGRAM + [("engine." + direction, 2.0, 8.0),
                                  ("engine." + direction, 22.0, 28.0)]
    c = ctx(spans, {})
    parts = sum(spec.reader(f"container_{w}_s.{direction}")(c) for w in ("read", "write"))
    assert parts <= c.container_s(direction)
