"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window (CPU and CUDA activity), its Chrome trace written to a temporary
file under ``TMPDIR``, read back and deleted.

From it: the device's operations (kernels, copies, fills) as intervals,
and the benchmark's own spans (``record_function`` ranges) as intervals,
both on the profiler's clock in seconds."""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose ``events`` the parsed trace fills on exit
    (None when not enabled)."""
    holder = {"device": [], "spans": []}
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            holder["device"].append((short_name(e.get("name", "")), *iv))
        elif cat == "user_annotation":
            holder["spans"].append((e.get("name", ""), *iv))


def short_name(name: str) -> str:
    """A kernel's plain name: no return type, namespaces, template
    arguments or parameters (``void at::native::(anonymous
    namespace)::foo<...>(...)`` -> ``foo``)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch in "<(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    return s.split("::")[-1].strip() or name[:60]


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(merged: list[tuple[float, float]], a: float, b: float) -> float:
    """Seconds of ``merged`` (sorted, disjoint) inside [a, b]."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


def gaps(merged: list[tuple[float, float]], a: float, b: float) -> list[tuple[float, float]]:
    """The stretches of [a, b] that ``merged`` leaves uncovered."""
    out, at = [], a
    for x, y in merged:
        if y <= a or x >= b:
            continue
        if x > at:
            out.append((at, x))
        at = max(at, y)
    if at < b:
        out.append((at, b))
    return out
