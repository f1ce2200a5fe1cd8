"""One run of one cell: set-up, the window, the readings, the checks.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit, which are also the last lines of standard
error.  Without a card, or with fewer cards than the cell asks for, it
exits 2 and prints no result; if JAX or the JAX package was loaded, 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from . import correct, spans as sp, spec, trace as tr, window
from .. import corpora

MiB = 1 << 20
WARMUP_BYTES = 1 << 20
FOREIGN = ("jax", "jaxlib", "flax", "bzip3_tpu")


def log(*a) -> None:
    print("portbench:", *a, file=sys.stderr, flush=True)


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: ``bzip3_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (a card set below
    its 700 W runs slower under load)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30, check=True)
        return float(r.stdout.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def make_engine(config: dict, device: str, traced: bool):
    """The program under test: a ``DeviceEngine`` with the
    configuration's route, its stage timer on only when traced."""
    from bzip3_tpu_torch.engines import DeviceEngine

    e = config["engine"]
    return DeviceEngine(device, profile=traced, device_prepass=e["device_prepass"],
                        host_crc=e["host_crc"], device_crc_verify=e["device_crc_verify"],
                        n_threads=e["threads"])


def _sync(device: str):
    import torch

    if device.startswith("cuda"):
        return torch.cuda.synchronize
    return lambda: None


def _workload_bytes(stream: bytes) -> tuple[list[int], list[int]]:
    """Each compressed block's CM row and payload bytes, from a stream."""
    from ..reference import stream as ref

    try:
        _, _, blocks = ref.parse(stream)
    except ValueError:
        return [], []
    rows, pays = [], []
    for b in blocks:
        if b["index"] != -1:
            rows.append(ref.size_before_bwt(b))
            pays.append(b["at"] + b["csize"] - b["payload_at"])
    return rows, pays


def breakdown(ctx) -> dict:
    """The device's operations that took most time, and the longest idle
    stretches summed by the innermost benchmark span open at the time."""
    ops: dict[str, float] = {}
    lo = min((a for n, a, _ in ctx.spans if n.startswith("op.")), default=0.0)
    hi = max((b for n, _, b in ctx.spans if n.startswith("op.")), default=0.0)
    for name, a, b in ctx.device:
        if b > lo and a < hi:
            ops[name] = ops.get(name, 0.0) + min(b, hi) - max(a, lo)
    idle: dict[str, float] = {}
    named = sorted(ctx.spans, key=lambda s: s[1])
    for d in ("encode", "decode"):
        for a, b in ctx.op_spans(d):
            for x, y in tr.gaps(ctx.busy, a, b):
                mid = (x + y) / 2
                inner = [s for s in named if s[1] <= mid <= s[2]]
                name = max(inner, key=lambda s: s[1])[0] if inner else "op." + d
                idle[name] = idle.get(name, 0.0) + (y - x)

    def top(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def run_cell(name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
             root: str = spec.ROOT, scale: float = 1.0, block_size: int | None = None,
             engine_factory=None, wrap=None, round_trip=None, min_ops: int = 1,
             t0: float | None = None) -> dict:
    """The result of one run (its last key ``checks``).  ``wrap`` puts a
    wrapper around the program's engine and ``round_trip`` replaces the
    window's op (the faults and the control of ``faults``); the
    benchmark's own runs use neither."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from ..metrics.context import Ctx

    bench = spec.load(root)
    cell = spec.cell(bench, name, root)
    cfg, traffic = cell["config"], cell["traffic"]
    bs = block_size or cfg["block_size"]
    t_gen = time.perf_counter()
    data = corpora.generate(traffic, seed, device, scale)
    t_gen = time.perf_counter() - t_gen
    nblocks = window.blocks_of(len(data), bs)
    engine = (engine_factory or make_engine)(cfg, device, traced)
    spans = sp.Spans(traced)
    if traced and hasattr(engine, "timer"):
        engine.timer = sp.SpanTimer(engine.timer, spans)
    sync = _sync(device)
    t_warm = time.perf_counter()
    warm = window.round_trip(data[:WARMUP_BYTES], bs, sp.SpanEngine(engine, spans), spans, sync)
    if warm["error"] is not None or warm["decoded"] != data[:WARMUP_BYTES]:
        raise RuntimeError(f"warm-up round trip failed: {warm['error'] or 'bytes differ'}")
    if hasattr(engine, "timer"):
        engine.timer.totals.clear()
        engine.timer.counts.clear()
    spans.clear()
    t_warm = time.perf_counter() - t_warm
    eng = sp.SpanEngine(wrap(engine) if wrap else engine, spans)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    with tr.profiled(traced) as holder:
        ops, w0, w1 = window.run(data, bs, eng, spans, sync, seconds, round_trip, min_ops)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    timer = getattr(engine, "timer", None)
    stages = dict(timer.totals) if timer else {}
    del engine, eng, timer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for i, op in enumerate(ops[:50]):
        log(f"op {i}: encode {op['enc_s']:.4f} s, decode {op['dec_s']:.4f} s, "
            f"{op['in_bytes']} bytes -> {len(op['stream'])}" + (f", {op['error']}" if op["error"] else ""))
    log(f"file {len(data)} bytes, {nblocks} blocks; set-up {setup_s:.3f} s (making the file "
        f"{t_gen:.3f} s, warm-up round trip {t_warm:.3f} s); "
        f"window {w1 - w0:.3f} s of {seconds} s; peak {peak} bytes allocated")

    good = [op for op in ops if op["error"] is None]
    enc_s = sum(op["enc_s"] for op in good)
    dec_s = sum(op["dec_s"] for op in good)
    metrics: dict[str, dict] = {}
    rows, pays = _workload_bytes(good[0]["stream"]) if good else ([], [])
    if traced:
        ctx = Ctx(good, stages, holder["device"], holder["spans"], rows, pays)
        for m in cell["per_layer"]:
            v = spec.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "encode_MiBs": sum(op["in_bytes"] for op in good) / MiB / enc_s if enc_s else None,
            "decode_MiBs": sum(len(op["decoded"]) for op in good) / MiB / dec_s if dec_s else None,
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            if e2e[m["name"]] is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["workload"]["chips"] if cuda else 0,
           "memory_peak_bytes": peak, "power_limit_w": power_limit_w() if cuda else None}
    if traced:
        op_ivs = [(a, b) for n, a, b in holder["spans"] if n.startswith("op.")]
        lo = min((a for a, _ in op_ivs), default=0.0)
        hi = max((b for _, b in op_ivs), default=0.0)
        dev["busy_s"] = tr.overlap(ctx.busy, lo, hi)
        dev["window_s"] = hi - lo
        log("stages s an op:", json.dumps({k: v / max(1, len(good)) for k, v in sorted(stages.items())}))
        log("cm rows", sum(rows), "bytes in", len(rows), "rows, longest", max(rows, default=0),
            "; payloads", sum(pays), "bytes")
    t_chk = time.perf_counter()
    checks = correct.checks(data, ops, bs, seed)
    log(f"checks {time.perf_counter() - t_chk:.3f} s; run {time.perf_counter() - t0:.3f} s")
    ok = bool(ops) and all(v <= lim for v, lim in checks.values())
    result = {"correct": ok, "attempted": len(ops),
              "failed": sum(1 for op in ops if op["error"] is not None or op["decoded"] != data),
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = breakdown(ctx)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def emit(result: dict) -> None:
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv: list[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    import torch

    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = foreign_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}: no result")
        return 3
    emit(result)
    return 0
