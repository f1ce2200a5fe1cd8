"""Cells, configurations, traffic and per-layer metrics are found by name
in files of their own: a fifth cell and a new metric come as new files
plus entries.  And the result line's shape, the refusal without a card,
and the names and units BENCHMARK.json allows."""

import json
import os
import re
import shutil

import pytest

from portbench.harness import main as hm
from portbench.harness import spec

from helpers import cpu_run

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    return spec.load(ROOT)


def test_fifth_cell_and_new_metric_as_new_files(tmp_path):
    root = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: (root / p).read_bytes() for p in
              [os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs]
              if p != "BENCHMARK.json"}
    # new files: a traffic mix, a configuration, a metric's reader
    (root / "portbench/traffic/logs-rt.json").write_text(json.dumps({
        "name": "logs-rt", "source": "a test", "op": "round_trip",
        "members": [{"name": "access.log", "bytes": 300000, "class": "lines", "table_seed": 1,
                     "params": {"fields": [{"numbers": [1, 254]}, {"literal": " - - GET "},
                                           {"paths": {"count": 50, "parts": [2, 4], "suffixes": [".html"],
                                                      "words": {"count": 40, "min_len": 3, "max_len": 8}},
                                            "zipf": 1.3},
                                           {"literal": " HTTP/1.1\n"}]}}]}))
    (root / "portbench/configs/b1-test.json").write_text(json.dumps({
        "name": "b1-test", "block_size": 1 << 20, "batch": "file",
        "engine": {"device_prepass": False, "host_crc": True, "device_crc_verify": False, "threads": 2}}))
    (root / "portbench/metrics/ops_in_window.py").write_text("def read(ctx):\n    return ctx.n_ops\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "b1-test", "source": "a test", "file": "portbench/configs/b1-test.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "b1-test.logs-rt", "config": "b1-test", "traffic": "logs-rt",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "ops_in_window", "unit": "ops", "better": "higher",
                           "source": "program_counter", "layer": "container", "moves": "encode_MiBs",
                           "workloads": ["b1-test.logs-rt"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for p, data in before.items():
        assert (root / p).read_bytes() == data
    r = cpu_run("b1-test.logs-rt", root=str(root), scale=1.0, traced=True)
    assert r["correct"] and r["metrics"]["ops_in_window"]["value"] == r["attempted"] >= 1
    r = cpu_run("b1-test.logs-rt", root=str(root), scale=1.0)
    assert r["correct"] and set(r["metrics"]) == {"encode_MiBs", "decode_MiBs", "setup_s"}


def test_result_line_keys():
    r = cpu_run("b16-wave.enwik9-rt")
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    r = cpu_run("b16-wave.enwik9-rt", traced=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    # no card here: the readers of the device trace find nothing and are left out
    assert "container_s.encode" in r["metrics"] and "cm_kernel_s.encode" not in r["metrics"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = hm.main(["--workload", "b16-wave.enwik9-rt", "--seed", "1", "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA card" in out.err


def test_no_program_no_result(tmp_path):
    import subprocess
    import sys

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "b16-wave.enwik9-rt",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    for item in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and os.path.exists(os.path.join(ROOT, "portbench/metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and w["name"] == f"{w['config']}.{w['traffic']}"
        assert os.path.exists(os.path.join(ROOT, "portbench/traffic", w["traffic"] + ".json"))
        c = spec.cell(b, w["name"])
        assert c["per_layer"], w["name"]
    for m in b["per_layer"]:
        assert set(m.get("workloads", [])) <= names
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    assert len(json.dumps(b)) < 64 << 10
