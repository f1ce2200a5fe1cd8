"""What ``BENCHMARK.json`` names, found by name in files of its own.

A cell (an entry of ``workloads``) names a configuration (an entry of
``configs``, whose ``file`` holds it) and a traffic mix
(``portbench/traffic/<traffic>.json``).  A per-layer metric is read by
``portbench/metrics/<name>.py``'s ``read(ctx)``.  Adding any of them is
adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name``: its entry, configuration, traffic, and the
    metrics it reports: every end-to-end metric, and the per-layer metrics
    whose ``workloads`` list it."""
    wl = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "configuration")
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {"workload": wl, "config": config, "traffic": traffic,
            "end_to_end": bench["end_to_end"], "per_layer": per_layer}


def reader(metric: str, root: str = ROOT):
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
