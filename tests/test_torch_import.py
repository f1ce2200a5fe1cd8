"""The PyTorch port and its chip smoke script import neither JAX nor
the JAX package.

``conftest.py`` imports jax into the test process, so the check runs in
a fresh interpreter; the smoke script's imports inside its functions are
read from its source as well.
"""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import bzip3_tpu_torch
names = ["bzip3_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(bzip3_tpu_torch.__path__, "bzip3_tpu_torch.")
    if not m.name.endswith(".__main__")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "bzip3_tpu")
)
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    for name in (
        "pipeline", "cli", "ops.device.cm_cuda", "ops.host", "container.stream",
        "ops.device.crc32_cuda", "ops.device.lzp_cuda", "ops.device.rle", "ops.device.gf2",
        "ops.device.cm", "ops.build", "engines", "ops.device.stages", "ops.native",
        "models.block_codec", "container.bound", "container.frame",
        "ops.device.cm_parallel", "ops.device.cm_parallel_cuda", "utils.profiling",
        "parallel", "parallel.sharding", "parallel.multihost",
    ):
        assert f"bzip3_tpu_torch.{name}" in got["imported"]
    assert got["bad"] == [], f"port or chip_smoke.py pulled in {got['bad']}"


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "bzip3_tpu_torch" in {n.split(".")[0] for n in names}
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "bzip3_tpu")]
    assert bad == [], f"chip_smoke.py imports {bad}"
