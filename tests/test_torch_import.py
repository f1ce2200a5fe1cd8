"""The PyTorch port, its chip smoke script, its harnesses
(``examples/torch_*.py``) and its sanitizer lane
(``scripts/torch_sanitize.py``) import neither JAX nor the JAX package;
and an installed copy of the port finds its sources and libraries
without writing into the installed package.

``conftest.py`` imports jax into the test process, so the checks run in
a fresh interpreter; the smoke script's imports inside its functions are
read from its source as well.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

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
sys.path[:0] = ["examples", "scripts"]
harness = ["torch_harness", "torch_fuzz_decode_block", "torch_fuzz_decompress",
           "torch_fuzz_round_trip", "torch_differential_engines",
           "torch_differential_vs_reference", "torch_hl_api", "torch_sanitize"]
for name in harness:
    importlib.import_module(name)
harness_bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bzip3_tpu"))
print(json.dumps({"imported": names, "bad": bad, "harness": harness,
                  "harness_bad": harness_bad}))
"""


def _fresh_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def probe():
    """What a fresh interpreter imports: the port's every module and
    chip_smoke.py, then the harnesses and the sanitizer lane."""
    r = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT,
        env=_fresh_env(PYTHONPATH=ROOT),
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_port_imports_no_jax_and_no_jax_package(probe):
    got = probe
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


def test_harnesses_and_sanitizer_lane_import_no_jax_and_no_jax_package(probe):
    files = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
    assert len(files) == 7, files
    assert {os.path.basename(f)[:-3] for f in files} <= set(probe["harness"])
    assert "torch_sanitize" in probe["harness"]
    assert probe["harness_bad"] == [], f"the harnesses pulled in {probe['harness_bad']}"


_INSTALLED_PROBE = r"""
import json, os, sys
import bzip3_tpu_torch as b
from bzip3_tpu_torch.engines import NativeEngine
from bzip3_tpu_torch.ops import build
data = bytes(range(256)) * 40 + b"the quick brown fox jumps over the lazy dog " * 300
blob = b.compress(data, 1 << 20, engine=NativeEngine())
assert b.decompress(blob, engine=NativeEngine()) == data
try:
    build.load_kernels()
    kernels = "loaded"
except build.BuildError as e:
    kernels = "BuildError"
print(json.dumps({"pkg": os.path.dirname(b.__file__), "checkout": build.in_checkout(),
                  "build_root": build.BUILD_ROOT, "host_dir": build.HOST_DIR,
                  "host": build._libs["host"]._name, "kernels": kernels}))
"""


def _tree(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) if "__pycache__" not in d for f in fs)


def test_installed_copy_finds_its_sources_and_round_trips(tmp_path):
    """``pip install --target`` of a copy of the tree (no network, no build
    isolation): the port's CUDA and C++ sources are package data, its host
    library is built into the package, ``bzip3-torch`` is a script; from
    another directory the copy is not a checkout, loads that library,
    round-trips on the native engine, and writes nothing into the
    installed package (without a card, its kernel build raises); what it
    builds goes to the per-user cache (``build.HOST_DIR``, where a copy
    without the prebuilt library builds it)."""
    src = tmp_path / "src"
    (src / "csrc").mkdir(parents=True)
    for f in ("pyproject.toml", "setup.py", "MANIFEST.in", "README.md"):
        shutil.copy(os.path.join(ROOT, f), src / f)
    shutil.copy(os.path.join(ROOT, "csrc", "bz3n.cpp"), src / "csrc")
    skip = shutil.ignore_patterns("__pycache__", "_native_lib", "*.so")
    for pkg in ("bzip3_tpu", "bzip3_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg, ignore=skip)
    site = tmp_path / "site"
    r = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
                        "--no-build-isolation", "--target", str(site), str(src)],
                       capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    pkg = site / "bzip3_tpu_torch"
    csrc = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "bzip3_tpu_torch",
                                                                      "csrc", "*")))
    assert sorted(os.listdir(pkg / "csrc")) == csrc
    assert (pkg / "_native_lib" / "libbz3_host.so").exists()
    assert (site / "bin" / "bzip3-torch").exists()

    before = _tree(site)
    home, elsewhere = tmp_path / "home", tmp_path / "elsewhere"
    home.mkdir()
    elsewhere.mkdir()
    env = _fresh_env(PYTHONPATH=str(site), HOME=str(home), BZ3_TORCH_CACHE="",
                     XDG_CACHE_HOME="", CUDA_HOME=str(tmp_path / "no_cuda"), PATH="/usr/bin:/bin")
    r = subprocess.run([sys.executable, "-c", _INSTALLED_PROBE], cwd=elsewhere, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout)
    assert got["pkg"] == str(pkg) and not got["checkout"]
    assert got["host"] == str(pkg / "_native_lib" / "libbz3_host.so")
    assert got["build_root"].startswith(str(home / ".cache" / "bzip3_tpu_torch"))
    assert got["host_dir"] == os.path.join(got["build_root"], "torch_host")
    assert got["kernels"] == "BuildError"
    assert _tree(site) == before
