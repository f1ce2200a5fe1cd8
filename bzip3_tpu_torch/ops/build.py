"""Build and load the port's native libraries at first use.

Two shared libraries, each with a plain C interface loaded by ctypes:

- ``libbz3_host.so``: the host pre/post passes (CRC32-C, RLE, LZP) from
  ``csrc/host_stages.cpp``, the host BWT (SA-IS forward, quad-merge
  inverse) from ``csrc/host_bwt.cpp`` and the host CM coder, block codec
  and pthread block pool from ``csrc/host_codec.cpp``, compiled with
  ``g++ -pthread``.  Host code on every machine.
- ``libbz3_kernels.so``: the hand-written CUDA kernels from
  ``csrc/*.cu`` (and the headers ``csrc/*.cuh`` they share), compiled
  with ``nvcc`` for ``sm_90a`` (Hopper).  Each ``.cu`` compiles to its
  own object in parallel, then one link.

Where they go (``BUILD_ROOT``): in a checkout of the repository (the
package's parent holds ``pyproject.toml``), ``_build/`` at its root
(listed in ``.gitignore``).  In an installed copy, a per-user cache
directory, ``$BZ3_TORCH_CACHE``, else ``$XDG_CACHE_HOME/bzip3_tpu_torch``
or ``~/.cache/bzip3_tpu_torch``, one subdirectory for each installed
copy; never the installed package.  An installed copy loads the host
library that ``pip install`` built into ``_native_lib/`` of the package
(``setup.py``) and builds only what it lacks.  A library is rebuilt when
a source or header is newer than it.  A build or load failure raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# the host library ``pip install`` builds into an installed copy (setup.py)
PREBUILT_HOST = os.path.join(_PKG, "_native_lib", "libbz3_host.so")


def in_checkout(pkg: str = _PKG) -> bool:
    """Whether the package lies in a checkout of the repository."""
    return os.path.exists(os.path.join(os.path.dirname(pkg), "pyproject.toml"))


def cache_root(pkg: str = _PKG) -> str:
    """The per-user build directory of an installed copy at ``pkg``."""
    base = os.environ.get("BZ3_TORCH_CACHE") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "bzip3_tpu_torch")
    return os.path.join(base, hashlib.sha256(os.path.abspath(pkg).encode()).hexdigest()[:16])


BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "_build") if in_checkout() else cache_root()
KERNEL_DIR = os.path.join(BUILD_ROOT, "torch_kernels")
HOST_DIR = os.path.join(BUILD_ROOT, "torch_host")

NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
HOST_SOURCES = [os.path.join(CSRC, f) for f in ("host_stages.cpp", "host_bwt.cpp", "host_codec.cpp")]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A native library failed to compile or load."""


def _stale(target: str, sources: list[str]) -> bool:
    if not os.path.exists(target):
        return True
    t = os.path.getmtime(target)
    return any(os.path.getmtime(s) > t for s in sources)


def _run(cmds: list[list[str]], log_path: str) -> None:
    """Run compile commands in parallel; raise with their output on failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    with open(log_path, "a") as f:
        for c, o in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + o + "\n")
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise BuildError(f"{' '.join(c)} failed ({p.returncode}):\n{o}")


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise BuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return cand


def _build_kernels(so: str, sources: list[str]) -> None:
    os.makedirs(KERNEL_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f".{os.getpid()}.tmp"
    log = os.path.join(KERNEL_DIR, "build.log")
    open(log, "w").close()
    # nvcc picks its action by suffix, so the objects end in ".o"
    objs = [
        os.path.join(KERNEL_DIR, os.path.basename(s)[:-3] + tag + ".o") for s in sources
    ]
    _run(
        [
            [nvcc, *NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", s, "-o", o]
            for s, o in zip(sources, objs)
        ],
        log,
    )
    _run([[nvcc, *NVCC_ARCH, "-shared", *objs, "-o", so + tag]], log)
    for o in objs:
        os.remove(o)
    os.replace(so + tag, so)


def _build_host(so: str, sources: list[str]) -> None:
    os.makedirs(HOST_DIR, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    _run(
        [[cxx, "-O3", "-march=native", "-fPIC", "-shared", "-pthread", *sources,
          "-o", so + tag]],
        os.path.join(HOST_DIR, "build.log"),
    )
    os.replace(so + tag, so)


def _load(name: str, so: str, sources: list[str], compile_fn, headers=()) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not sources:
            raise BuildError(f"no sources for {name} under {CSRC}")
        if so != PREBUILT_HOST and _stale(so, [*sources, *headers]):
            try:
                compile_fn(so, sources)
            except OSError as e:  # an unwritable build directory
                raise BuildError(f"cannot build {so}: {e}") from e
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise BuildError(f"cannot load {so}: {e}") from e
        _libs[name] = lib
        return lib


def load_host() -> ctypes.CDLL:
    """The host stage library (g++), built on first use; in an installed
    copy the one ``pip install`` built, where it is there."""
    so = os.path.join(HOST_DIR, "libbz3_host.so")
    if not in_checkout() and os.path.exists(PREBUILT_HOST):
        so = PREBUILT_HOST
    return _load("host", so, HOST_SOURCES, _build_host)


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernel library (nvcc, sm_90a), built on first use."""
    return _load(
        "kernels",
        os.path.join(KERNEL_DIR, "libbz3_kernels.so"),
        sorted(glob.glob(os.path.join(CSRC, "*.cu"))),
        _build_kernels,
        glob.glob(os.path.join(CSRC, "*.cuh")),
    )


def kernel_build_log() -> str:
    """Compiler output of the last kernel build (``-Xptxas -v`` lines)."""
    path = os.path.join(KERNEL_DIR, "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def kernel_name(mangled: str) -> str:
    """The plain name of a kernel from its mangled one: the last of the
    length-prefixed names after ``_Z``/``_ZN`` (``_ZN46_GLOBAL__N__..._cu_
    8a0719b516cm_encode_kernelE...`` -> ``cm_encode_kernel``)."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, name = m.end(), mangled
    while (d := re.match(r"\d+", mangled[i:])) is not None:
        i += d.end()
        name = mangled[i : i + int(d.group())]
        i += int(d.group())
        if not m.group().endswith("N"):
            break
    return name


def kernel_resources(log: str | None = None) -> dict[str, dict[str, int]]:
    """{kernel: {registers, smem, spill_stores, spill_loads}} of each
    ``__global__`` function, from the ``-Xptxas -v`` lines of a build log
    (default: the last kernel build's).  ``smem`` is static shared
    memory; the kernels' tables are dynamic."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for ln in (kernel_build_log() if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            s = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)), smem=int(s.group(1)) if s else 0)
    return out
