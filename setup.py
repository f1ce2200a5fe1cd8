"""Build hook: compile the native host engines at install time.

``pip install .`` ships ``bzip3_tpu/_native_lib/libbz3n.so`` compiled
from ``csrc/bz3n.cpp`` (the reference installs libbzip3 via
autotools/CMake; this is the wheel-world equivalent).  Environments
without a C++ toolchain still install fine — the engine registry falls
back to the oracle/device paths (bzip3_tpu/engines.py).

It ships the PyTorch port's host library too,
``bzip3_tpu_torch/_native_lib/libbz3_host.so`` from the port's
``csrc/host_*.cpp`` (``bzip3_tpu_torch/ops/build.py`` loads it; without
it, the port builds its library at first use into a per-user cache).
"""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


PORT_HOST_SOURCES = ("host_stages.cpp", "host_bwt.cpp", "host_codec.cpp")


class build_py_with_native(build_py):
    def run(self):
        super().run()
        here = os.path.dirname(os.path.abspath(__file__))
        port_csrc = os.path.join(here, "bzip3_tpu_torch", "csrc")
        libs = [
            (os.path.join(self.build_lib, "bzip3_tpu", "_native_lib", "libbz3n.so"),
             [os.path.join(here, "csrc", "bz3n.cpp")], "native engine"),
            (os.path.join(self.build_lib, "bzip3_tpu_torch", "_native_lib", "libbz3_host.so"),
             [os.path.join(port_csrc, f) for f in PORT_HOST_SOURCES], "port host library"),
        ]
        # both compiles at once
        running = [(self._start(out, srcs), out, what) for out, srcs, what in libs]
        for proc, out, what in running:
            if proc is None:
                continue
            if isinstance(proc, Exception):  # toolchain-less: soft-fail
                print(f"warning: {what} build skipped ({proc})")
            elif proc.wait() == 0:
                print(f"built {what}: {out}")
            else:
                print(f"warning: {what} build failed ({proc.returncode})")

    @staticmethod
    def _start(out, sources):
        if not all(os.path.exists(s) for s in sources):
            return None
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        try:
            return subprocess.Popen([cxx, "-O3", "-fPIC", "-shared", "-pthread", *sources,
                                     "-o", out])
        except Exception as exc:
            return exc


setup(cmdclass={"build_py": build_py_with_native})
