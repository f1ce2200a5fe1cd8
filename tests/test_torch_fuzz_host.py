"""The port's host C++ (``bzip3_tpu_torch/csrc/host_*.cpp``) under ASan and
UBSan: ``csrc/fuzz_host.cpp`` built with ``-O1 -g
-fsanitize=address,undefined -fno-sanitize-recover=all`` into the test's
temporary directory and run for 300 iterations (``make
fuzz-host-torch`` runs 20,000).  Any sanitizer report aborts the fuzzer;
its own checks (round trips, the pool against one block, the inverse BWT
at every index class, the LZP and RLE decoders at ``max_out`` edges)
count failures."""

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "bzip3_tpu_torch", "csrc")
SOURCES = ("fuzz_host.cpp", "host_stages.cpp", "host_bwt.cpp", "host_codec.cpp")
FLAGS = ["-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-pthread"]


def _build(tmp_path) -> str:
    """Compile the four sources at once, then link."""
    cxx = os.environ.get("CXX", "g++")
    objs = [str(tmp_path / (s[:-4] + ".o")) for s in SOURCES]
    procs = [subprocess.Popen([cxx, *FLAGS, "-c", os.path.join(CSRC, s), "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out
    exe = str(tmp_path / "fuzz_host")
    subprocess.run([cxx, *FLAGS, *objs, "-o", exe], check=True, capture_output=True, timeout=120)
    return exe


def test_fuzz_host_300_iterations_clean_under_asan_ubsan(tmp_path):
    exe = _build(tmp_path)
    env = dict(os.environ, ASAN_OPTIONS="abort_on_error=0:detect_leaks=1",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([exe, "300", "0x2545F4914F6CDD1D"], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert "300 iterations" in r.stdout and ", 0 failures" in r.stdout, r.stdout
    assert "ERROR" not in r.stderr and "runtime error" not in r.stderr, r.stderr[-4000:]
