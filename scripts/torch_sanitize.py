#!/usr/bin/env python3
"""The card's sanitizer lane for the port's CUDA kernels.

    python3 scripts/torch_sanitize.py [--tools memcheck,racecheck,synccheck,initcheck]
                                      [--timeout S] [--out _build/sanitize.json]
    python3 scripts/torch_sanitize.py --emulated [--out FILE]

Runs NVIDIA's ``compute-sanitizer`` (found as ``ops/build.py`` finds
``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``)
with ``--error-exitcode 1`` over the port on the card, each target in a
child process of this script:

- ``memcheck`` on ``examples/torch_fuzz_decode_block.py``'s campaign
  (``fuzz``: damaged blocks through ``Bz3Codec`` and both batched
  routes: K4, K2, K6) and on a small ``torch_differential_engines.py``
  run over the default, device-prepass and parallel routes (``diff``:
  K1, K2, K4, K5, K6, P1, P2);
- ``racecheck``, ``synccheck`` and ``initcheck`` on each kernel at rows
  of a few KiB (``kernels``): K1 (2 warps sharing a ring in shared
  memory, named barriers) and K2 (8 warps), K3a-K3c in launches of 256
  steps, K4, K5/K6 (text, hazards and malformed streams) and P1/P2, each
  output held to its plain version on the CPU; ``memcheck`` on them too.

The sanitizers slow a kernel by orders of magnitude, so this is a lane of
its own, not a phase of ``chip_smoke.py``.  It prints one JSON line a
tool and target: the kernels the target launched, the count of errors
(the sanitizer's ERROR SUMMARY, or racecheck's hazards), its exit code
and seconds, and ``tool_ran`` False with the sanitizer's reason where it
refused the card (compute-sanitizer 2025.2.1 answers "Device not
supported" on some virtualised H100s); then the card's ``nvidia-smi``
line.  It exits 1 if any run reported an error or did not run to its
summary, 2 without a card.  Before the tools it prints what decides
whether the tool may attach (``card_env``): the driver's version, the
MIG, virtualisation and confidential-computing fields of ``nvidia-smi
-q``, and the kernel the machine reports.

``--emulated`` is the lane that runs anywhere, on the CPU: the kernels'
CUDA source under the host emulation of ``tests/cuda_emu.h`` (the
emulated kernel tests, ``tests/test_torch_{cm,lzp,crc32,cm_parallel}_emulated.py``:
K1-K3c, K5/K6, K4, P1/P2 against their plain versions and the JAX
package's oracles) built with ``-fsanitize=address,undefined`` and run
with the sanitizers' runtime preloaded into Python.  It sees every read
or write outside the buffers a kernel is given (the global memory) and
undefined behaviour in the kernels' arithmetic; shared memory is one
array of an H100 block's most, so an access past a kernel's own share of
it stays unseen, and so do races, which only the card's racecheck sees.
One JSON line a test file: kernels, tests passed, sanitizer reports,
seconds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# what each tool runs: the harnesses under memcheck, the kernels under every tool
TARGETS = {"memcheck": ("kernels", "fuzz", "diff"), "racecheck": ("kernels",),
           "synccheck": ("kernels",), "initcheck": ("kernels",)}
# only the port's kernels are checked (PyTorch's own are not this lane's)
PORT_KERNELS = "regex=(cm_|crc_lane|lzp_|chain_windows|range_pass)"
TIMEOUT_S = 1500  # seconds a tool and target, by default


def sanitizer() -> str:
    cand = shutil.which("compute-sanitizer")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        for p in (os.path.join(home, "bin", "compute-sanitizer"),
                  os.path.join(home, "compute-sanitizer", "compute-sanitizer")):
            if os.path.exists(p):
                return p
        raise FileNotFoundError("compute-sanitizer not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return cand


# fields of ``nvidia-smi -q`` (a header's own line, or a line under one)
# that say whether a debugger-class tool may attach to the card
ENV_FIELDS = re.compile(r"(?i)\bmig\b|virtuali[sz]ation|vgpu|conf(idential)? ?compute|\bcc\b")


def _read_first_line(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.readline().strip()
    except OSError:
        return None


def card_env() -> dict:
    """The driver's version, the MIG, virtualisation and confidential-
    computing fields of ``nvidia-smi -q`` ("header/key": value), and the
    kernel's and the NVIDIA module's version lines: reads only."""

    def smi(*args):
        try:
            r = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            return None, str(e)
        return r.returncode, r.stdout + r.stderr

    _, driver = smi("--query-gpu=driver_version", "--format=csv,noheader")
    fields, header = {}, ""
    for line in (smi("-q")[1] or "").splitlines():
        if not line.strip():
            continue
        key, sep, val = line.partition(":")
        if not sep or not val.strip():
            header = key.strip()  # a section or sub-section header
            continue
        if ENV_FIELDS.search(key) or ENV_FIELDS.search(header):
            fields[f"{header}/{key.strip()}"] = val.strip()
    cc_rc, cc = smi("conf-compute", "-f")
    return {"driver_version": (driver or "").strip(), "smi_q_fields": fields,
            "conf_compute_query": {"rc": cc_rc, "out": (cc or "").strip()[-500:]},
            "proc_version": _read_first_line("/proc/version"),
            "nvidia_module": _read_first_line("/proc/driver/nvidia/version")}


# -- the child's targets -----------------------------------------------------


def _launches() -> dict:
    from bzip3_tpu_torch.ops.device import cm_cuda, cm_parallel_cuda, crc32_cuda, lzp_cuda

    return {k: v for m in (cm_cuda, crc32_cuda, lzp_cuda, cm_parallel_cuda)
            for k, v in m.LAUNCHES.items() if v}


def _rows(rows: list[bytes], width: int | None = None):
    import torch

    w = width or max(16, -(-max(map(len, rows)) // 16) * 16)
    t = torch.zeros((len(rows), w), dtype=torch.uint8)
    for i, r in enumerate(rows):
        if r:
            t[i, : len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
    return t, torch.tensor([len(r) for r in rows], dtype=torch.int32)


def _same(name: str, card, plain, lens) -> None:
    """``card`` equal to ``plain`` ([K, W] each) on each row's first
    ``lens[k]`` bytes: outputs past a row's length are left unwritten."""
    card, plain = card.cpu(), plain.cpu()
    for k, n in enumerate(lens.tolist() if hasattr(lens, "tolist") else lens):
        if not bytes(card[k, :n].numpy()) == bytes(plain[k, :n].numpy()):
            raise RuntimeError(f"{name}: row {k} differs from its plain version")


def child_kernels() -> None:
    """Every kernel once or a few times at rows of a few KiB, each held to
    its plain version on CPU copies of the same inputs."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from torch_harness import make_corpus

    from bzip3_tpu_torch.ops import host
    from bzip3_tpu_torch.ops.device import cm_cuda, cm_parallel_cuda, crc32_cuda, lzp_cuda
    from bzip3_tpu_torch.ops.device.bwt import bwt_forward_batch

    rng = np.random.default_rng(5)
    text = make_corpus(3000, seed=5)
    rows = [text[:1024], rng.integers(0, 256, 700, dtype=np.uint8).tobytes(), bytes(300)]
    data, lens = _rows(rows)
    u, _ = bwt_forward_batch(data, lens)
    cu, cl = u.cuda(), lens.cuda()
    # K1 (2 warps) and K2 (8 warps), then K3a-K3c in launches of 256 steps
    pay, plens = cm_cuda.cm_encode(cu, cl)
    want, wlens = cm_cuda.cm_encode(u, lens)
    if not torch.equal(plens.cpu(), wlens):
        raise RuntimeError("K1: payload lengths differ from the plain version's")
    _same("K1", pay, want, wlens)
    _same("K2", cm_cuda.cm_decode(pay, plens, cl, cu.shape[1]), u, lens)
    pay3, plens3 = cm_cuda.cm_encode_resumable(cu, cl, None, 256)
    if not torch.equal(plens3.cpu(), wlens):
        raise RuntimeError("K3a: payload lengths differ from K1's")
    _same("K3a", pay3, want, wlens)
    _same("K3b", cm_cuda.cm_decode_resumable(pay, plens, cl, cu.shape[1], 256), u, lens)
    pieces = [p.clone() for _, p in cm_cuda.cm_decode_stream(pay, plens, cl, cu.shape[1], 256)]
    _same("K3c", torch.cat(pieces, dim=1), u, lens)
    # K4 on raw rows, at the kernel's lane count and at 3 lanes
    raw_rows = [text[:4096], text[:1], b"", text[:2000]]
    raw, rlens = _rows(raw_rows)
    got = crc32_cuda.crc32_batch(raw.cuda(), rlens.cuda())
    if [int(x) for x in got.cpu()] != [host.crc32(r) for r in raw_rows]:
        raise RuntimeError("K4: CRCs differ from the host's")
    lanes = crc32_cuda.crc_lane_scan(raw.cuda(), rlens.cuda(), 3).cpu()
    if not torch.equal(lanes, crc32_cuda.crc_lane_scan(raw, rlens, 3)):
        raise RuntimeError("K4: lane states differ from the plain version's")
    # K5/K6: text with matches, a run of 0xF2 tokens, malformed streams
    lines = b"".join(b"GET /a/%d HTTP/1.1 200 the quick brown fox\n" % (i % 9) for i in range(90))
    src, slens = _rows([lines, text[:4096], b"\xf2" * 300 + lines[:500]])
    enc, elens = lzp_cuda.lzp_encode(src.cuda(), slens.cuda())
    want, wl = lzp_cuda.lzp_encode(src, slens)
    if not torch.equal(elens.cpu(), wl):
        raise RuntimeError("K5: stream lengths differ from the plain version's")
    _same("K5", enc, want, wl.clamp(min=0))
    e = enc.cpu()
    streams = [bytes(e[i, : max(0, int(wl[i]))].numpy()) for i in range(3)]
    streams += [s[: len(s) // 2] for s in streams]
    streams += [b"\xf2\xfe" * 40, b"ab\xf2", b"aaaaaaaa\xf2" + b"\xfe" * 300]
    st, stl = _rows(streams)
    for max_out in (4, 4096, st.shape[1] + 64):
        got, glens = lzp_cuda.lzp_decode(st.cuda(), stl.cuda(), max_out)
        want, wl = lzp_cuda.lzp_decode(st, stl, max_out)
        if not torch.equal(glens.cpu(), wl):
            raise RuntimeError(f"K6 at max_out {max_out}: lengths differ from the plain version's")
        _same(f"K6 at max_out {max_out}", got, want, wl.clamp(min=0))
    # P1/P2: the parallel encoder at small segments, against K1's payloads
    out, olens, ok = cm_parallel_cuda.cm_encode_parallel(cu, cl, seg=128)
    good = ok.cpu()
    if not bool(good.any()):
        raise RuntimeError("P1/P2: no row certified")
    for i in range(len(rows)):
        if good[i] and (int(olens[i]) != int(wlens[i])
                        or not torch.equal(out[i, : int(olens[i])].cpu(), pay[i, : int(olens[i])].cpu())):
            raise RuntimeError(f"P1/P2: row {i} differs from K1's payload")
    torch.cuda.synchronize()


def child_fuzz() -> None:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_fuzz_decode_block as fz

    fz.run(0, 30, "cuda", log=lambda *a: None)


def child_diff() -> None:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_differential_engines as de

    de.run(1, 3, "cuda", plain_row=0, log=lambda *a: None)


CHILDREN = {"kernels": child_kernels, "fuzz": child_fuzz, "diff": child_diff}


# -- the parent ---------------------------------------------------------------


EMULATED = {"test_torch_cm_emulated.py": ["K1", "K2", "K3a", "K3b", "K3c"],
            "test_torch_lzp_emulated.py": ["K5", "K6"],
            "test_torch_crc32_emulated.py": ["K4"],
            "test_torch_cm_parallel_emulated.py": ["P1", "P2"]}
EMU_FLAGS = "-O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all"


def run_emulated(test: str, timeout: int) -> dict:
    """One emulated kernel test file under ASan/UBSan (see the docstring)."""
    cxx = os.environ.get("CXX", "g++")
    runtime = subprocess.run([cxx, "-print-file-name=libasan.so"], capture_output=True,
                             text=True, check=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": runtime, "BZ3_EMU_CXXFLAGS": EMU_FLAGS,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1", "UBSAN_OPTIONS": "print_stacktrace=1"}
    t0 = time.perf_counter()
    # --capture=sys: pytest leaves file descriptor 2 alone, so that a
    # sanitizer's report (written there just before it aborts) is kept
    r = subprocess.run([sys.executable, "-m", "pytest", os.path.join("tests", test), "-q",
                        "-p", "no:cacheprovider", "--capture=sys"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    out = r.stdout + r.stderr
    passed = re.findall(r"(\d+) passed", out)
    res = {"tool": "asan+ubsan (emulated)", "target": test, "kernels": EMULATED[test],
           "rc": r.returncode, "seconds": time.perf_counter() - t0,
           "passed": int(passed[-1]) if passed else 0,
           "errors": len(re.findall(r"ERROR: AddressSanitizer|runtime error:", out))}
    if r.returncode != 0 or res["errors"]:
        res["tail"] = out[-3000:]
    return res


def _errors(tool: str, text: str) -> int | None:
    """The error count of a run's summary; None when there is none."""
    counts = [int(m) for m in re.findall(r"ERROR SUMMARY: (\d+) error", text)]
    if tool == "racecheck":
        counts += [int(m) for m in re.findall(r"RACECHECK SUMMARY: (\d+) hazard", text)]
    return sum(counts) if counts else None


def run_tool(tool: str, target: str, cs: str, timeout: int) -> dict:
    env = {**os.environ, "PYTHONPATH": ROOT}
    cmd = [cs, "--tool", tool, "--error-exitcode", "1", "--print-limit", "50",
           "--kernel-name", PORT_KERNELS, sys.executable, os.path.abspath(__file__),
           "--child", target]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=timeout)
        rc, out = r.returncode, r.stdout + r.stderr
    except subprocess.TimeoutExpired as e:
        rc, out = None, (e.stdout or b"").decode(errors="replace") + (e.stderr or b"").decode(
            errors="replace")
    secs = time.perf_counter() - t0
    m = re.findall(r"^SANITIZE_LAUNCHES (.*)$", out, re.M)
    res = {"tool": tool, "target": target, "rc": rc, "seconds": secs,
           "errors": _errors(tool, out), "launches": json.loads(m[-1]) if m else None,
           "tool_ran": "Device not supported" not in out}
    if not res["tool_ran"]:
        res["errors"] = None  # the target ran without the tool: nothing was checked
        res["reason"] = "compute-sanitizer: Device not supported"
    if rc != 0 or res["errors"] != 0:
        res["tail"] = out[-3000:]
    return res


def main() -> int:
    if "--child" in sys.argv:
        target = sys.argv[sys.argv.index("--child") + 1]
        sys.path.insert(0, ROOT)
        CHILDREN[target]()
        print("SANITIZE_LAUNCHES " + json.dumps(_launches()), flush=True)
        return 0
    args = sys.argv[1:]
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    if "--emulated" in args:
        results = [run_emulated(t, TIMEOUT_S) for t in EMULATED]
        for res in results:
            print(json.dumps({k: v for k, v in res.items() if k != "tail"}), flush=True)
            if "tail" in res:
                print(res["tail"], file=sys.stderr, flush=True)
        if out_path:
            with open(out_path, "w") as f:
                json.dump({"results": results}, f, indent=1)
        return 1 if any(r["rc"] != 0 or r["errors"] for r in results) else 0
    import torch

    if not torch.cuda.is_available():
        print("torch_sanitize: no CUDA card", file=sys.stderr)
        return 2
    tools = TOOLS
    if "--tools" in args:
        tools = tuple(args[args.index("--tools") + 1].split(","))
    timeout = int(args[args.index("--timeout") + 1]) if "--timeout" in args else TIMEOUT_S
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs = sanitizer()
    ver = subprocess.run([cs, "--version"], capture_output=True, text=True, timeout=60)
    env = card_env()
    print(json.dumps({"sanitizer": cs, "version": ver.stdout.strip().splitlines()[-1:],
                      "rc": ver.returncode}), flush=True)
    print(json.dumps({"card_env": env}), flush=True)
    results, bad = [], False
    for tool in tools:
        for target in TARGETS[tool]:
            res = run_tool(tool, target, cs, timeout)
            bad |= res["rc"] != 0 or res["errors"] != 0
            results.append(res)
            print(json.dumps({k: v for k, v in res.items() if k != "tail"}), flush=True)
            if "tail" in res:
                print(res["tail"], file=sys.stderr, flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": smi, "card_env": env, "results": results}, f, indent=1)
    print(smi, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
