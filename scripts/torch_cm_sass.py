#!/usr/bin/env python3
"""SASS, registers and SM clock of the port's CM kernels on the card.

    python3 scripts/torch_cm_sass.py [--out _build/cm_sass] [--mib 4]

Run from the root of a checkout on a machine with an NVIDIA Hopper card.
It builds ``bzip3_tpu_torch/csrc/*.cu`` as the port does (nvcc,
``-Xptxas -v``), then:

- prints each CM kernel's registers, shared memory and spills;
- dumps the kernels' SASS (``cuobjdump -sass``) to one file each under
  ``--out``, and for each loop of a kernel (a backward branch) counts
  its instructions by class: shared (``LDS``/``STS``), generic
  (``LD``/``ST``) and global (``LDG``/``STG``) memory, 64-bit multiply
  (``IMAD.WIDE``), branches, barriers;
- measures the dependent-chain latency, in SM cycles, of the
  instructions on a bit step (``scripts/torch_sm_latency.cu``: ``LDS``,
  ``IMAD``, the range split as a wide or a high product, the renorm
  count and shift, a select);
- times K1 and K2 (``cm_encode``/``cm_decode``) on one text row of
  ``--mib`` MiB, then K3a and K3b on the same row in launches of 1 Mi
  steps (CUDA events; ns per bit step) while sampling
  ``nvidia-smi --query-gpu=clocks.sm``, so a step can be read in SM cycles.

One JSON line per part; the last holds the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CM_KERNELS = ("cm_encode_kernel", "cm_decode_kernel", "cm_encode_resume_kernel",
              "cm_decode_resume_kernel")
CLASSES = {
    "LDS": r"^LDS\b", "STS": r"^STS\b", "LD": r"^LD\b", "ST": r"^ST\b",
    "LDG": r"^LDG\b", "STG": r"^STG\b", "IMAD.WIDE": r"^IMAD\.WIDE",
    "FLO": r"^FLO\b", "SHF": r"^SHF\b", "BRA": r"^BRA\b", "BAR": r"^BAR\b",
    "SHFL": r"^SHFL\b", "WARPSYNC": r"^WARPSYNC\b",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def sass_functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled name: [(address, instruction)]} from ``cuobjdump -sass``."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(code: list[tuple[int, str]]) -> list[dict]:
    """Each backward branch's body [target, branch] with instruction counts."""
    res = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        body = [i for a, i in code if target <= a <= addr]
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i) for i in body]
        counts = {k: sum(bool(re.match(p, o)) for o in ops) for k, p in CLASSES.items()}
        res.append({"from": hex(target), "to": hex(addr), "instructions": len(body),
                    **{k: v for k, v in counts.items() if v}})
    return res


def latencies(build, out_dir: str) -> dict:
    """Cycles per dependent step of the instruction chains in
    scripts/torch_sm_latency.cu, one thread on the card."""
    import ctypes

    import torch

    src = os.path.join(ROOT, "scripts", "torch_sm_latency.cu")
    so = os.path.join(out_dir, "libsm_latency.so")
    subprocess.run([build._nvcc(), *build.NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", src, "-o", so], check=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.sm_latency.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    buf = torch.zeros(8, dtype=torch.int64, device="cuda")
    for seed in (12345, 777):  # the first run warms up
        if lib.sm_latency(buf.data_ptr(), seed) != 0:
            raise RuntimeError("sm_latency launch failed")
        torch.cuda.synchronize()
    reps = lib.sm_latency_reps()
    names = ("lds_u16", "imad", "imad_wide_shf_r_u64_iadd", "flo_lop3_lop3", "shf_funnel_lop3",
             "isetp_sel_iadd", "imad_hi_iadd")
    cyc = buf.cpu().tolist()
    return {"part": "latency", "reps": reps,
            "cycles_per_step": {n: cyc[i] / reps for i, n in enumerate(names)}}


def time_row(mib: int) -> dict:
    """K1 and K2 on one text row, then K3a and K3b on it in launches of
    1 Mi steps, with SM clocks sampled meanwhile."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import corpus
    from bzip3_tpu_torch.ops.device import cm_cuda

    n = mib << 20
    row = torch.from_numpy(np.frombuffer(corpus(n, seed=5), np.uint8).copy())[None].cuda()
    ln = torch.tensor([n], dtype=torch.int32).cuda()
    cm_cuda.cm_encode(row[:, :4096], torch.tensor([4096], dtype=torch.int32).cuda())
    torch.cuda.synchronize()
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            clocks.append(int(_smi("clocks.sm").split()[0]))
            time.sleep(0.05)

    th = threading.Thread(target=sample)
    th.start()
    chunk = 1 << 20
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    pay, plen = cm_cuda.cm_encode(row, ln)
    ev[1].record()
    back = cm_cuda.cm_decode(pay, plen, ln, n)
    ev[2].record()
    pay3, plen3 = cm_cuda.cm_encode_resumable(row, ln, chunk_steps=chunk)
    ev[3].record()
    back3 = cm_cuda.cm_decode_resumable(pay, plen, ln, n, chunk)
    ev[4].record()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    if not torch.equal(back, row):
        raise RuntimeError("K2(K1(x)) differs on the timed row")
    m = int(plen[0])
    if not (torch.equal(plen3, plen) and torch.equal(pay3[:, :m], pay[:, :m])
            and torch.equal(back3, row)):
        raise RuntimeError("K3a or K3b differs from K1 or K2 on the timed row")
    mhz = sorted(clocks)[len(clocks) // 2] if clocks else None
    res = {"part": "timing", "bytes": n, "k3_chunk_steps": chunk,
           "sm_mhz_samples": clocks, "sm_mhz_median": mhz}
    for i, k in enumerate(("k1", "k2", "k3a", "k3b")):
        res[f"{k}_ms"] = ms = ev[i].elapsed_time(ev[i + 1])
        res[f"{k}_ns_per_bit"] = ms * 1e6 / (8 * n)
        if mhz:
            res[f"{k}_cycles_per_bit"] = res[f"{k}_ns_per_bit"] * mhz / 1e3
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "_build", "cm_sass"))
    ap.add_argument("--mib", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_cm_sass: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bzip3_tpu_torch.ops import build

    os.makedirs(args.out, exist_ok=True)
    lib = build.load_kernels()
    res = build.kernel_resources()
    emit({"part": "ptxas", "kernels": {k: res.get(k) for k in CM_KERNELS}})
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for name, code in sass_functions(sass).items():
        kern = build.kernel_name(name)
        if kern not in CM_KERNELS:
            continue
        with open(os.path.join(args.out, kern + ".sass"), "w") as f:
            f.write("\n".join(f"/*{a:04x}*/ {i}" for a, i in code) + "\n")
        emit({"part": "sass", "kernel": kern, "instructions": len(code), "loops": loops(code)})
    emit({"part": "clocks", "sm_max": _smi("clocks.max.sm")})
    emit(latencies(build, args.out))
    emit(time_row(args.mib))
    emit({"part": "card", "nvidia_smi": _smi("name,power.limit")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
