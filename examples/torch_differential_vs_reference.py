#!/usr/bin/env python
"""Differential campaign of the port's CLI against the compiled reference
binary (the port's counterpart of ``differential_vs_reference.py``).

Needs the reference bzip3 sources and a C compiler: the binary is built
once into ``_build/refbin/`` of this checkout from ``--ref DIR``, else
from ``$BZ3_REFERENCE_DIR``; no other directory is searched.  Where
neither is given, or the sources are absent there, the campaign says
which and exits 0 without a trial.  Per trial,
draw a data class and a block size, then require

  1. ``python -m bzip3_tpu_torch -e`` == ``bzip3ref -e``, byte for byte,
  2. ``bzip3ref -d`` decodes the port's stream back to the input,
  3. the port decodes the reference's stream back to the input,
  4. a corrupted copy (byte flips or truncation) gets the same accept
     or reject from both, and the same output where both accept.

The port's CLI runs ``--engine native`` by default (``--engine device``
runs the card, or ``--device cpu`` its plain versions).

    python examples/torch_differential_vs_reference.py [seed] [trials] [--ref DIR] [--engine E] [--device D]
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_harness import make_corpus  # noqa: E402

REFBIN = os.path.join(REPO, "_build", "refbin", "bzip3ref")


def reference_dir(arg: str | None = None) -> str | None:
    """The reference sources' directory: ``--ref``, else
    ``$BZ3_REFERENCE_DIR``, else None."""
    return arg or os.environ.get("BZ3_REFERENCE_DIR") or None


def ensure_refbin(ref: str | None) -> bool:
    """Build the reference binary from ``ref`` once; False where no
    directory is given or its sources are absent."""
    if os.path.exists(REFBIN):
        return True
    if not ref or not os.path.exists(os.path.join(ref, "src", "libbz3.c")):
        return False
    os.makedirs(os.path.dirname(REFBIN), exist_ok=True)
    subprocess.run(
        ["gcc", "-O2", '-DVERSION="1.5.2"', "-DPTHREAD", f"-I{ref}/include",
         f"{ref}/src/libbz3.c", f"{ref}/src/main.c", "-o", REFBIN, "-lpthread"],
        check=True, capture_output=True,
    )
    return True


def make_data(rng) -> bytes:
    """The JAX file's six data classes, draw for draw."""
    n = int(rng.integers(0, 3 << 20))
    kind = int(rng.integers(0, 6))
    if kind == 0:  # uniform random (incompressible)
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:  # runny: repeat the previous byte with prob 0.9
        if n == 0:
            return b""
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        fresh = rng.random(n) < 0.1
        fresh[0] = True
        src = np.maximum.accumulate(np.where(fresh, np.arange(n), 0))
        return raw[src].tobytes()
    if kind == 2:  # small alphabet
        return rng.integers(97, 97 + int(rng.integers(2, 8)), n, dtype=np.uint8).tobytes()
    if kind == 3:  # repeated phrase + noise
        base = rng.integers(32, 127, 257, dtype=np.uint8).tobytes()
        return (base * (n // max(1, len(base)) + 1))[:n]
    if kind == 4:  # all zeros
        return bytes(n)
    return make_corpus(n, seed=int(rng.integers(1 << 30)))  # text-like


def _opt(argv, name, default):
    if name in argv:
        i = argv.index(name)
        val = argv[i + 1]
        del argv[i : i + 2]
        return val
    return default


def main():
    argv = sys.argv[1:]
    ref = reference_dir(_opt(argv, "--ref", None))
    engine = _opt(argv, "--engine", "native")
    device = _opt(argv, "--device", "cuda")
    seed = int(argv[0]) if argv else 0
    trials = int(argv[1]) if len(argv) > 1 else 50
    if not ensure_refbin(ref):
        print(f"reference sources not found under {ref}; skipping" if ref else
              "no reference sources given (--ref DIR or $BZ3_REFERENCE_DIR); skipping")
        return 0
    with tempfile.TemporaryDirectory(prefix="bz3tdiff", dir=os.path.dirname(REFBIN)) as td:
        campaign(seed, trials, engine, device, td)
    print("all ok")
    return 0


def campaign(seed: int, trials: int, engine: str, device: str, td: str) -> None:
    rng = np.random.default_rng(seed)
    env = {**os.environ, "PYTHONPATH": REPO}
    our = [sys.executable, "-m", "bzip3_tpu_torch", "--engine", engine, "--device", device]
    for t in range(trials):
        data = make_data(rng)
        b_mib = int(rng.integers(1, 5)) if len(data) else 1
        plain = os.path.join(td, "in.bin")
        with open(plain, "wb") as f:
            f.write(data)
        ours = subprocess.run([*our, "-e", "-b", str(b_mib), "-c", plain],
                              capture_output=True, check=True, env=env).stdout
        refs = subprocess.run([REFBIN, "-e", "-b", str(b_mib), "-c"], input=data,
                              capture_output=True, check=True).stdout
        assert ours == refs, f"seed {seed} trial {t}: encode mismatch ({len(data)}B, -b {b_mib})"
        back = subprocess.run([REFBIN, "-d", "-c"], input=ours,
                              capture_output=True, check=True).stdout
        assert back == data, f"seed {seed} trial {t}: ref cannot decode our stream"
        enc_path = os.path.join(td, "in.bz3")
        with open(enc_path, "wb") as f:
            f.write(refs)
        back2 = subprocess.run([*our, "-d", "-c", enc_path], capture_output=True,
                               check=True, env=env).stdout
        assert back2 == data, f"seed {seed} trial {t}: we cannot decode ref stream"

        # corruption agreement
        if len(ours) > 16:
            b = bytearray(ours)
            if t % 3 == 0:
                b = b[: int(rng.integers(8, len(b)))]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            with open(enc_path, "wb") as f:
                f.write(bytes(b))
            r1 = subprocess.run([REFBIN, "-d", "-c", enc_path], capture_output=True)
            r2 = subprocess.run([*our, "-d", "-c", enc_path], capture_output=True, env=env)
            ok1, ok2 = r1.returncode == 0, r2.returncode == 0
            assert ok1 == ok2, f"seed {seed} trial {t}: corruption verdict split ({ok1} vs {ok2})"
            if ok1:
                assert r1.stdout == r2.stdout, f"seed {seed} trial {t}: corrupted-accept output split"
        if (t + 1) % 10 == 0:
            print(f"{t + 1}/{trials} ok", flush=True)


if __name__ == "__main__":
    sys.exit(main())
