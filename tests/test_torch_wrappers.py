"""The port's shell wrappers (``bin/torch/*``, one for each of the JAX
package's ``bin/*``), which run ``python -m bzip3_tpu_torch``, here on the
CPU through the native engine: ``bz3cat`` passes its arguments to the CLI
(``--engine``, ``--device``), and ``bz3grep``, whose arguments go to grep,
takes them from ``BZ3_ENGINE`` and ``BZ3_DEVICE``, decodes and hands grep
its options and a pattern full of shell metacharacters as data."""

import io
import os
import subprocess
import sys

from bzip3_tpu_torch import compress_file
from bzip3_tpu_torch.engines import NativeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "bin", "torch")


def _stream(tmp_path, text: bytes):
    bz3 = tmp_path / "t.txt.bz3"
    with open(bz3, "wb") as out:
        compress_file(io.BytesIO(text), out, 1 << 20, engine=NativeEngine(0))
    return bz3


def _env(**kv) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BZ3_ENGINE",
                                                             "BZ3_DEVICE")}
    env.update(PYTHONPATH=ROOT, PATH=os.path.dirname(sys.executable) + os.pathsep + env["PATH"],
               **kv)
    return env


def test_bz3cat_passes_its_arguments_to_the_cli(tmp_path):
    text = b"".join(b"line %d of the stream\n" % i for i in range(400))
    bz3 = _stream(tmp_path, text)
    r = subprocess.run(["sh", os.path.join(BIN, "bz3cat"), "--engine", "native", "--device",
                        "cpu", str(bz3), str(bz3)], capture_output=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == text + text


def test_wrappers_grep_a_pattern_as_data_on_the_cpu(tmp_path):
    jax_bin = sorted(f for f in os.listdir(os.path.join(ROOT, "bin"))
                     if os.path.isfile(os.path.join(ROOT, "bin", f)))
    assert sorted(os.listdir(BIN)) == jax_bin
    canary = tmp_path / "canary"
    text = (b"alpha one\n"
            + f'beta "$(touch {canary})" `touch {canary}` ; two\n'.encode()
            + b"gamma three\n") * 50
    bz3 = _stream(tmp_path, text)
    env = _env(BZ3_ENGINE="native", BZ3_DEVICE="cpu")
    pattern = f'"$(touch {canary})" `touch'
    r = subprocess.run(["sh", os.path.join(BIN, "bz3grep"), "-n", "-F", pattern, str(bz3)],
                       capture_output=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.decode().splitlines()
    assert len(lines) == 50 and lines[0] == f'2:beta "$(touch {canary})" `touch {canary}` ; two'
    assert not canary.exists()
