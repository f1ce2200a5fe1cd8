"""The port's command line on the CPU: test (-t) and recover (-r) modes,
the engine flag, batch mode (-B) and help, as ``tests/test_cli.py``
holds the JAX package's CLI, at MiB sizes (``-b 1`` is the smallest
block the CLI takes).  The stream the port writes must equal the JAX
package's.  ``cli.main`` runs in this process, with files for its
input; one check runs ``python -m bzip3_tpu_torch`` itself.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

from bzip3_tpu.container import stream as jax_stream
from bzip3_tpu_torch.cli import main
from fixtures import sample_mixed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20
MIXED = sample_mixed()
# a 1 MiB block and a short one, both collapsed by RLE and LZP
DATA = MIXED[30000:430000] + MIXED[-400000:] + b"abcd " * 60000 + b"tail of the stream"


def cli(*args) -> int:
    """``main(args)``'s exit status, also when it exits through _die."""
    try:
        return main(list(map(str, args)))
    except SystemExit as e:
        return e.code


@pytest.fixture(scope="module")
def stream():
    buf = io.BytesIO()
    jax_stream.compress_file(io.BytesIO(DATA), buf, MiB)
    return buf.getvalue()


@pytest.fixture
def files(tmp_path, stream):
    """The input, its stream, and the stream with a payload byte of the
    first block flipped."""
    src = tmp_path / "in.txt"
    src.write_bytes(DATA)
    good = tmp_path / "good.bz3"
    good.write_bytes(stream)
    raw = bytearray(stream)
    raw[9 + 8 + 40] ^= 0xFF
    bad = tmp_path / "bad.bz3"
    bad.write_bytes(bytes(raw))
    return src, good, bad


@pytest.mark.parametrize("engine", ["native", "oracle", "auto"])
def test_engine_flag_equals_device_cpu(files, stream, engine, capfdbinary):
    src = files[0]
    assert cli("-e", "-b", 1, "-c", "--engine", engine, src) == 0
    assert capfdbinary.readouterr().out == stream


def test_device_cpu_encode_native_decode(files, stream, capfdbinary):
    src, good, _ = files
    assert cli("-e", "-b", 1, "-c", "--engine", "device", "--device", "cpu", src) == 0
    assert capfdbinary.readouterr().out == stream
    assert cli("-d", "-c", "--engine", "native", good) == 0
    assert capfdbinary.readouterr().out == DATA


def test_test_mode(files, capfdbinary):
    _, good, bad = files
    assert cli("-t", "--engine", "native", good) == 0
    assert capfdbinary.readouterr().out == b""
    assert cli("-t", "--engine", "native", "-v", bad) == 1
    assert b"bzip3: " in capfdbinary.readouterr().err


def test_recover_mode(files, capfdbinary):
    _, _, bad = files
    assert cli("-d", "-c", "--engine", "native", bad) == 1
    capfdbinary.readouterr()
    assert cli("-r", "-c", "--engine", "native", bad) == 0
    cap = capfdbinary.readouterr()
    assert len(cap.out) == len(DATA)
    assert cap.out[MiB:] == DATA[MiB:]  # the intact block
    assert cap.err.count(b"Writing invalid block.") == 1
    # without -c, recover writes the input's name less .bz3
    assert cli("-r", "--engine", "native", bad) == 0
    assert (bad.parent / "bad").read_bytes() == cap.out


def test_batch_mode_and_rm(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(DATA[:300000])
    b.write_bytes(DATA[-5000:])
    assert cli("-e", "-b", 1, "--engine", "native", "-B", a, b) == 0
    za, zb = tmp_path / "a.txt.bz3", tmp_path / "b.txt.bz3"
    assert za.exists() and zb.exists()
    a.rename(tmp_path / "a.orig")
    b.rename(tmp_path / "b.orig")
    # the second file is damaged: each file's own outcome decides its --rm
    raw = bytearray(zb.read_bytes())
    raw[-3] ^= 0xFF
    zb.write_bytes(bytes(raw))
    assert cli("-d", "--engine", "native", "--rm", "-B", za, zb) == 1
    assert a.read_bytes() == DATA[:300000]
    assert not za.exists() and zb.exists() and not b.exists()
    assert cli("-t", "--engine", "native", "-B", tmp_path / "a.orig") == 1
    assert cli("-d", "-B", tmp_path / "a.orig") == 1  # no .bz3 suffix


def test_help_and_default_device(files, capsys):
    r = subprocess.run([sys.executable, "-m", "bzip3_tpu_torch", "-h"], capture_output=True,
                       cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert r.returncode == 0 and b"Usage" in r.stdout and b"--engine" in r.stdout
    assert cli("-V") == 0 and "bzip3" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the default and sharded engines run on the card
        for engine in ("device", "sharded"):
            assert cli("-e", "-c", "--engine", engine, files[0]) == 1
            assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # argparse refuses a name not in the registry
        main(["-e", "--engine", "tpu"])
