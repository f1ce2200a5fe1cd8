"""bzip3-compatible command line for the PyTorch/CUDA port.

    python -m bzip3_tpu_torch -e|-d [-b N] [-j N] [-c] [-f] [-k] [--rm]
                              [-v] [--device cuda|cpu] [input [output]]

The flags follow the reference CLI (src/main.c:553-585) for encode and
decode; test (-t) and recover (-r) are not in the port yet.  Blocks run
on the card unless ``--device cpu`` is given.  File naming follows the
reference: encode appends ``.bz3`` (src/main.c:747-770), decode requires
it unless writing to standard output, and compressed data is never
written to a terminal (src/main.c:161-165).
"""

from __future__ import annotations

import argparse
import os
import sys

from .container.bound import MiB, validate_block_size
from .container.stream import compress_file, decompress_file
from .engines import DeviceEngine
from .errors import Bz3Error
from .version import __version__

SUFFIX = ".bz3"


def _die(msg, code=1):
    print(f"bzip3: {msg}", file=sys.stderr)
    sys.exit(code)


def _open_input(path):
    if path is None:
        return sys.stdin.buffer
    if os.path.isdir(path):
        _die(f"input `{path}' is a directory.")
    try:
        return open(path, "rb")
    except OSError as e:
        _die(f"failed to open input file `{path}': {e.strerror}")


def _open_output(path, force):
    if path is None:
        return sys.stdout.buffer
    if os.path.isdir(path):
        _die(f"output file `{path}' is a directory.")
    if os.path.exists(path) and not force:
        _die(f"output file `{path}' already exists. Use -f to force overwrite.")
    return open(path, "wb")


def build_parser():
    p = argparse.ArgumentParser(
        prog="bzip3",
        description="bzip3 on PyTorch/CUDA: BZ3v1 streams, byte-identical to bzip3.",
    )
    p.add_argument("-e", "-z", "--encode", dest="mode", action="store_const", const="encode")
    p.add_argument("-d", "--decode", dest="mode", action="store_const", const="decode")
    p.add_argument("-c", "--stdout", dest="force_stdstreams", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--rm", dest="remove_input", action="store_true")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-b", "--block", type=int, default=16, metavar="N",
                   help="block size in MiB {16}")
    p.add_argument("-j", "--jobs", type=int, default=0, metavar="N",
                   help="blocks per batch; with N >= 2 the framing follows "
                   "the reference's multi-threaded loop")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the blocks run {cuda}")
    p.add_argument("files", nargs="*")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"bzip3 {__version__} (bzip3_tpu_torch, PyTorch/CUDA port)")
        return 0

    mode = args.mode or "encode"
    block_size = args.block * MiB
    if not validate_block_size(block_size):
        _die("Block size must be between 65 KiB and 511 MiB.")
    batch_size = max(1, args.jobs) if args.jobs else 8

    f1 = args.files[0] if args.files else None
    f2 = args.files[1] if len(args.files) >= 2 else None
    if f2 is None and f1 is not None and not args.force_stdstreams:
        if mode == "encode":
            f2 = f1 + SUFFIX
        elif f1.endswith(SUFFIX):
            f2 = f1[: -len(SUFFIX)]
        else:
            _die(f"input `{f1}' does not have a {SUFFIX} suffix.")
    if args.force_stdstreams:
        f2 = None

    try:
        engine = DeviceEngine(args.device)
    except RuntimeError as e:  # no CUDA device for the default --device cuda
        _die(str(e))
    inp = _open_input(f1)
    out = _open_output(f2, args.force)
    try:
        if mode == "encode":
            if out.isatty():
                _die("refusing to write compressed data to a terminal.")
            r, w = compress_file(
                inp, out, block_size, engine=engine, batch_size=batch_size,
                feof_block=args.jobs >= 2,
            )
            if args.verbose:
                ratio = 100.0 * w / r if r else 0.0
                print(f"{r} -> {w} bytes, {ratio:.2f}%", file=sys.stderr)
        else:
            r, w = decompress_file(inp, out, engine=engine, batch_size=batch_size)
            if args.verbose:
                print(f"{r} -> {w} bytes", file=sys.stderr)
    except Bz3Error as e:
        print(f"bzip3: {f1 or 'stdin'}: {e}", file=sys.stderr)
        if f2 is not None:
            out.close()
            os.unlink(f2)
        return 1
    finally:
        if inp is not sys.stdin.buffer:
            inp.close()
    if out is sys.stdout.buffer:
        out.flush()
    else:
        out.close()
    if args.remove_input and f1 and not args.keep:
        os.unlink(f1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
