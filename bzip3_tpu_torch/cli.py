"""bzip3-compatible command line for the PyTorch/CUDA port.

    python -m bzip3_tpu_torch -e|-d|-t|-r [-b N] [-j N] [-B] [-c] [-f] [-k]
                              [--rm] [-v] [--engine E] [--device cuda|cpu]
                              [input [output] | -B files...]

The flags follow the reference CLI (src/main.c:553-585): -e/-z encode,
-d decode, -t test, -r recover, -c stdout, -f force, --rm, -k keep, -v
verbose, -V version, -h help, -b block MiB, -B batch (every file in
turn), -j jobs.  ``--engine`` picks the block engine (``engines.py``):
``device`` (the default), ``sharded`` (every card), ``oracle``,
``native``, ``hybrid`` or ``auto``; the device, sharded and hybrid
engines run on the card unless ``--device cpu`` is given.  File naming
follows the reference: encode appends ``.bz3`` (src/main.c:747-770),
decode and recover require it unless writing to standard output
(src/main.c:783), and compressed data is never written to a terminal
(src/main.c:161-165).  Under ``BZ3_TPU_PROFILE=1`` the device engine's
``timer.summary()`` (stages, spans, counters, launches, library loads)
goes to stderr after each file.
"""

from __future__ import annotations

import argparse
import os
import sys

from .container.bound import MiB, validate_block_size
from .container.stream import compress_file, decompress_file
from .engines import NAMES, get_engine
from .errors import Bz3Error
from .version import __version__

SUFFIX = ".bz3"

USAGE = (
    "bzip3 - better and stronger spiritual successor to bzip2.\n"
    "Usage: bzip3 [-e/-z/-d/-t/-c/-h/-V] [-b block_size] [-j jobs] files...\n"
    "Operations:\n"
    "  -e/-z, --encode   compress data (default)\n"
    "  -d, --decode      decompress data\n"
    "  -r, --recover     attempt at recovering corrupted data\n"
    "  -t, --test        verify validity of compressed data\n"
    "  -h, --help        display an usage overview\n"
    "  -f, --force      force overwriting output if it already exists\n"
    "      --rm          remove input files after successful (de)compression\n"
    "  -k, --keep        keep (don't delete) input files (default)\n"
    "  -v, --verbose     verbose mode (display more information)\n"
    "  -V, --version     display version information\n"
    "Extra flags:\n"
    "  -c, --stdout      force writing to standard output\n"
    "  -b N, --block=N   set block size in MiB {16}\n"
    "  -B, --batch       process all files specified as inputs\n"
    "  -j N, --jobs=N    set the amount of parallel threads\n"
    "  --engine=E        block engine: device|sharded|oracle|native|hybrid|auto {device}\n"
    "  --device=D        where the device engines run: cuda|cpu {cuda}\n"
)


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
    p = argparse.ArgumentParser(prog="bzip3", add_help=False)
    p.add_argument("-e", "-z", "--encode", dest="mode", action="store_const", const="encode")
    p.add_argument("-d", "--decode", dest="mode", action="store_const", const="decode")
    p.add_argument("-t", "--test", dest="mode", action="store_const", const="test")
    p.add_argument("-r", "--recover", dest="mode", action="store_const", const="recover")
    p.add_argument("-c", "--stdout", dest="force_stdstreams", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--rm", dest="remove_input", action="store_true")
    p.add_argument("-k", "--keep", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-h", "--help", action="store_true")
    p.add_argument("-b", "--block", type=int, default=16, metavar="N")
    p.add_argument("-B", "--batch", action="store_true")
    p.add_argument("-j", "--jobs", type=int, default=0, metavar="N")
    p.add_argument("--engine", default="device", choices=NAMES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("files", nargs="*")
    return p


def _jobs(args, mode: str) -> list[tuple[str | None, str | None]]:
    """(input path or None for stdin, output path or None for stdout) of
    each file to process, by the reference's naming rules."""
    def decoded_name(f):
        if not f.endswith(SUFFIX):
            _die(f"input `{f}' does not have a {SUFFIX} suffix.")
        return f[: -len(SUFFIX)]

    files = args.files
    if args.batch and files:
        out = []
        for f in files:
            if args.force_stdstreams or mode == "test":
                out.append((f, None))
            elif mode == "encode":
                out.append((f, f + SUFFIX))
            else:
                out.append((f, decoded_name(f)))
        return out
    f1 = files[0] if files else None
    f2 = files[1] if len(files) >= 2 else None
    if f2 is None and f1 is not None and not args.force_stdstreams:
        if mode == "encode":
            f2 = f1 + SUFFIX
        elif mode in ("decode", "recover"):
            f2 = decoded_name(f1)
    if args.force_stdstreams:
        f2 = None
    return [(f1, f2)]


def _process(inp, out, mode, block_size, engine, batch_size, args) -> None:
    if mode == "encode":
        if out.isatty():
            _die("refusing to write compressed data to a terminal.")
        r, w = compress_file(inp, out, block_size, engine=engine, batch_size=batch_size,
                             feof_block=args.jobs >= 2)
        if args.verbose:
            ratio = 100.0 * w / r if r else 0.0
            print(f"{r} -> {w} bytes, {ratio:.2f}%", file=sys.stderr)
    else:
        r, w = decompress_file(inp, out, engine=engine, batch_size=batch_size,
                               recover=mode == "recover", test_only=mode == "test")
        if args.verbose:
            print("OK" if mode == "test" else f"{r} -> {w} bytes", file=sys.stderr)


def _print_profile(engine) -> None:
    """The engine's stage timer, when on (``BZ3_TPU_PROFILE=1``), to
    stderr; then cleared, so that each file prints its own."""
    timer = getattr(engine, "timer", None)
    if timer is not None and timer.enabled:
        print(timer.summary(), file=sys.stderr)
        timer.clear()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.help:
        print(USAGE)
        return 0
    if args.version:
        print(f"bzip3 {__version__} (bzip3_tpu_torch, PyTorch/CUDA port)")
        return 0

    mode = args.mode or "encode"
    block_size = args.block * MiB
    if not validate_block_size(block_size):
        _die("Block size must be between 65 KiB and 511 MiB.")
    batch_size = max(1, args.jobs) if args.jobs else (os.cpu_count() or 4)
    jobs = _jobs(args, mode)
    try:
        engine = get_engine(args.engine, args.jobs, device=args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        _die(str(e))

    status = 0
    for in_path, out_path in jobs:
        inp = _open_input(in_path)
        out = None if mode == "test" else _open_output(out_path, args.force)
        try:
            _process(inp, out, mode, block_size, engine, batch_size, args)
        except Bz3Error as e:
            print(f"bzip3: {in_path or 'stdin'}: {e}", file=sys.stderr)
            status = 1
            if out is not None and out_path is not None:
                out.close()
                os.unlink(out_path)
            continue
        finally:
            if inp is not sys.stdin.buffer:
                inp.close()
            _print_profile(engine)
        if out is sys.stdout.buffer:
            out.flush()
        elif out is not None:
            out.close()
        # --rm follows each file's own outcome (src/main.c:789)
        if args.remove_input and in_path and not args.keep:
            os.unlink(in_path)
    return status


if __name__ == "__main__":
    sys.exit(main())
