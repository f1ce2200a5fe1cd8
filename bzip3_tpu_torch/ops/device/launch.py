"""What every CUDA kernel wrapper of the port shares: argument checks,
the CPU/CUDA route, 16-byte row padding, the kernel library's C entry
points and the launch error check.

A wrapper checks its tensors, takes the plain PyTorch version when they
lie on the CPU, and otherwise launches its kernel on the current
stream through ``entry``, raises through ``raise_on`` if the launch
was refused and adds the launch to its count through ``count``, which
stays exact when several threads launch at once (the shares of a
sharded pipeline).  Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..build import load_kernels

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64

_entries: dict[str, ctypes._CFuncPtr] = {}
_counts_lock = threading.Lock()


def entry(name: str, argtypes: list, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """C function ``name`` of the kernel library (built on first use); a
    launcher returns its launch's cudaError_t as an int."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_kernels(), name)
        fn.restype = restype
        fn.argtypes = argtypes
        _entries[name] = fn
    return fn


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: want {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(*ts: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors all on one device; raise otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {kind!r}")
    return kind


def rows16(x: torch.Tensor) -> torch.Tensor:
    """x [K, W] uint8 with W a multiple of 16 and 16-byte aligned rows, as
    the kernels' 16-byte readers need: x itself, or a zero-padded copy."""
    w = x.shape[1]
    if w % 16 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((x.shape[0], -(-max(w, 1) // 16) * 16), dtype=x.dtype, device=x.device)
    out[:, :w] = x
    return out


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        err = entry("bz3t_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{what} launch failed: {err(rc).decode()} (cudaError {rc})")


def count(launches: dict[str, int], name: str) -> None:
    """One more launch of kernel ``name`` in a wrapper's ``launches``."""
    with _counts_lock:
        launches[name] += 1


def reset(launches: dict[str, int]) -> None:
    """Every count of a wrapper's ``launches`` to 0."""
    with _counts_lock:
        for k in launches:
            launches[k] = 0
