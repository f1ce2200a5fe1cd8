"""Block parallelism over the processes of a ``torch.distributed`` job
(counterpart of the JAX package's ``parallel/multihost.py``).

1. ``initialize()`` joins the job (one process a host, whose cards are
   ``global_mesh()``; or one a card, each process seeing its own card
   through ``CUDA_VISIBLE_DEVICES``).  Without ``MASTER_ADDR`` or an
   ``init_method`` it does nothing, as the JAX package's does without a
   coordinator.
2. Each process codes its stripe of the blocks, block i on rank
   ``i % world_size`` (``host_stripe``), through its own
   ``sharded_pipeline`` over ``global_mesh()``.
3. ``gather_to_writer`` gathers every rank's coded rows, padded to one
   width (``bound()``), and their lengths to rank 0, which writes the
   frame in block order.

The JAX package's ``make_global_batch`` has no counterpart: PyTorch has
no array sharded over processes, so a rank never assembles one; it codes
its own stripe.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .sharding import make_mesh

# Rows a gather moves at a time: every rank stages one chunk, and only
# rank 0 keeps the assembled rows (the JAX package's CHUNK_ROWS).
CHUNK_ROWS = 64


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the job: ``torch.distributed.init_process_group`` at
    ``init_method`` (default ``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) over ``backend`` (default ``nccl`` in a
    process with a card, ``gloo`` on the CPU).  A no-op without
    ``MASTER_ADDR`` and ``init_method``."""
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
    )


def global_mesh(device="cuda") -> list[torch.device]:
    """This process's share of the job's mesh: every card it sees, or
    with ``device="cpu"`` one CPU share."""
    if torch.device(device).type == "cpu":
        return make_mesh(devices=["cpu"])
    return make_mesh()


def host_stripe(n_blocks: int) -> range:
    """Indices of the blocks this process codes (striped assignment)."""
    if not _joined():
        return range(n_blocks)
    return range(dist.get_rank(), n_blocks, dist.get_world_size())


def gather_to_writer(payloads, lengths):
    """This rank's coded rows to rank 0, in frame order.

    ``payloads`` [K_local, W] uint8 (a tensor on any device, or numpy) are
    the rows of this rank's ``host_stripe``, each padded to the same
    width (``bound()`` of the block size), ``lengths`` [K_local] their
    lengths.  Rank 0 gets numpy (rows [n, W], lengths [n]) with the
    stripes interleaved back into block order; the other ranks get
    (None, None).  Ranks whose stripes differ in length pad to
    ceil(n / world_size) rows (``dist.gather`` needs equal shapes), and
    the rows move ``CHUNK_ROWS`` at a time: on the card over ``nccl``,
    through the CPU over ``gloo``.  Outside a job it returns its inputs
    as numpy."""
    payloads = torch.as_tensor(payloads)
    lengths = torch.as_tensor(lengths)
    if not _joined():
        return payloads.cpu().numpy(), lengths.cpu().numpy()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    k, w = payloads.shape
    shapes = [torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(world)]
    dist.all_gather(shapes, torch.tensor([k, w], dtype=torch.int64, device=dev))
    ks, ws = zip(*(s.tolist() for s in shapes))
    n, rows, width = sum(ks), max(ks), max(ws)
    if any(kq != len(range(q, n, world)) for q, kq in enumerate(ks)):
        raise ValueError(f"row counts {list(ks)} are not the stripes of {n} blocks")
    lens = torch.zeros(rows, dtype=torch.int64, device=dev)
    lens[:k] = lengths.to(dev)
    parts = [torch.empty_like(lens) for _ in range(world)] if rank == 0 else None
    dist.gather(lens, parts, dst=0)
    out_lens = out = None
    if rank == 0:
        out_lens = np.zeros(n, dtype=np.int64)
        out = np.zeros((n, width), dtype=np.uint8)
        for q, part in enumerate(parts):
            out_lens[q::world] = part[: ks[q]].cpu().numpy()
    for lo in range(0, rows, CHUNK_ROWS):
        hi = min(rows, lo + CHUNK_ROWS)
        chunk = torch.zeros((hi - lo, width), dtype=torch.uint8, device=dev)
        if lo < k:
            chunk[: min(hi, k) - lo, :w] = payloads[lo:hi].to(dev)
        parts = [torch.empty_like(chunk) for _ in range(world)] if rank == 0 else None
        dist.gather(chunk, parts, dst=0)
        if rank == 0:
            for q, part in enumerate(parts):
                m = max(0, min(hi, ks[q]) - lo)
                out[q + world * lo : q + world * (lo + m) : world] = part[:m].cpu().numpy()
    return out, out_lens
