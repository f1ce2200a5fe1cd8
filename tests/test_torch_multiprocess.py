"""Two processes of a ``torch.distributed`` job over gloo on the CPU, as
``tests/test_multiprocess.py`` runs the JAX package's multi-host layer.

Each rank joins through ``multihost.initialize`` (``MASTER_ADDR`` and
the rest from its environment), codes its ``host_stripe`` of the same
seeded rows through a ``sharded_pipeline`` over ``global_mesh("cpu")``,
and ``gather_to_writer`` assembles every rank's blocks on rank 0, which
must hold the JAX oracle's blocks of all the rows in order: 8 rows of
512 bytes (even stripes), then their first 5 (stripes of 3 and 2).  The
workers import only torch, numpy and the port.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

from bzip3_tpu.models.block_codec import encode_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = (8, 5)

_WORKER = r"""
import os, pickle, sys

sys.path.insert(0, os.environ["REPO_DIR"])
import numpy as np
import torch

from bzip3_tpu_torch.container.bound import bound
from bzip3_tpu_torch.parallel import multihost as mh
from bzip3_tpu_torch.parallel.sharding import sharded_pipeline

BS = 512
mh.initialize()
rank = torch.distributed.get_rank()
rows = np.random.default_rng(7).integers(97, 123, (8, BS), dtype=np.uint8)
pipe = sharded_pipeline(BS, mh.global_mesh("cpu"))
out = {}
for n in [int(c) for c in sys.argv[2].split(",")]:
    stripe = list(mh.host_stripe(n))
    enc = pipe.encode_blocks([rows[i].tobytes() for i in stripe])
    pad = np.zeros((len(enc), bound(BS)), dtype=np.uint8)
    for j, e in enumerate(enc):
        pad[j, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    p, l = mh.gather_to_writer(torch.from_numpy(pad), torch.tensor([len(e) for e in enc]))
    if rank == 0:
        out[n] = {"stripe": stripe, "blocks": [p[i, : l[i]].tobytes() for i in range(n)]}
    else:
        assert p is None and l is None
        out[n] = {"stripe": stripe}
out["jax"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bzip3_tpu"))
with open(sys.argv[1] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_ranks_gather_blocks_in_frame_order(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(REPO_DIR=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(out), ",".join(map(str, COUNTS))],
            env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(2)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    res = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))

    rows = np.random.default_rng(7).integers(97, 123, (8, 512), dtype=np.uint8)
    for n in COUNTS:
        assert [res[r][n]["stripe"] for r in range(2)] == [list(range(r, n, 2)) for r in range(2)]
        assert res[0][n]["blocks"] == [encode_block(rows[i].tobytes()) for i in range(n)]
    assert res[0]["jax"] == res[1]["jax"] == []
