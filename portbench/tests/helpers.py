"""Shared by the tests: a run of a cell on the CPU through the program's
host engine at a small size."""

from bzip3_tpu_torch.engines import NativeEngine

from portbench.harness.main import run_cell

TEST_BLOCK = 66560  # the format's smallest block size


def cpu_run(cell, seed=2**31 + 9, seconds=0.2, traced=False, scale=0.0003, **kw):
    return run_cell(cell, seed, seconds, traced, device="cpu", scale=scale,
                    block_size=TEST_BLOCK, engine_factory=lambda c, d, t: NativeEngine(2), **kw)
