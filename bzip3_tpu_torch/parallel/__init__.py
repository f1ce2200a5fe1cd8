"""Block data parallelism over several devices (counterpart of the JAX
package's ``parallel/``).

Blocks are independent (the reference's only axis of parallelism, one
pthread a block, src/libbz3.c:845-870).  ``sharding`` splits each wave's
rows over the cards of one process; ``multihost`` stripes blocks over
the processes of a ``torch.distributed`` job and gathers their coded
rows to rank 0.
"""
