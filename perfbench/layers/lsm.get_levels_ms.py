"""lsm.get_levels_ms: for each get batch, the ``lsm.get_levels`` spans
inside its ``shard.get`` spans, summed over its shards: the LSM tree's
level loop (data-block charges, the rows of the cascade's hits, the
per-level route where the cascade declines).  The shards run in turn on
one thread in this cell, so the sum, not the slowest shard, is what the
batch waits for.  The mean over the get batches, in ms."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    return mean_ms(per_batch(w, "shard.get", "get", "lsm.get_levels"))
