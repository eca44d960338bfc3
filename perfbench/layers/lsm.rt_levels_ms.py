"""lsm.rt_levels_ms: for each get batch, the ``lsm.rt_probe`` spans
inside its ``shard.get`` spans, summed over its shards: the LRR store's
probes of each level's range-tombstone block (the Eq. 1 charge and the
block's step function, built on its first probe after a merge).  The
shards run in turn on one thread in this cell, so the sum, not the
slowest shard, is what the batch waits for.  The mean over the get
batches, in ms: 0 where no level holds a tombstone block yet, None
where the window holds no ``lsm.rt_mem`` span (a store without range
tombstones, or a program without these spans)."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    if not per_batch(w, "shard.get", "get", "lsm.rt_mem"):
        return None
    return mean_ms(per_batch(w, "shard.get", "get", "lsm.rt_probe")) or 0.0
