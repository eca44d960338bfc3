"""lsm.rt_mem_ms: for each get batch, the ``lsm.rt_mem`` spans inside its
``shard.get`` spans, summed over its shards: the LRR store's fold of the
memtable's and the sealed memtables' range tombstones into each key's
covering sequence number, one pass over the batch a tombstone.  The
shards run in turn on one thread in this cell, so the sum, not the
slowest shard, is what the batch waits for.  The mean over the get
batches, in ms; None where the program opens no such span (another
strategy, or a program without it)."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    return mean_ms(per_batch(w, "shard.get", "get", "lsm.rt_mem"))
