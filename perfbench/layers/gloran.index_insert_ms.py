"""gloran.index_insert_ms: for each write batch, the
``gloran.index_insert`` spans inside its ``shard.range_delete`` spans,
summed over its shards: the LSM-DRtree's staging appends, flushes and
level merges.  The shards run in turn on one thread in this cell, so
the sum, not the slowest shard, is what the batch waits for.  The mean
over the write batches that carry range deletes, in ms."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    return mean_ms(per_batch(w, "shard.range_delete", "write",
                             "gloran.index_insert"))
