"""lsm.rt_insert_ms: for each write batch, the ``lsm.rt_insert`` spans
inside its ``shard.range_delete`` spans, summed over its shards: the LRR
store's per-range loop that appends each range tombstone to the
memtable, with the seals and flushes it triggers.  The shards run in
turn on one thread in this cell, so the sum, not the slowest shard, is
what the batch waits for.  The mean over the write batches that carry
range deletes, in ms; None where the program opens no such span."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    return mean_ms(per_batch(w, "shard.range_delete", "write",
                             "lsm.rt_insert"))
