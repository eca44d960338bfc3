"""lsm.range_delete_ms: for each write batch, the slowest shard's
``shard.range_delete`` span (GLORAN's staging buffer, LSM-DRtree and
EVE on the host); the mean over the write batches that carry range
deletes, in ms."""

from perfbench.window import mean_ms


def read(w):
    return mean_ms(w.slowest_per_batch("shard.range_delete", "write"))
