"""gloran.validity_ms: for each get batch, the ``gloran.validity`` spans
inside its ``shard.get`` spans, summed over its shards: GLORAN's
validity step of the point lookups (EVE, then the LSM-DRtree on the
entries EVE could not clear).  The shards run in turn on one thread in
this cell, so the sum, not the slowest shard, is what the batch waits
for.  The mean over the get batches, in ms."""

from perfbench.nested import per_batch
from perfbench.window import mean_ms


def read(w):
    return mean_ms(per_batch(w, "shard.get", "get", "gloran.validity"))
