"""shard.get_ms: for each get batch, the slowest shard's ``shard.get``
span less its ``kernel.*`` spans (the shard executor, LSM tree and
GLORAN host path); the mean over the batches, in ms."""

from perfbench.window import mean_ms


def read(w):
    return mean_ms(w.slowest_per_batch("shard.get", "get", minus="kernel."))
