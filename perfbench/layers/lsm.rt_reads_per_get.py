"""lsm.rt_reads_per_get: simulated block reads of the levels'
range-tombstone blocks (``IOStats`` tag ``rt_block``) over the window,
per key looked up: the paper's Eq. 1 charge, every tombstone that starts
at or below the key streaming in.  Scans charge a tag of their own
(``rt_scan``); like ``lsm.reads_per_get``, this reads cells without
scans.  None where the window holds no ``lsm.rt_mem`` span (a store
without range tombstones, or a program without these spans)."""


def read(w):
    keys = w.ops("get")
    if not keys or w.ops("scan") or not w.named("lsm.rt_mem"):
        return None
    return w.delta("io", "by_tag", "rt_block") / keys
