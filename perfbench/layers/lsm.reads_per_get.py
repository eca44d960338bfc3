"""lsm.reads_per_get: simulated block reads of the point-lookup path
(``IOStats`` tags of data blocks and index probes) over the window,
per key looked up: the paper's own metric.  Writes charge none of these
tags; scans would, so this reads cells without scans."""

TAGS = ("data_block", "drtree_probe", "rtree_probe", "rt_block")


def read(w):
    keys = w.ops("get")
    if not keys or w.ops("scan"):
        return None
    return sum(w.delta("io", "by_tag", t) for t in TAGS) / keys
