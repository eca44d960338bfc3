"""gloran.view_fold_us: per fold of the GLORAN staging buffer's pending
records into its disjoint probe view on the point lookups, the
``gloran.view_fold`` span's microseconds: the insert and the merge,
after the pending records are sorted and those that touch a view record
or each other found.  The first get batch after a write batch folds in
every shard, inside ``gloran.index_probe`` on the same thread; the folds
under a flush, a scan or the bottom compaction's purge are left out.
The mean over the window's lookup folds; None where the program opens no
such span."""

import numpy as np


def read(w):
    folds = []
    for s in w.named("gloran.view_fold"):
        # The probe spans on the fold's thread, by start; they do not
        # nest in each other.
        t0, t1 = w._children(s["tid"], "gloran.index_probe")
        i = int(np.searchsorted(t0, s["t0"], "right")) - 1
        if i >= 0 and s["t1"] <= t1[i]:
            folds.append(s["t1"] - s["t0"])
    return 1e6 * float(np.mean(folds)) if folds else None
