"""kernel.cascade_submit_us: per launch of the fused lookup cascade,
the host's microseconds before the kernel is queued: its
``cascade.upload`` (the query columns' four copies to the device) and
``cascade.launch`` (operand checks and the launch) spans, inside its
``kernel.cascade`` span.  The mean over the launches."""

import numpy as np

from perfbench.nested import inside_seconds


def read(w):
    if not w.named("cascade.launch"):
        return None
    return 1e6 * float(np.mean([
        inside_seconds(w, s, "cascade.upload")
        + inside_seconds(w, s, "cascade.launch")
        for s in w.named("kernel.cascade")]))
