"""cascade_sm90_roofline: the least time the window's fused lookup-
cascade launches need for their bytes at the chip's memory rate, over
the device time the profiler gave them, in %.  Bytes per launch from
its inputs and the pack it read (``roofline.cascade_bytes``).  Launches
on the device that the trace did not record are an error, not a
silence."""

from perfbench.roofline import hbm_bytes_per_s


def read(w):
    t, n = w.kernel_seconds("cascade_sm90")
    if not n:
        return None
    if n != len(w.cascade_bytes):
        raise RuntimeError(f"cascade_sm90: {n} launches on the device, "
                           f"{len(w.cascade_bytes)} recorded")
    bound = sum(w.cascade_bytes) / hbm_bytes_per_s(w.kind)
    return 100 * bound / t
