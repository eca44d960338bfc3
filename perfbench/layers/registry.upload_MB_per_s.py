"""registry.upload_MB_per_s: host-to-device bytes of the registry's
packs (re-packs after flushes and compactions) over the window
(``KernelCounters.upload_bytes``), per second of the window, in MB/s."""


def read(w):
    return w.delta("kernels", "upload_bytes") / 1e6 / w.seconds
