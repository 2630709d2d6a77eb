"""100 - the device's busy share of the traced stretch: the union of its
kernel, copy and set intervals from the profiler's CUDA activity, over the
stretch's wall time."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
