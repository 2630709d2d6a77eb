"""Kernel launches of the window (the sum of every ``CudaKernel``'s
``launches``, an exact count) over the displayed frames."""


def read(run):
    return run.launches / run.displayed if run.displayed else None
