"""Python's garbage collection inside ARFs and middles: the mean of the
frames' ``timings['gc_s']`` (the collections that started and ended inside
the frame's record, timed by a ``gc.callbacks`` hook) in ms; None where
the program counts no collections."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "gc_s", ("arf", "inter"))
