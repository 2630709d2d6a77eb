"""``tf_s`` of the KEY and ARF encoders (the temporal filter of their
spans), mean over the filtered frames in ms."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "tf_s", ("key", "arf"))
