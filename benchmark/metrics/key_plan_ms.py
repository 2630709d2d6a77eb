"""KEY frames' ``timings['plan_s']`` (the intra wavefront, up to its host
read), mean in ms."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "plan_s", ("key",))
