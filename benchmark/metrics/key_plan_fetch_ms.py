"""KEY frames' ``timings['plan_fetch_s']`` (the span ``plan.fetch``: the
wait for the queue, the one device-to-host copy and its unpacking), mean
in ms; None where the program keeps no such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "plan_fetch_s", ("key",))
