"""ARFs' and middles' ``timings['script_walk_s']`` (the span
``script.walk``: the per-block Python walk that builds the symbol script's
ops), mean in ms; None where the program keeps no such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "script_walk_s", ("arf", "inter"))
