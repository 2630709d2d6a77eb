"""KEY frames' ``timings['plan_inputs_s']`` (the span ``plan.inputs``: the
plan's host tables and their uploads), mean in ms; None where the
program keeps no such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "plan_inputs_s", ("key",))
