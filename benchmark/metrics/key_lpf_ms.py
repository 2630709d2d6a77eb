"""KEY frames' ``timings['lpf_s']`` (the span ``lpf``: the device LPF pick
(KC), its levels' read included), mean in ms; None where the program
keeps no such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "lpf_s", ("key",))
