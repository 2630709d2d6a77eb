"""KEY frames' ``timings['pack_s']`` (the native pack and the device LPF
pick), mean in ms."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "pack_s", ("key",))
