"""Inter frames' (ARFs' and middles') ``timings['plan_s']``, mean in
ms."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "plan_s", ("arf", "inter"))
