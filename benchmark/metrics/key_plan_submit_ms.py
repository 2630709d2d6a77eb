"""KEY frames' ``timings['plan_submit_s']`` (the span ``plan.submit``: the
luma and chroma wavefronts queued, 5 KA + 5 KB launches a step), mean in
ms; None where the program keeps no such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "plan_submit_s", ("key",))
