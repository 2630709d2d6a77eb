"""ARFs' and middles' ``timings['script_code_s']`` (the span
``script.code``: the native range coder running the script, and the
end-of-frame context save), mean in ms; None where the program keeps no
such span."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "script_code_s", ("arf", "inter"))
