"""Inter frames' ``pack_stages['script_s']`` (``_pack_script``: the
symbol script and the native coder), mean in ms."""
from benchmark.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "script_s", ("arf", "inter"))
