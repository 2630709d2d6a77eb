"""The 95th percentile of the KEY frames' latency (the harness's clock from
a frame's submit to its packet), over every frame of the window outside
the traced stretch (all of them where the stretch took the window)."""
import statistics


def read(run):
    rows = [f for f in run.frames if "latency_s" in f]
    rows = [f for f in rows if not f["traced"]] or rows
    if len(rows) < 2:
        return None
    return 1e3 * statistics.quantiles([f["latency_s"] for f in rows],
                                      n=20)[-1]
