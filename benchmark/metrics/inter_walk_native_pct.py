"""The share of ARFs and middles whose symbol script the native walk
built: 100 x the ARFs and middles whose ``timings['script_native']`` is 1
over the ARFs and middles, outside the traced chunk where there are any;
None where the program reports no ``script_native``."""


def read(run):
    rows = [f for f in run.frames if f["type"] in ("arf", "inter")
            and f.get("script_native") is not None]
    rows = [f for f in rows if not f["traced"]] or rows
    if not rows:
        return None
    return 100.0 * sum(1 for f in rows if f["script_native"] == 1) / len(rows)
