"""Host-device copies that block the host, per ARF and middle: the mean of
the frames' ``timings['syncs']`` (each copy to or from the card counted by
``convert.to_device`` / ``convert.to_host``) outside the traced stretch;
None where the program counts no syncs on inter frames."""


def read(run):
    rows = [f for f in run.frames
            if f["type"] in ("arf", "inter") and f.get("syncs") is not None]
    rows = [f for f in rows if not f["traced"]] or rows
    if not rows:
        return None
    return sum(f["syncs"] for f in rows) / len(rows)
