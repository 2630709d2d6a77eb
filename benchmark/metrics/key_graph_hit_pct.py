"""The share of KEY frames whose plan replayed a captured CUDA graph of
its partition wavefronts: 100 x the KEY frames whose
``timings['plan_graph']`` is 1 or more (a submit that replayed; 0 where it
walked the wavefronts eagerly or captured them) over the KEY frames,
outside the traced stretch; None where the program reports no
``plan_graph``."""


def read(run):
    rows = [f for f in run.frames
            if f["type"] == "key" and f.get("plan_graph") is not None]
    rows = [f for f in rows if not f["traced"]] or rows
    if not rows:
        return None
    return 100.0 * sum(1 for f in rows if f["plan_graph"] >= 1) / len(rows)
