"""Host time per kernel launch in the KEY plan's submit: the KEY frames'
``timings['plan_submit_s']`` over their ``timings['plan_launches']``
(the launches ``CudaKernel.launch`` counted inside the span
``plan.submit``), summed over the frames outside the traced stretch, in
us; None where the program counts no such launches."""


def read(run):
    rows = [f for f in run.frames
            if f["type"] == "key" and f.get("plan_launches")]
    rows = [f for f in rows if not f["traced"]] or rows
    if not rows:
        return None
    return 1e6 * sum(f["plan_submit_s"] for f in rows) / \
        sum(f["plan_launches"] for f in rows)
