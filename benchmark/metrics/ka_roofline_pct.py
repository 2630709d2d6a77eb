"""KA's share of its roofline over the traced stretch: the least time the
picks of the stretch's KEY frames need (``harness/roofline``, counted from
each frame's wavefront sites) over the device time of KA's pick kernels
(``pick61_kernel``, ``pick7_kernel``) in the trace."""
from benchmark.harness import roofline
from benchmark.harness.readers import kernel_s

KA_KERNELS = ("pick61_kernel", "pick7_kernel")


def read(run):
    if not run.trace:
        return None
    keys = sum(1 for f in run.frames if f["type"] == "key" and f["traced"])
    dev = kernel_s(run, KA_KERNELS)
    if keys == 0 or dev <= 0:
        return None
    w, h = run.traffic["width"], run.traffic["height"]
    return 100.0 * keys * roofline.ka_frame_bound_s(w, h) / dev
