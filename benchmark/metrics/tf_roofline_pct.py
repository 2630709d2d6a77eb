"""The temporal filter's kernels' share of their roofline over the traced
stretch: the least time the filter spans of the stretch's KEY frames and
ARFs need (each KEY's span of up to three frames; each ARF's span from its
place in the chunk's star groups), counted from the frame's size and the
GOP structure by ``harness/roofline_inter``, over the device time of KJ's
search and KK's span pass in the trace (``kj_kernel``,
``kk_span_kernel``)."""
from benchmark.harness import roofline_inter as RI
from benchmark.harness.readers import kernel_s


def read(run):
    if not run.trace:
        return None
    dev = kernel_s(run, RI.TF_KERNELS)
    if dev <= 0:
        return None
    w, h = run.traffic["width"], run.traffic["height"]
    T = run.traffic["frames"]
    spans = RI.arf_spans(T, run.config["gop"]["group"])
    need, j = 0.0, 0
    # the frames of a chunk come in coded order: its KEY, then each
    # group's ARF before its middles
    for f in run.frames:
        if f["type"] == "key":
            j = 0
            n = RI.key_span(T)
        elif f["type"] == "arf":
            n = spans[j]
            j += 1
        else:
            continue
        if f["traced"] and n >= 2:
            need += RI.tf_span_bound_s(n, w, h)
    return 100.0 * need / dev if need > 0 else None
