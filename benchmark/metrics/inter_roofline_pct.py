"""The inter kernels' share of their roofline over the traced stretch: the
least time the stretch's ARFs and middles need for their plans and their
CDEF passes (and the KEY frames' CDEF passes, where their quantizer turns
CDEF on), counted from the frame's size by ``harness/roofline_inter``,
over the device time of KE, KD, KB's batched entry and KF in the trace
(``ke_strip_kernel``, ``kd_kernel``, ``kb_batch_kernel``,
``kf_tile_kernel``)."""
from benchmark.harness import roofline_inter as RI
from benchmark.harness.readers import kernel_s


def read(run):
    if not run.trace:
        return None
    dev = kernel_s(run, RI.INTER_KERNELS)
    frames = [f for f in run.frames if f["traced"]]
    if dev <= 0 or not frames:
        return None
    w, h = run.traffic["width"], run.traffic["height"]
    q = run.config["encoder"]["base_q_idx"]
    g = run.config["gop"]
    qs = {"key": max(8, q - g["kf_q_offset"]),
          "arf": max(8, q - g["arf_q_offset"]), "inter": q}
    plan, cdef = RI.inter_plan_bound_s(w, h), RI.cdef_bound_s(w, h)
    need = sum((plan if f["type"] != "key" else 0.0)
               + (cdef if RI.cdef_on(qs[f["type"]]) else 0.0)
               for f in frames)
    return 100.0 * need / dev
