"""Random-access encoding in scene chunks: each chunk (a KEY frame and
star groups of ``group`` frames, each with a temporally filtered
non-shown ARF, its middles and a show-existing header) is one call of
``encode_video_arf``, chunk after chunk, as a scene-cut chunker runs
them. The window stops starting chunks once ``--seconds`` have passed and
ends when the chunk in flight completes.

Check, on one chunk drawn from the seed among those the window completed
(a reservoir sample): the temporally filtered sources of its KEY frame
and of one ARF (group g drawn from the seed) against the reference
filter (``tf_mismatch_px``); the decode of its KEY, of ARFs 1 to g and
of one middle of group g (drawn from the seed), each against the
program's reconstruction, the KEY and the middle also against their
sources. The middles of a star reference their ARF and refresh no slot,
so the decode skips the others."""
from __future__ import annotations

import time

import numpy as np

from benchmark.harness import check as C
from benchmark.harness import faults as F


def _kwargs(run) -> dict:
    g = run.config["gop"]
    return dict(group=g["group"], kf_q_offset=g["kf_q_offset"],
                arf_q_offset=g["arf_q_offset"],
                tf_strength=g["tf_strength"], device=run.device)


def load(run) -> None:
    from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    run.program["encode"] = TIF.encode_video_arf
    run.program["module"] = TIF
    run.cfg = EncoderConfig(**run.config["encoder"])


def warmup(run) -> None:
    # every shape of a chunk (the KEY's three-frame filter span, an ARF's
    # five-frame span and the last group's three-frame span) in a short
    # chunk of short groups
    w = run.config["warmup"]
    if len(run.pool[0]) != run.config["gop"]["key_interval"]:
        raise ValueError("the traffic's chunk length is not the "
                         "configuration's key_interval")
    run.program["encode"](run.pool[run.order[0]][:w["frames"]], run.cfg,
                           **{**_kwargs(run), "group": w["group"]})


def _kind(e) -> str:
    if not hasattr(e, "show"):
        return "key"
    return "inter" if e.show else "arf"


def _keep(e):
    """What the check needs of one packet's encoder."""
    if e is None:
        return None
    recon = getattr(e, "ref_planes_out", None)
    if recon is None:
        recon = e.ref_planes_dev
    return {"kind": _kind(e), "src": [np.asarray(p) for p in e.src.planes()],
            "recon": recon}


def window(run) -> None:
    encode = run.program["encode"]
    kw = _kwargs(run)
    rng = np.random.default_rng(run.seed % (1 << 63))
    run.sample = None
    P = len(run.pool)
    c = 0
    run.tracer.start()
    run.t_start = now = time.perf_counter()
    while now - run.t_start < run.seconds:
        pi = run.order[c % P]
        frames = run.pool[pi]
        t0 = time.time_ns()
        run.attempted += len(frames)
        try:
            packets, encs = encode(frames, run.cfg, **kw)
        except Exception as e:            # noqa: BLE001 - counted, reported
            run.failed += len(frames)
            run.errors.append(f"chunk {c}: {type(e).__name__}: {e}")
            c += 1
            now = time.perf_counter()
            continue
        run.spans.record("chunk", t0, time.time_ns())
        traced = run.tracer.after_unit()
        run.displayed += len(frames)
        run.coded_bytes += sum(len(p) for p in packets)
        done = time.perf_counter() - run.t_start
        for e in encs:
            if e is None:
                continue
            st = getattr(e, "pack_stages", {})
            run.frames.append({"type": _kind(e), "traced": traced,
                               "done_s": done,
                               "tf_s": getattr(e, "tf_s", None),
                               "script_s": st.get("script_s"), **e.timings})
        c += 1
        # reservoir sample of one chunk, uniform over the window's chunks
        if run.sample is None or int(rng.integers(0, c)) == 0:
            run.sample = (pi, packets, [_keep(e) for e in encs])
        del encs
        now = time.perf_counter()
    run.tracer.after_unit(last=True)
    run.t_end = time.perf_counter()


def check(run, numbers, control: bool = False) -> None:
    import torch
    from benchmark.reference import temporal_filter as RTF
    from benchmark.reference.av1.decoder.obu import Av1Decoder
    if run.sample is None:
        return
    pi, packets, kept = run.sample
    frames = [list(f.planes()) for f in run.pool[pi]]
    w, h = run.traffic["width"], run.traffic["height"]
    g = run.config["gop"]
    q = run.config["encoder"]["base_q_idx"]
    rng = np.random.default_rng((run.seed + 1) % (1 << 63))
    group = g["group"]
    T = len(frames)
    ngroups = -(-(T - 1) // group)
    gi = int(rng.integers(1, ngroups + 1))           # the group checked
    # packet positions: KEY, then per group ARF, middles, show-existing
    arf_pos = [1 + (group + 1) * j for j in range(ngroups)]
    if len(packets) != len(kept) or len(packets) != 1 + sum(
            min(group, T - 1 - group * j) + 1 for j in range(ngroups)):
        numbers.add("decode_errors", 1)      # not the chunk's structure
        return
    s_idx = 1 + group * (gi - 1)
    e_idx = min(s_idx + group, T)
    n_mid = e_idx - 1 - s_idx
    dev = run.device

    def tf_mine(ref_fn, *args, program):
        # the control puts the reference, in float32, in the program's place
        return ref_fn(*args, dev, torch.float32) if control else program

    # the temporal filter: the KEY's span and group gi's ARF span
    kq = max(8, q - g["kf_q_offset"])
    numbers.add("tf_mismatch_px", C.mismatch(
        RTF.filter_key(frames, kq, dev),
        tf_mine(RTF.filter_key, frames, kq, program=kept[0]["src"])))
    center = e_idx - 1
    lo, hi = max(s_idx, center - 2), min(T, center + 3)
    args = (frames[lo:hi], center - lo, q, g["tf_strength"])
    numbers.add("tf_mismatch_px", C.mismatch(
        RTF.filter_arf(*args, dev),
        tf_mine(RTF.filter_arf, *args,
                program=kept[arf_pos[gi - 1]]["src"])))

    # the decode: KEY, ARFs 1..gi, one middle of group gi
    dec = Av1Decoder()

    def compare(pos, source):
        out = C.decode(dec, packets[pos], numbers)
        if out is None:
            return
        k = kept[pos]
        if k["kind"] == "arf":
            # not shown: read the slot its header refreshes
            slot = dec.fh.refresh_frame_flags.bit_length() - 1
            planes = dec.ref_slots[slot]["frame"].planes()
        elif out:
            planes = out[0].planes()
        else:
            numbers.add("decode_errors", 1)
            return
        planes = [np.asarray(p) for p in planes]
        mine = C.seven_bit(planes) if control else C.crop(k["recon"], w, h)
        numbers.add("recon_mismatch_px", C.mismatch(planes, mine))
        if source is not None:
            numbers.add("luma_mse", C.luma_mse(planes, source))

    compare(0, frames[0])
    for j in range(gi):
        compare(arf_pos[j], None)
    if n_mid > 0:
        m = int(rng.integers(0, n_mid))
        compare(arf_pos[gi - 1] + 1 + m, frames[s_idx + m])



def plant(run, name: str) -> None:
    """Break the timed path with fault ``name`` (``harness/faults.py``):
    the window calls a wrapped ``encode_video_arf``; ``stale`` swaps the
    program's inter encoder class for the chunk's length."""
    F.known(name)
    encode, tif = run.program["encode"], run.program["module"]
    inter = tif.GpuInterFrameEncoder

    class Stale(inter):
        def encode(self):
            pkt = super().encode()
            self.ref_planes_out = list(self.ref_planes_dev)
            return pkt

    def broken(frames, cfg, **kw):
        if name == "half":
            frames = [F.half(f) for f in frames]
        if name == "stale":
            tif.GpuInterFrameEncoder = Stale
        try:
            packets, encs = encode(frames, cfg, **kw)
        finally:
            tif.GpuInterFrameEncoder = inter
        if name == "token":
            packets = [F.token(p) for p in packets]
        return packets, encs

    run.program["encode"] = broken
