"""All-intra encoding: one stream of stills, each coded as a KEY frame by
``GpuFrameEncoder(frame, cfg).encode()``, back to back (a closed loop of
one client, no synchronize between frames). A frame's latency runs from
its submit (the encoder's construction) to its packet.

Check: ``check.frames`` frames drawn from the seed, uniformly among all
the window completed (a reservoir sample kept as the window runs, so
only their reconstructions are held), are decoded by the reference and
compared with the program's reconstruction and with their sources."""
from __future__ import annotations

import time

import numpy as np

from benchmark.harness import check as C
from benchmark.harness import faults as F


def load(run) -> None:
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    run.program["encoder"] = GpuFrameEncoder
    run.cfg = EncoderConfig(**run.config["encoder"])


def warmup(run) -> None:
    for i in range(run.config["warmup_frames"]):
        run.program["encoder"](run.pool[run.order[i % len(run.pool)]],
                               run.cfg, device=run.device).encode()


def window(run) -> None:
    enc_cls = run.program["encoder"]
    k = run.check_cfg["frames"]
    rng = np.random.default_rng(run.seed % (1 << 63))
    run.sample = []
    P = len(run.pool)
    i = 0
    run.tracer.start()
    run.t_start = now = time.perf_counter()
    while now - run.t_start < run.seconds:
        pi = run.order[i % P]
        t_sub = time.perf_counter()
        t0 = time.time_ns()
        run.attempted += 1
        try:
            enc = enc_cls(run.pool[pi], run.cfg, device=run.device)
            pkt = enc.encode()
        except Exception as e:            # noqa: BLE001 - counted, reported
            run.failed += 1
            run.errors.append(f"frame {i}: {type(e).__name__}: {e}")
            i += 1
            now = time.perf_counter()
            continue
        now = time.perf_counter()
        run.spans.record("frame", t0, time.time_ns())
        traced = run.tracer.after_unit()
        run.displayed += 1
        run.coded_bytes += len(pkt)
        run.frames.append({"type": "key", "latency_s": now - t_sub,
                           "done_s": now - run.t_start, "traced": traced,
                           **enc.timings})
        item = (i, pi, pkt, enc.ref_planes_dev)
        # reservoir sample of k frames, uniform over the window's frames
        if len(run.sample) < k:
            run.sample.append(item)
        else:
            j = int(rng.integers(0, run.displayed))
            if j < k:
                run.sample[j] = item
        del enc
        i += 1
    run.tracer.after_unit(last=True)
    run.t_end = time.perf_counter()


def check(run, numbers, control: bool = False) -> None:
    from benchmark.reference.av1.decoder.obu import Av1Decoder
    w, h = run.traffic["width"], run.traffic["height"]
    for i, pi, pkt, recon in run.sample:
        src = run.pool[pi].planes()
        out = C.decode(Av1Decoder(), pkt, numbers)
        if out is None:
            continue
        if not out:                     # a KEY frame is always shown
            numbers.add("decode_errors", 1)
            continue
        dec = [np.asarray(p) for p in out[0].planes()]
        mine = C.seven_bit(dec) if control else C.crop(recon, w, h)
        numbers.add("recon_mismatch_px", C.mismatch(dec, mine))
        numbers.add("luma_mse", C.luma_mse(dec, src))


def plant(run, name: str) -> None:
    """Break the timed path with fault ``name`` (``harness/faults.py``):
    the window builds a wrapped encoder class."""
    F.known(name)
    base = run.program["encoder"]
    last = []

    class Broken(base):
        def __init__(self, frame, cfg, device="cuda"):
            super().__init__(F.half(frame) if name == "half" else frame, cfg,
                             device=device)

        def encode(self, include_seq: bool = True) -> bytes:
            pkt = super().encode(include_seq)
            if name == "stale":
                mine = self.ref_planes_dev
                if last:
                    self.ref_planes_dev = last[0]
                last[:] = [mine]
            return F.token(pkt) if name == "token" else pkt

    run.program["encoder"] = Broken
