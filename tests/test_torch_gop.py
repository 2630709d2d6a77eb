"""Port parity of the IPPP GOP: ``encode_video(device="cpu")`` of
``aom_av1_psy_tpu_torch`` gives the byte-identical packets of the JAX
``encode_video_tpu`` (CDEF on by default, with ``cdef=False``, with a
mid-GOP KEY), every frame decodes through the in-repo decoder to the port's
post-LPF, post-CDEF reference chain, each P-frame's plan equals the
reference's key for key, a port P-frame started from a JAX-made chain
(``convert.chain_from_jax``) gives the reference's packet, the KEY
frame with ``cdef_fixed`` equals ``TpuFrameEncoder``'s, and a GOP with the
KEY-frame CDEF search (``search_cdef``) equals ``encode_video_tpu``'s.
This file holds the 96x64 shape (one JAX compile of each plan);
test_torch_inter_plan*.py hold the others.
Tolerance: exact equality (bytes, integer plans, planes)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.decoder.obu import Av1Decoder
from aom_av1_psy_tpu.encoder import tpu_inter as JI
from aom_av1_psy_tpu.encoder.frame import EncoderConfig
from aom_av1_psy_tpu.encoder.tpu_frame import TpuFrameEncoder
from aom_av1_psy_tpu.encoder.tpu_interframe import (TpuInterFrameEncoder,
                                                    encode_video_tpu)
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import (
    GpuInterFrameEncoder, _ref_chain_planes, encode_video)
from test_tpu_inter import panning
from torch_threads import one_torch_thread  # noqa: F401

PLAN_KEYS = ("split32", "mv8", "y_levels32", "y_levels16", "y_eob32",
             "y_eob16", "uv_levels16", "uv_levels8", "uv_eob16", "uv_eob8")


def edges(w, h, n, seed=0):
    """Sharp diagonal bars, slowly panning: content on which the CDEF
    gate keeps the filter on some frames and drops it on others."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 4 * n, 0:w + 4 * n]
    base = np.where(((xx + 2 * yy) // 11) % 2 == 0, 60, 190) \
        + np.where((xx // 23 + yy // 17) % 3 == 0, 30, 0)
    base = (base + rng.normal(0, 1.0, base.shape)).clip(0, 255)
    out = []
    for i in range(n):
        y = base[i:i + h, 2 * i:2 * i + w].astype(np.uint8)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = (128 + (y[::2, ::2] > 128) * 20).astype(np.uint8)
        out.append(Frame(y, u, v))
    return out


def encode_both(frames, cfg, **kw):
    pj, ej = encode_video_tpu(frames, cfg, **kw)
    pt, et = encode_video([convert.from_jax(f) for f in frames],
                          convert.from_jax(cfg), device="cpu", **kw)
    return pj, ej, pt, et


def assert_same_frames(ej, et):
    """Headers, plans and reference chains of two encoded GOPs."""
    for i, (a, b) in enumerate(zip(ej, et)):
        for f in ("filter_level", "filter_level_u", "filter_level_v"):
            assert getattr(b.fh.lf, f) == getattr(a.fh.lf, f), (i, f)
        ca, cb = a.fh.cdef, b.fh.cdef
        assert (cb.y_pri, cb.y_sec, cb.uv_pri, cb.uv_sec) == \
            (ca.y_pri, ca.y_sec, ca.uv_pri, ca.uv_sec), i
        if a.plan.get("inter"):
            assert b.plan["interp_filter"] == a.plan["interp_filter"], i
            for k in PLAN_KEYS:
                np.testing.assert_array_equal(b.plan[k], a.plan[k],
                                              err_msg=f"frame {i} {k}")
        for p, q in zip(_ref_chain_planes(b), _ref_chain_planes(a)):
            assert p.dtype == torch.int32
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))


def assert_decodes_to_chain(packets, encs):
    dec = Av1Decoder()
    out = []
    for p in packets:
        out.extend(dec.decode_packet(p))
    assert len(out) == len(encs)
    for i, (f, enc) in enumerate(zip(out, encs)):
        for name, d, r in zip("yuv", f.planes(), _ref_chain_planes(enc)):
            np.testing.assert_array_equal(
                r.numpy()[: d.shape[0], : d.shape[1]], d.astype(np.int32),
                err_msg=f"frame {i} {name}")


def plans_from_jax_key(frames, q, device="cpu"):
    """A JAX KEY frame (cdef_fixed, as encode_video_tpu codes it), and
    both packages' plans of frame 1 against it, the port's started from
    ``convert.chain_from_jax``."""
    cfg = EncoderConfig(base_q_idx=q, cdef_fixed=True)
    key = TpuFrameEncoder(frames[0], dataclasses.replace(
        cfg, base_q_idx=max(8, q - 60)))
    key.encode()
    w, h = frames[0].width, frames[0].height
    enc = GpuInterFrameEncoder(convert.from_jax(frames[1]),
                               convert.from_jax(cfg), crop_w=w,
                               crop_h=h, **convert.chain_from_jax(key, device),
                               device=device)
    args = (enc.srcp, q, enc.rdmult, enc.mi_rows, enc.mi_cols, w, h)
    want = JI.plan_inter_frame(args[0], [jnp.asarray(p) for p in
                                         key.ref_planes_dev], *args[1:],
                               fetch_recon=True)
    got = TI.plan_inter_frame(args[0], enc.ref_planes_dev, *args[1:],
                              device=device, fetch_recon=True)
    return want, got


def assert_same_plan(want, got):
    assert set(got) == set(want)
    assert got["interp_filter"] == want["interp_filter"]
    for k in PLAN_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for g, w in zip(got["recon"], want["recon"]):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def pan96():
    frames = panning(96, 64, 3, seed=96)
    return (frames, *encode_both(frames, EncoderConfig(base_q_idx=80)))


def test_gop_96x64_q80_matches_jax(pan96):
    frames, pj, ej, pt, et = pan96
    assert pt == pj
    assert et[0].seq.enable_cdef
    assert_same_frames(ej, et)
    assert set(et[1].timings) == {"plan_s", "pack_s"}
    for field in ("newmv_cdf", "partition_cdf", "txb_skip_cdf"):
        np.testing.assert_array_equal(getattr(et[-1].saved_fc, field),
                                      getattr(ej[-1].saved_fc, field))


def test_gop_96x64_decodes_to_port_chain(pan96):
    frames, pj, ej, pt, et = pan96
    assert_decodes_to_chain(pt, et)


@pytest.mark.parametrize("kw", [dict(cdef=False), dict(key_interval=2),
                                dict(forward_cdf=False, tf_key=False)])
def test_gop_options_match_jax(pan96, kw):
    frames = pan96[0]
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=80), **kw)
    assert pt == pj
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)


def test_edges_gop_with_cdef_on_matches_jax():
    """CDEF kept by the gate on some frames and dropped on others."""
    frames = edges(96, 64, 3)
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=160),
                                 kf_q_offset=0, tf_key=False)
    assert pt == pj
    on = [e.fh.cdef.y_pri[0] + e.fh.cdef.y_sec[0] > 0 for e in ej]
    assert any(on) and not all(on), on
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)


def test_plan_96x64_matches_jax_from_jax_key(pan96):
    want, got = plans_from_jax_key(pan96[0], 80)
    assert_same_plan(want, got)


def test_chain_from_jax_starts_port_p_frames(pan96):
    """Each P-frame, coded by the port from the JAX encoder's previous
    frame (KEY, then P), gives the reference's packet."""
    frames, pj, ej, pt, et = pan96
    cfg = EncoderConfig(base_q_idx=80, cdef_fixed=True)
    for i in (1, 2):
        chain = convert.chain_from_jax(ej[i - 1], "cpu")
        assert all(p.dtype == torch.int32 for p in chain["ref_planes_dev"])
        enc = GpuInterFrameEncoder(convert.from_jax(frames[i]),
                                   convert.from_jax(cfg), crop_w=96,
                                   crop_h=64, **chain, device="cpu")
        assert enc.encode() == pj[i]
        ref = TpuInterFrameEncoder(frames[i], cfg, ej[i - 1].seq,
                                   _ref_chain_planes(ej[i - 1]), 96, 64,
                                   prev_fc=ej[i - 1].saved_fc)
        assert ref.encode() == pj[i]


@pytest.mark.parametrize("q", [120, 200])
def test_key_frame_cdef_fixed_matches_jax(q):
    frame = edges(96, 64, 1, seed=q)[0]
    cfg = EncoderConfig(base_q_idx=q, cdef_fixed=True)
    ref = TpuFrameEncoder(frame, cfg)
    want = ref.encode()
    enc = GpuFrameEncoder(convert.from_jax(frame),
                          convert.from_jax(cfg), device="cpu")
    assert enc.encode() == want
    assert enc.seq.enable_cdef and enc.fh.cdef.y_pri[0] > 0
    for a, b in zip(enc.ref_planes_dev, ref.ref_planes_dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_decodes_to_chain([want], [enc])


def test_outside_the_slice_raises_for_inter_frames():
    """A lossless GOP stops at its KEY frame, as the reference's does."""
    frames = [convert.from_jax(f) for f in panning(64, 64, 2)]
    cfg = convert.from_jax(EncoderConfig(lossless=True))
    with pytest.raises(NotImplementedError):
        encode_video(frames, cfg, device="cpu")


def test_gop_search_cdef_matches_jax(pan96):
    """CDEF strengths searched on the KEY frame (P-frames keep the
    quantizer-derived ones): the packets equal encode_video_tpu's."""
    frames = pan96[0]
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=80,
                                                       search_cdef=True))
    assert pt == pj
    assert et[0].seq.enable_cdef and not et[0].cfg.cdef_fixed
    assert_same_frames(ej, et)
    assert_decodes_to_chain(pt, et)


def test_tune_psy_gop_matches_jax(pan96):
    """Per-16x16 SSIM rdmult grids on the P-frames (shared psy.py)."""
    frames = pan96[0]
    pj, ej, pt, et = encode_both(frames, EncoderConfig(base_q_idx=80,
                                                       tune_psy=True))
    assert np.ndim(et[1].rdmult) == 2
    assert pt == pj
    assert_same_frames(ej, et)
