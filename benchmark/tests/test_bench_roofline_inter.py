"""The inter and temporal-filter yardstick (``harness/roofline_inter.py``)
equals ``chip_smoke.py``'s bounds of phases 3b and 3e: each stage's bytes
are the smoke's ``nbytes`` of the inputs the plain versions take and the
outputs they return (on CPU tensors at small shapes), its operations the
smoke's counts, and ``bound`` the smoke's. The frame's stage list equals
the calls the plan makes today (their wrappers intercepted on a CPU
plan), the spans the calls of a CPU chunk's temporal filters, and the
CDEF switch the program's quantizer-derived strengths at every q."""
import sys

import numpy as np
import pytest

from _tiny import ROOT

sys.path.insert(0, ROOT)

RAD = 16
N = 2 * RAD + 1


def _config():
    """The random-access configuration's encoder settings."""
    import json
    import os
    from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "ra-psy-q110.json")) as f:
        return EncoderConfig(**json.load(f)["encoder"])


def _frames(n: int, w: int, h: int) -> list:
    """n frames of the cell's scene at w x h (its object a quarter of the
    height, inside the frame)."""
    import json
    import os
    from aom_av1_psy_tpu_torch.utils.frame import Frame
    from benchmark.harness import content
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "scene-chunks-720p.json")) as f:
        t = json.load(f)
    t.update(width=w, height=h, frames=n, pool=1,
             object={**t["object"], "size": h // 4, "start": [w // 8, h // 4]})
    return content.make(t, 7, "cpu", Frame)[0][0]


def _t(a, dtype=None):
    import torch
    return torch.as_tensor(np.asarray(a)).to(dtype or torch.int32)


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bw,B,K,src,pred", [
    (16, 12, 9, True, False),      # the smoke's timed case: SAD only
    (16, 12, 3, True, True), (32, 3, 5, True, True),
    (8, 12, 1, False, True), (16, 3, 1, False, True)])
def test_kd_matches_the_smoke(bw, B, K, src, pred):
    import chip_smoke as S
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
    from aom_av1_psy_tpu_torch.ops import mc as MC
    from benchmark.harness import roofline_inter as RI
    rng = np.random.default_rng(1)
    plane = _t(rng.integers(0, 256, (48, 64)))
    by, bx = TI._origins(B, 64 // bw, bw, "cpu")
    qr = _t(rng.integers(-40, 40, (K, B)))
    qc = _t(rng.integers(-40, 40, (K, B)))
    kern = TI._all_kernels("cpu")[torch.arange(K) % 3]
    s = _t(rng.integers(0, 256, (B, bw, bw))) if src else None
    a = (plane, by, bx, qr, qc, bw, 48, 64, kern)
    out = MC.mc_8tap(*a, src=s, want_pred=pred)
    want = S.bound(S.nbytes(a, s, out), 35 * K * B * bw * bw)
    assert RI.kd_bytes(plane.numel(), B, bw, K, src, pred) == \
        S.nbytes(a, s, out)
    assert RI.kd_ops(B, bw, K) == 35 * K * B * bw * bw
    assert RI.bound(RI.kd_bytes(plane.numel(), B, bw, K, src, pred),
                    RI.kd_ops(B, bw, K)) == want


@pytest.mark.parametrize("bw,centres", [(8, False), (16, True)])
def test_ke_matches_the_smoke(bw, centres):
    import chip_smoke as S
    from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
    from aom_av1_psy_tpu_torch.ops import fullpel as FP
    from benchmark.harness import roofline_inter as RI
    rng = np.random.default_rng(2)
    pl = rng.integers(0, 256, (48, 64))
    B = (48 // bw) * (64 // bw)
    by, bx = TI._origins(B, 64 // bw, bw, "cpu")
    src = TI._blocks(_t(np.roll(pl, (3, -5), (0, 1))), bw).contiguous()
    kw = dict(cy=_t(rng.integers(-8, 9, B)),
              cx=_t(rng.integers(-8, 9, B))) if centres else {}
    a = (src, _t(pl), by, bx, 48, 64, bw)
    out = FP.fullpel_search(*a, **kw)
    ops = 3 * N * N * B * bw * bw
    assert RI.ke_bytes(pl.size, B, bw, centres) == S.nbytes(a, kw, out)
    assert RI.ke_ops(B, bw) == ops
    assert RI.bound(RI.ke_bytes(pl.size, B, bw, centres), RI.ke_ops(B, bw)) \
        == S.bound(S.nbytes(a, kw, out), ops)


@pytest.mark.parametrize("bs,key", [(16, "y16"), (32, "y32"), (8, "uv8"),
                                    (16, "uv16")])
def test_kb_matches_the_smoke(bs, key):
    import chip_smoke as S
    import torch
    from aom_av1_psy_tpu_torch.encoder import tpu_intra as TIN
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import FrameContext, tables
    from aom_av1_psy_tpu_torch.ops import txq as TQ
    from benchmark.harness import roofline_inter as RI
    rng = np.random.default_rng(3)
    B = 6
    rt = {k: tuple(_t(x, torch.float32) for x in v)
          for k, v in TIN._rate_tables(FrameContext(100)).items()}
    src = _t(rng.integers(0, 256, (B, bs, bs)))
    pred = _t(np.clip(np.asarray(src) + rng.integers(-30, 31, (B, bs, bs)),
                      0, 255))
    rdm = _t(rng.uniform(5e3, 6e4, B), torch.float32)
    a = (src, pred, tables.dc_quant(100), tables.ac_quant(100),
         TIN._scan(TIN.BS_TO_TX[bs], "cpu"), rdm, *rt[key])
    out = TQ.txq_recon_skip(*a)
    assert RI.kb_bytes(B, bs) == S.nbytes(a, out)
    assert RI.txq_ops(B, bs) == S._txq_ops(B, bs)


def test_kf_matches_the_smoke():
    # the smoke's planes are taller than the filtered mi area (1088 rows
    # for 1080): here 64 rows of planes for 56 filtered
    import chip_smoke as S
    import torch
    from aom_av1_psy_tpu_torch.ops import cdef_torch as CT
    from benchmark.harness import roofline_inter as RI
    rng = np.random.default_rng(4)
    ph, pw, mh, mw = 64, 64, 56, 64
    planes = (_t(rng.integers(0, 256, (ph, pw))),
              _t(rng.integers(0, 256, (ph // 2, pw // 2))),
              _t(rng.integers(0, 256, (ph // 2, pw // 2))))
    srcs = [_t(np.clip(np.asarray(p) + rng.integers(-9, 10, p.shape), 0,
                       255)) for p in planes]
    skip8 = _t(rng.random((mh // 8, mw // 8)) < .3, torch.bool)
    out = CT.cdef_frame(planes, skip8, 1, 1, 0, 1, 4, mi_rows=mh // 4,
                        mi_cols=mw // 4, nplanes=3, srcs=srcs)
    npx = mh * mw * 3 // 2
    ops = 150 * npx + 16 * mh * mw
    assert RI.kf_bytes(mh, mw, ph, pw) == S.nbytes(planes, out, srcs, skip8)
    assert RI.kf_ops(mh, mw) == ops
    assert RI.bound(RI.kf_bytes(mh, mw, ph, pw), RI.kf_ops(mh, mw)) == \
        S.bound(S.nbytes(planes, out, srcs, skip8), ops)


@pytest.mark.parametrize("h,w", [(32, 32), (16, 32), (32, 8)])
def test_kj_matches_the_smoke(h, w):
    import chip_smoke as S
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    from benchmark.harness import roofline_inter as RI
    rng = np.random.default_rng(5)
    B = 3
    src = _t(rng.integers(0, 256, (B, h, w)))
    win = _t(rng.integers(0, 256, (B, h + 2 * RAD, w + 2 * RAD)))
    out = MV.full_pel_grid_search(src, win, RAD)
    ops = 3 * N * N * B * h * w
    assert RI.kj_bytes(B, h, w) == S.nbytes(src, win, out)
    assert RI.kj_ops(B, h, w) == ops
    assert RI.bound(RI.kj_bytes(B, h, w), RI.kj_ops(B, h, w)) == \
        S.bound(S.nbytes(src, win, out), ops)


@pytest.mark.parametrize("n,c", [(3, 0), (5, 2)])
def test_kk_matches_the_smoke(n, c):
    import chip_smoke as S
    import torch
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    from benchmark.harness import roofline_inter as RI
    H, W = 48, 80
    sp = TF.upload([f.planes() for f in _frames(n, W, H)], "cpu")
    grid = TF.SpanGrid(sp[c])
    mvs = torch.zeros((n, grid.B, 2), dtype=torch.int32)
    for fi, f in enumerate(sp):
        if fi != c:
            mvs[fi] = grid.motion_inputs(f)
    noise = [max(TF.estimate_noise_level(p), 0.0) for p in sp[c]]
    got = TF.tf_span_filter(c, sp, mvs, TF.filter_params(30, 2, noise))
    npix = sum(p.numel() for p in sp[c])
    k = n - 1
    want = S.bound(S.nbytes(sp, mvs, got), (20 * k + 5) * npix,
                   11 * k * npix)
    assert RI.kk_bytes(n, H, W, grid.B) == S.nbytes(sp, mvs, got)
    assert RI.kk_ops(n, H, W) == ((20 * k + 5) * npix, 11 * k * npix)
    assert RI.bound(RI.kk_bytes(n, H, W, grid.B), *RI.kk_ops(n, H, W)) \
        == want


def test_smoke_constants_are_the_harness_constants():
    import chip_smoke as S
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    from aom_av1_psy_tpu_torch.ops import fullpel as FP
    from benchmark.harness import roofline_inter as RI
    assert RI.SEARCH_RAD == FP.SEARCH_RAD == TF.SEARCH_RAD == RAD
    assert RI.bound(1e9, 1e12, 1e10) == S.bound(1e9, 1e12, 1e10)


def test_inter_frame_stages_are_the_plans_calls(monkeypatch):
    """Every call of KE, KD and KB's batched entry in a CPU plan at
    160 x 96 (5 x 3 cells of 32), with its bound, is a stage of
    ``inter_plan_bound_s``, and the sum is the frame's bound."""
    from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
    from aom_av1_psy_tpu_torch.encoder.tpu_interframe import \
        GpuInterFrameEncoder
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import GpuFrameEncoder
    from aom_av1_psy_tpu_torch.ops import fullpel as FP
    from aom_av1_psy_tpu_torch.ops import mc as MC
    from aom_av1_psy_tpu_torch.ops import txq as TQ
    from benchmark.harness import roofline_inter as RI
    w, h = 160, 96
    f0, f1 = _frames(2, w, h)
    key = GpuFrameEncoder(f0, _config(), device="cpu")
    key.encode()
    calls = []

    def spy(fn, tag):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            calls.append((tag, a, kw, out))
            return out
        return wrapped

    monkeypatch.setattr(MC, "mc_8tap", spy(MC.mc_8tap, "KD"))
    monkeypatch.setattr(FP, "fullpel_search", spy(FP.fullpel_search, "KE"))
    monkeypatch.setattr(TQ, "txq_recon_skip", spy(TQ.txq_recon_skip, "KB"))
    enc = GpuInterFrameEncoder(f1, _config(), key.seq, key.ref_planes_dev,
                               w, h, device="cpu")
    TI.plan_inter_frame(enc.srcp, enc.ref_planes_dev, 110, enc.rdmult,
                        enc.mi_rows, enc.mi_cols, w, h, device="cpu")
    total_ms = 0.0
    for tag, a, kw, out in calls:
        if tag == "KD":
            src = kw.get("src")
            pred = kw.get("want_pred", True)
            K, B = a[3].shape
            b = RI.kd_bytes(a[0].numel(), B, a[5], K, src is not None, pred)
            total_ms += RI.bound(b, RI.kd_ops(B, a[5], K))["bound_ms"]
        elif tag == "KE":
            B, bw = a[0].shape[0], a[0].shape[1]
            b = RI.ke_bytes(a[1].numel(), B, bw, "cy" in kw)
            total_ms += RI.bound(b, RI.ke_ops(B, bw))["bound_ms"]
        else:
            B, bs = a[0].shape[0], a[0].shape[1]
            total_ms += RI.bound(RI.kb_bytes(B, bs),
                                 RI.txq_ops(B, bs))["bound_ms"]
    assert [c[0] for c in calls].count("KE") == 2
    assert [c[0] for c in calls].count("KD") == 12
    assert [c[0] for c in calls].count("KB") == 6
    assert RI.inter_plan_bound_s(w, h) == pytest.approx(total_ms / 1e3,
                                                        rel=1e-12)


def test_tf_spans_are_the_chunks_calls(monkeypatch):
    """The KJ searches and KK spans of a CPU chunk (a KEY and two star
    groups of 4 at 96 x 80: full blocks and a partial bottom row) are the
    ones ``key_span``, ``arf_spans`` and ``tf_groups`` count."""
    from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
    from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
    from aom_av1_psy_tpu_torch.ops import mvsearch as MV
    from benchmark.harness import roofline_inter as RI
    w, h, T = 96, 80, 9
    searches, spans = [], []

    def search(src, *a, **kw):
        searches.append(tuple(src.shape))
        return plane_search(src, *a, **kw)

    def span(c, planes, *a, **kw):
        spans.append(len(planes))
        return span_filter(c, planes, *a, **kw)

    plane_search, span_filter = MV.full_pel_plane_search, TF.tf_span_filter
    monkeypatch.setattr(MV, "full_pel_plane_search", search)
    monkeypatch.setattr(TF, "tf_span_filter", span)
    TIF.encode_video_arf(_frames(T, w, h), _config(), group=4, device="cpu")
    assert spans == [RI.key_span(T)] + RI.arf_spans(T, 4) == [3, 5, 3]
    groups = RI.tf_groups(w, h)
    assert groups == [(32, 32, 6), (16, 32, 3)]
    want = [(b, gh, gw) for n in spans for _ in range(n - 1)
            for gh, gw, b in groups]
    assert searches == want


def test_spans_and_groups_at_the_cells_size():
    from benchmark.harness import roofline_inter as RI
    assert RI.arf_spans(65, 16) == [5, 5, 5, 3]
    assert RI.key_span(65) == 3
    assert RI.tf_groups(1280, 720) == [(32, 32, 880), (16, 32, 40)]
    assert RI.tf_groups(1920, 1080) == [(32, 32, 1980), (24, 32, 60)]
    assert RI.padded(1280, 720) == (180, 320, 736, 1280)


def test_cdef_switch_is_the_programs():
    from aom_av1_psy_tpu_torch.bitstream.headers import FrameHeader
    from aom_av1_psy_tpu_torch.encoder.tpu_frame import cdef_fixed_strengths
    from benchmark.harness import roofline_inter as RI
    for q in range(256):
        fh = FrameHeader(width=64, height=64)
        cdef_fixed_strengths(fh, q)
        c = fh.cdef
        on = any((c.y_pri[0], c.y_sec[0], c.uv_pri[0], c.uv_sec[0]))
        assert RI.cdef_on(q) == on, q
