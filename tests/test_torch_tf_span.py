"""Port parity of kernel KK's plain version, one pass per span
(``tf_span_filter_plain``): against the per-frame composition it replaces
(the former ``SpanGrid.motion_inputs`` arithmetic written out here, then
``tf_weight_accum_plain`` for each frame, then the rounding) and against
the reference's ``temporal_filter_frames`` and ``filter_key_frame``, all
on CPU tensors (the reference is host numpy).
Cases: spans of 2 to 5 frames with the centre first, in the middle and
last; strengths 1 and 2; q factors that drive the non-centre weights to 0
(q 1) and to 999 (q 30000) and one between, and a static block where
every frame weighs 1000; frames of 112x80 (16-wide and
16-tall partial blocks), 88x56 (24-px partial blocks) and 66x48 (a last
block 2 px wide, its chroma block 1 wide), from a seeded numpy generator.
Tolerance: exact equality (uint8 planes, int64 sums)."""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder import temporal_filter as RTF
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from tf_span_cases import CASES, NOISE, SIZES, case_id, panning
from torch_threads import one_torch_thread  # noqa: F401


def _former(planes, center_idx, q, strength, noise, mb=32):
    """The per-frame composition the span pass replaces: for each
    non-centre frame the search and the former ``motion_inputs``
    arithmetic (origins, MSEs, distance factors), then
    ``tf_weight_accum_plain`` per frame into int64 planes, then the
    rounding. Returns (planes uint8, count)."""
    rad = TF.SEARCH_RAD
    center = planes[center_idx]
    grid = TF.SpanGrid(center, mb)
    accum = [torch.zeros(p.shape, dtype=torch.int64) for p in center]
    count = [torch.zeros_like(a) for a in accum]
    params = TF.filter_params(q, strength, noise)
    for fi, f in enumerate(planes):
        if fi == center_idx:
            inputs = grid.centre_inputs()
        else:
            padded = grid.padded(f[0])
            dy = torch.empty(grid.B, dtype=torch.int64)
            dx = torch.empty_like(dy)
            for hw, ids in grid.groups:
                mv, _ = MV.full_pel_plane_search(grid.src[hw], padded,
                                                 *grid.origins[hw], rad)
                dy[ids] = mv[:, 0].long()
                dx[ids] = mv[:, 1].long()
            org = []
            for p, (sy, sx) in enumerate(grid.shifts):
                ph, pw = f[p].shape
                r = torch.minimum(((grid.by + dy) >> sy).clamp(min=0),
                                  ph - (grid.hs >> sy))
                c = torch.minimum(((grid.bx + dx) >> sx).clamp(min=0),
                                  pw - (grid.ws >> sx))
                org.append(torch.stack([r, c], 1))
            org = torch.stack(org, 1)
            mses = torch.empty((grid.B, 4), dtype=torch.int64)
            for (h, w), ids in grid.groups:
                pred = MV.cut(f[0], org[ids, 0, 0], org[ids, 0, 1], h, w)
                dsq = (pred.to(torch.int64) - grid.src[(h, w)]) ** 2
                hh, hw = max(h // 2, 1), max(w // 2, 1)
                for si, (r0, c0) in enumerate(((0, 0), (0, hw), (hh, 0),
                                               (hh, hw))):
                    sub = dsq[:, r0:r0 + hh, c0:c0 + hw]
                    mses[ids, si] = sub.sum((1, 2)) // max(
                        sub.shape[1] * sub.shape[2], 1)
            dfac = grid.dtab[dy + rad, dx + rad][:, None].expand(grid.B, 4)
            inputs = org, mses, dfac
        TF.tf_weight_accum_plain(center, f, *inputs, params, 1, 1, mb, accum,
                                 count)
    out = []
    for a, n in zip(accum, count):
        c = n.clamp(min=1)
        out.append(((a + (c >> 1)) // c).clamp(0, 255).to(torch.uint8))
    return out, count


def _mvs(planes, center_idx, mb=32):
    grid = TF.SpanGrid(planes[center_idx], mb)
    mvs = torch.zeros((len(planes), grid.B, 2), dtype=torch.int32)
    for fi, f in enumerate(planes):
        if fi != center_idx:
            mvs[fi] = grid.motion_inputs(f)
    return mvs


@pytest.mark.parametrize("n,center,strength,q,size", CASES,
                         ids=[case_id(c) for c in CASES])
def test_span_plain_equals_the_former_composition(n, center, strength, q,
                                                  size):
    w, h = SIZES[size]
    planes = TF.upload(panning(n, w, h, seed=n * 10 + center), "cpu")
    want, count = _former(planes, center, q, strength, NOISE)
    params = TF.filter_params(q, strength, NOISE)
    mvs = _mvs(planes, center)
    got = TF.tf_span_filter_plain(center, planes, mvs, params)
    for g, w_ in zip(got, want, strict=True):
        assert g.dtype == torch.uint8 and torch.equal(g, w_)
    # the wrapper takes the plain version on CPU tensors, and launches
    # nothing
    n0 = TF.KK.launches
    for g, w_ in zip(TF.tf_span_filter(center, planes, mvs, params), want):
        assert torch.equal(g, w_)
    assert TF.KK.launches == n0
    # the static block weighs 1000 in every frame; elsewhere q 1 sends
    # every non-centre weight to 0, q 30000 close to 1000
    static = torch.zeros(count[0].shape, dtype=torch.bool)
    static[32:64, 32:64] = True
    assert (count[0][static] == 1000 * n).all()
    weight = (count[0][~static] - 1000).double() / (n - 1)
    if q == 1:
        assert (weight == 0).all()
    elif q == 30000:
        assert weight.mean() > 950
    else:
        assert 1 < weight.mean() < 900


@pytest.mark.parametrize("n,center,strength,q,size", CASES,
                         ids=[case_id(c) for c in CASES])
def test_span_filter_equals_reference(n, center, strength, q, size):
    w, h = SIZES[size]
    frames = panning(n, w, h, seed=n * 10 + center)
    want = RTF.temporal_filter_frames(frames, center, q, strength,
                                      noise_levels=NOISE)
    got = TF.temporal_filter_frames(frames, center, q, strength,
                                    noise_levels=NOISE, device="cpu")
    for g, w_ in zip(got, want, strict=True):
        assert g.dtype == np.uint8 and g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)
    if q == 1:
        np.testing.assert_array_equal(got[0], frames[center][0])


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("q_kf", [8, 250])
def test_filter_key_frame_equals_reference(size, q_kf):
    w, h = SIZES[size]
    frames = [Frame(*f) for f in panning(4, w, h, seed=q_kf + w)]
    port = [convert.from_jax(f) for f in frames]
    want = RTF.filter_key_frame(frames, 0, q_kf)
    got = TF.filter_key_frame(port, 0, q_kf, device="cpu")
    for g, w_ in zip(got.planes(), want.planes(), strict=True):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("n", [25, 26, 27, 29])
def test_divide_totals_on_cpu_is_the_references_quotient(n):
    """The plain division of every window total is the reference's
    ``total / num_ref_pixels`` (numpy, float64); the card's is held to the
    same values in ``test_torch_tf_gpu.py``."""
    want = np.arange(TF.MAX_TOTAL + 1, dtype=np.float64) / n
    got = TF.divide_totals(n, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert TF.MAX_TOTAL == 29 * 255 ** 2
