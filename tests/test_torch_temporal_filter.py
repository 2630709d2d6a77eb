"""Port parity of the temporal filter: the per-frame weighting of kernel
KK's plain version (``tf_weight_accum_plain``) on libaom's four golden blocks
(``av1_apply_temporal_filter_c``, ``tests/golden/golden_tf.npz``) and
against the reference's per-block ``apply_temporal_filter`` on a frame of
partial blocks with sub-pel subblock MVs; ``temporal_filter_frames`` at
112x80 (partial blocks) against the reference's for 3- and 5-frame spans,
centres 0 and 2, strengths 0, 1 and 2; ``estimate_noise_level`` (float
``==``, including the -1.0 of too few smooth pixels) and
``filter_key_frame``, all on CPU tensors.
Tolerance: exact equality (accum / count, planes, floats)."""
import os

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder import temporal_filter as RTF
from aom_av1_psy_tpu.utils.frame import Frame
from aom_av1_psy_tpu_torch import convert
from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_tf.npz")


def _t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _zeros(shapes):
    return [torch.zeros(s, dtype=torch.int64) for s in shapes]


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("c", range(4))
def test_golden_blocks_through_plain_kk(golden, c):
    """B = 1: the block is the whole 32x32 plane; d_factor from the golden
    sub-pel MVs through the host's np.hypot at the golden 128x96 frame."""
    g = golden
    q, strength, mb_row, mb_col = (int(v) for v in g[f"tf{c}_misc"])
    rs = []
    for name, n in (("y", 32), ("u", 16), ("v", 16)):
        p = g[f"tf{c}_{name}"]
        rs.append(_t(p[mb_row * n:(mb_row + 1) * n,
                       mb_col * n:(mb_col + 1) * n]))
    pred = g[f"tf{c}_pred"].astype(np.int32)
    ps = [_t(pred[:1024].reshape(32, 32)), _t(pred[1024:1280].reshape(16, 16)),
          _t(pred[1280:1536].reshape(16, 16))]
    mvs = g[f"tf{c}_mvs"].astype(np.int64)
    dfac = [TF.d_factor(r, s, 128, 96) for r, s in mvs]
    params = TF.filter_params(q, strength, g[f"tf{c}_noise"].astype(
        np.float64))
    accum = _zeros([(32, 32), (16, 16), (16, 16)])
    count = _zeros([(32, 32), (16, 16), (16, 16)])
    TF.tf_weight_accum_plain(rs, ps, torch.zeros((1, 3, 2), dtype=torch.int32),
                       _t(g[f"tf{c}_mses"][None], torch.int64),
                       torch.tensor([dfac], dtype=torch.float64), params, 1,
                       1, 32, accum, count)
    want_acc = g[f"tf{c}_accum"].astype(np.int64)
    want_cnt = g[f"tf{c}_count"].astype(np.int64)
    for p, (lo, hi) in enumerate(((0, 1024), (1024, 1280), (1280, 1536))):
        np.testing.assert_array_equal(accum[p].numpy().ravel(),
                                      want_acc[lo:hi], err_msg=f"accum {p}")
        np.testing.assert_array_equal(count[p].numpy().ravel(),
                                      want_cnt[lo:hi], err_msg=f"count {p}")


@pytest.mark.parametrize("q,strength", [(30, 2), (150, 1), (60, 0)])
def test_plain_kk_equals_reference_blocks(q, strength):
    """A 80x48 frame (3 x 2 blocks: 32/16 wide, 32/16 tall): each block
    windowed inside its own border, chroma with the luma 2x2 sums, four
    sub-pel subblock MVs and MSEs per block; against the reference's
    apply_temporal_filter called block by block."""
    rng = np.random.default_rng(q)
    H, W = 48, 80
    ref = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    pred = [np.clip(r + rng.integers(-4, 5, r.shape), 0, 255)
            .astype(np.int32) for r in ref]
    pred[0][:16, :16] = 255 - ref[0][:16, :16]             # a bad match
    nbx, B = 3, 6
    mvs = rng.integers(-40, 41, (B, 4, 2))
    mvs[0] = 0
    mses = rng.integers(0, 60, (B, 4))
    noise = (1.7, 0.4, 3.1)
    org = np.zeros((B, 3, 2), np.int32)
    want_acc = [np.zeros(r.shape, np.int64) for r in ref]
    want_cnt = [np.zeros(r.shape, np.int64) for r in ref]
    for b in range(B):
        by, bx = (b // nbx) * 32, (b % nbx) * 32
        h, w = min(32, H - by), min(32, W - bx)
        for p in range(3):
            s = 1 if p else 0
            org[b, p] = (by >> s, bx >> s)
        sl = [(slice(by >> s, (by + h) >> s), slice(bx >> s, (bx + w) >> s))
              for s in (0, 1, 1)]
        RTF.apply_temporal_filter(
            [r[x] for r, x in zip(ref, sl)], [p[x] for p, x in zip(pred, sl)],
            noise, mvs[b], mses[b], q, strength, W, H, 1, 1,
            [a[x] for a, x in zip(want_acc, sl)],
            [c[x] for c, x in zip(want_cnt, sl)])
    dfac = torch.tensor([[TF.d_factor(r, c, W, H) for r, c in m]
                         for m in mvs], dtype=torch.float64)
    accum = _zeros([r.shape for r in ref])
    count = _zeros([r.shape for r in ref])
    TF.tf_weight_accum_plain([_t(r) for r in ref], [_t(p) for p in pred], _t(org),
                       _t(mses, torch.int64), dfac,
                       TF.filter_params(q, strength, noise), 1, 1, 32, accum,
                       count)
    for p in range(3):
        np.testing.assert_array_equal(accum[p].numpy(), want_acc[p])
        np.testing.assert_array_equal(count[p].numpy(), want_cnt[p])
    # strength 0 sends every weight to int(exp(-7) * 1000) = 0
    assert (len(np.unique(count[0].numpy())) > 50) == (strength > 0)


def test_distance_table_is_the_references_d_factor():
    """The per-frame table of full-pel MVs holds d_factor as the reference
    computes it (np.hypot of the 1/8-pel MV over 10 % of the short side)."""
    tab = TF.distance_table(16, 112, 80)
    for dy in range(-16, 17):
        for dx in range(-16, 17):
            dist = float(np.hypot(np.int64(8 * dy), np.int64(8 * dx)))
            assert tab[dy + 16, dx + 16] == max(dist / max(80 * 0.1, 1), 1.0)


def moving(n, w=112, h=80, seed=3):
    """A noisy sinusoid panning 2 px down and 3 px right per frame, with
    textured chroma: the search finds MVs toward every border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 40, 0:w + 40].astype(np.float32)
    base = 100 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    out = []
    for i in range(n):
        y = np.clip(base[2 * i:2 * i + h, 3 * i:3 * i + w]
                    + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(120 + 20 * np.sin(xx[:h:2, :w:2] / 5.0 + i)
                    + rng.normal(0, 2, (h // 2, w // 2)), 0, 255) \
            .astype(np.uint8)
        v = (255 - u).astype(np.uint8)
        out.append([y, u, v])
    return out


@pytest.mark.parametrize("strength", [0, 1, 2])
@pytest.mark.parametrize("center", [0, 2])
@pytest.mark.parametrize("n", [3, 5])
def test_filter_frames_matches_reference(n, center, strength):
    frames = moving(n, seed=n)
    noise = (2.5, 0.8, 1.3)
    want = RTF.temporal_filter_frames(frames, center, 250, strength,
                                      noise_levels=noise)
    got = TF.temporal_filter_frames(frames, center, 250, strength,
                                    noise_levels=noise, device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if strength:
        assert not np.array_equal(got[0], frames[center][0])


def test_filter_frames_takes_tensors():
    frames = moving(3)
    want = TF.temporal_filter_frames(frames, 1, 90, 2, device="cpu")
    got = TF.temporal_filter_frames(TF.upload(frames, "cpu"), 1, 90, 2,
                                    device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _noise_planes():
    f = moving(1)[0]
    rng = np.random.default_rng(4)
    return {"luma": f[0], "chroma": f[1],
            "flat 5x5 (9 inner pixels)": np.full((5, 5), 90, np.uint8),
            "flat 40x40": np.full((40, 40), 90, np.uint8),
            "edges everywhere": np.tile(np.kron(np.array(
                [[0, 255], [255, 0]], np.uint8), np.ones((2, 2), np.uint8)),
                (10, 10)),
            "noise 10-bit": rng.integers(0, 1024, (48, 64)).astype(np.uint16)}


@pytest.mark.parametrize("name", list(_noise_planes()))
def test_noise_level_equals_reference(name):
    plane = _noise_planes()[name]
    bd = 10 if plane.dtype == np.uint16 else 8
    want = RTF.estimate_noise_level(plane, bd=bd)
    got = TF.estimate_noise_level(plane, bd=bd, device="cpu")
    assert type(got) is float and got == want
    if name.startswith("flat 5x5") or name.startswith("edges"):
        assert got == -1.0
    assert TF.estimate_noise_level(torch.as_tensor(plane.astype(np.int32)),
                                   bd=bd) == want


@pytest.mark.parametrize("idx,n_span", [(0, 3), (2, 2), (3, 1)])
def test_filter_key_frame_matches_reference(idx, n_span):
    frames = [Frame(*f) for f in moving(4, seed=11)]
    port = [convert.from_jax(f) for f in frames]
    want = RTF.filter_key_frame(frames, idx, 250)
    got = TF.filter_key_frame(port, idx, 250, device="cpu")
    if n_span == 1:
        assert got is port[idx] and want is frames[idx]
        return
    for g, w in zip(got.planes(), want.planes(), strict=True):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got.y, port[idx].y)


def test_plain_weight_equals_numpy_at_every_boundary():
    """The plain version's weight (``torch.exp``) against the reference's
    ``np.exp`` at every truncation boundary of ``* 1000`` (101 values
    within 50 ulp of each of the 1000, and 0 and 7); KK's own weight is
    held to the same sweep on the card (``test_torch_tf_gpu.py``)."""
    s = TF.weight_boundary_values()
    got = TF.tf_weight(torch.as_tensor(s)).numpy()
    np.testing.assert_array_equal(
        got, (np.exp(-s) * TF.TF_WEIGHT_SCALE).astype(np.int64))


def test_plain_weight_equals_numpy_on_random_values():
    s = np.random.default_rng(0).random(10 ** 6) * 7.0
    np.testing.assert_array_equal(
        TF.tf_weight(torch.as_tensor(s)).numpy(),
        (np.exp(-s) * TF.TF_WEIGHT_SCALE).astype(np.int64))
