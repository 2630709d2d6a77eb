"""Port parity of kernel KJ's plane entry (``full_pel_plane_search``: each
block's search window read where it lies in a plane) through its plain
version (``cut`` + ``sad_argmin_plain``, on CPU tensors), against the
(src, win) entry ``full_pel_grid_search`` on the windows cut out, against
the reference's ``full_pel_grid_search`` (its jnp branch, on the CPU) on
windows built as the reference's temporal filter builds them (128 outside
the frame), and ``SpanGrid.motion_inputs`` (the search), with
``SpanGrid.weight_inputs`` after it, against the former window path
written out here: the (B, h + 32, w + 32) windows cut from the padded frame
and searched through the (src, win) entry.
Cases: 32x32, 32x24, 24x32 and 24x24 blocks, radius 16 (and 2 / 6 on a
16x24 block), blocks at every frame border (the window holds the
128 fill), flat 0 / 255 / 128 blocks (ties on many offsets), planted
matches and noise, ``sad_per_bit`` 0 and 4.
Tolerance: exact equality (MVs, SADs, origins, MSEs, distance factors)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import mvsearch as RMV
from aom_av1_psy_tpu_torch.encoder import temporal_filter as TF
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from aom_av1_psy_tpu_torch.utils import testframes
from torch_threads import one_torch_thread  # noqa: F401

RAD = 16


def _frame(H, W, seed):
    """int32 luma: noise with a flat 0 patch top-left and a flat 255 patch
    bottom-right (the flat blocks below tie on many offsets there)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    y[:48, :48] = 0
    y[-48:, -48:] = 255
    return y


def _case(h, w, seed):
    """(frame, src (B, h, w), origins oy / ox (B,)) in frame coordinates:
    blocks at the four corners, the borders and inside; src planted from
    the frame near each origin, with noise, or flat 0 / 255 / 128."""
    H, W = 72, 104
    y = _frame(H, W, seed)
    rng = np.random.default_rng(seed + 1)
    oys = [0, H - h, 0, H - h, 0, H - h, (H - h) // 2, (H - h) // 2, 5, 17,
           0, H - h]
    oxs = [0, W - w, W - w, 0, (W - w) // 2, 9, 0, W - w, 40, 23, 3, W - w]
    src = []
    for b, (oy, ox) in enumerate(zip(oys, oxs)):
        kind = b % 6
        if kind == 0:
            src.append(np.zeros((h, w), np.int32))
        elif kind == 1:
            src.append(np.full((h, w), 255, np.int32))
        elif kind == 2:
            src.append(np.full((h, w), 128, np.int32))
        elif kind == 3:
            src.append(rng.integers(0, 256, (h, w)).astype(np.int32))
        else:
            dy, dx = rng.integers(-RAD, RAD + 1, 2)
            ys = np.clip(np.arange(oy + dy, oy + dy + h), 0, H - 1)
            xs = np.clip(np.arange(ox + dx, ox + dx + w), 0, W - 1)
            blk = y[np.ix_(ys, xs)]
            if kind == 5:
                blk = np.clip(blk + rng.integers(-3, 4, blk.shape), 0, 255)
            src.append(blk.astype(np.int32))
    return y, np.stack(src), np.array(oys), np.array(oxs)


def _reference_windows(y, oys, oxs, h, w):
    """The reference temporal filter's windows: 128, then the frame where
    the window overlaps it (``aom_av1_psy_tpu/encoder/temporal_filter.py``
    :131-137)."""
    H, W = y.shape
    out = []
    for by, bx in zip(oys, oxs):
        win = np.full((h + 2 * RAD, w + 2 * RAD), 128, np.int32)
        y0, x0 = by - RAD, bx - RAD
        ys, xs = max(0, y0), max(0, x0)
        ye, xe = min(H, y0 + h + 2 * RAD), min(W, x0 + w + 2 * RAD)
        win[ys - y0:ye - y0, xs - x0:xe - x0] = y[ys:ye, xs:xe]
        out.append(win)
    return np.stack(out)


def _np(res):
    mvs, sad = res
    assert mvs.dtype == torch.int32 and sad.dtype == torch.int32
    return mvs.numpy(), sad.numpy()


@pytest.mark.parametrize("sad_per_bit", [0, 4])
@pytest.mark.parametrize("h,w", [(32, 32), (32, 24), (24, 32), (24, 24)])
def test_plane_search_matches_windows_and_reference(h, w, sad_per_bit):
    y, src, oys, oxs = _case(h, w, seed=h * 7 + w + sad_per_bit)
    grid = TF.SpanGrid([torch.as_tensor(y)] * 3)
    padded = grid.padded(torch.as_tensor(y))
    ref_win = _reference_windows(y, oys, oxs, h, w)
    # the padded frame's patches are the reference's windows
    win = MV.cut(padded, torch.as_tensor(oys), torch.as_tensor(oxs),
                 h + 2 * RAD, w + 2 * RAD)
    np.testing.assert_array_equal(win.numpy(), ref_win)
    s, oy, ox = torch.as_tensor(src), torch.as_tensor(oys), \
        torch.as_tensor(oxs)
    plain = _np(MV.full_pel_plane_search_plain(s, padded, oy, ox, RAD,
                                               sad_per_bit))
    wrapped = _np(MV.full_pel_plane_search(s, padded, oy.int(), ox.int(),
                                           RAD, sad_per_bit))
    windows = _np(MV.full_pel_grid_search(s, win, RAD, sad_per_bit))
    ref = RMV.full_pel_grid_search(jnp.asarray(src), jnp.asarray(ref_win),
                                   RAD, sad_per_bit)
    for got in (wrapped, windows, tuple(np.asarray(r) for r in ref)):
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p)
    if not sad_per_bit:
        # flat blocks in the flat corners tie at SAD 0 on hundreds of
        # offsets: the first (dy-major) wins
        assert plain[0][0].tolist() == [0, 0] and plain[1][0] == 0
        assert plain[0][1].tolist() == [-RAD, -RAD] and plain[1][1] == 0


@pytest.mark.parametrize("radius,sad_per_bit", [(2, 0), (6, 4), (16, 0)])
def test_plane_search_matches_reference_at_any_radius(radius, sad_per_bit):
    """``full_pel_plane_search`` (its plain version, on CPU tensors) at
    radius 2 / 6 / 16 (m = 5, 13, 33: a short, a partly phantom and three
    whole strips of KJ's 12) against the reference's jnp
    ``full_pel_grid_search`` on windows sliced out with numpy, with the cost
    grid; origins anywhere in the plane, flat blocks on a flat patch."""
    rng = np.random.default_rng(radius)
    h, w, B = 16, 24, 30
    m = 2 * radius + 1
    plane = rng.integers(0, 256, (80, 96)).astype(np.int32)
    plane[30:60, 40:90] = 77
    oy = rng.integers(0, 80 - (h + m - 1) + 1, B)
    ox = rng.integers(0, 96 - (w + m - 1) + 1, B)
    src = rng.integers(0, 256, (B, h, w)).astype(np.int32)
    src[:5] = 77
    win = np.stack([plane[y:y + h + m - 1, x:x + w + m - 1]
                    for y, x in zip(oy, ox)])
    got = _np(MV.full_pel_plane_search(
        torch.as_tensor(src), torch.as_tensor(plane), torch.as_tensor(oy),
        torch.as_tensor(ox), radius, sad_per_bit))
    ref = RMV.full_pel_grid_search(jnp.asarray(src), jnp.asarray(win),
                                   radius, sad_per_bit)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def _former_motion_inputs(grid, f):
    """``SpanGrid.motion_inputs`` as it was before KJ's plane entry: the
    padded frame, each block's (h + 32, w + 32) window cut out, the
    (src, win) search; then the same origins, MSEs and distance factors."""
    rad = TF.SEARCH_RAD
    padded = torch.full((grid.H + 2 * rad, grid.W + 2 * rad), TF.FILL,
                        dtype=torch.int32)
    padded[rad:rad + grid.H, rad:rad + grid.W] = f[0]
    dy = torch.empty(grid.B, dtype=torch.int64)
    dx = torch.empty_like(dy)
    for (h, w), ids in grid.groups:
        r = grid.by[ids][:, None] + torch.arange(h + 2 * rad)[None]
        c = grid.bx[ids][:, None] + torch.arange(w + 2 * rad)[None]
        win = padded[r[:, :, None], c[:, None, :]]
        mv, _ = MV.full_pel_grid_search(grid.src[(h, w)], win, rad)
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
        rr = org[ids, 0, 0][:, None] + torch.arange(h)[None]
        cc = org[ids, 0, 1][:, None] + torch.arange(w)[None]
        pred = f[0][rr[:, :, None], cc[:, None, :]]
        dsq = (pred.to(torch.int64) - grid.src[(h, w)]) ** 2
        hh, hw = max(h // 2, 1), max(w // 2, 1)
        for si, (r0, c0) in enumerate(((0, 0), (0, hw), (hh, 0), (hh, hw))):
            sub = dsq[:, r0:r0 + hh, c0:c0 + hw]
            mses[ids, si] = sub.sum((1, 2)) // max(sub.shape[1] *
                                                   sub.shape[2], 1)
    dfac = grid.dtab[dy + rad, dx + rad][:, None].expand(grid.B, 4)
    return org, mses, dfac


@pytest.mark.parametrize("w,h,seed", [(88, 56, 3), (112, 80, 4),
                                      (64, 48, 5)])
def test_motion_inputs_equal_the_former_window_path(w, h, seed):
    """88x56: blocks of 32x32, 32x24, 24x32 and 24x24; 112x80: 16-wide and
    16-tall partial blocks; 64x48: 32x16."""
    frames = testframes.make_gop(w, h, 5, seed=seed)
    planes = TF.upload([f.planes() for f in frames], "cpu")
    planes[4][0][:24, :40] = 200                 # a flat patch: ties
    grid = TF.SpanGrid(planes[2])
    n0 = MV.KJ.launches
    for fi in (0, 1, 3, 4):
        got = grid.weight_inputs(planes[fi], grid.motion_inputs(planes[fi]))
        want = _former_motion_inputs(grid, planes[fi])
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and torch.equal(g, w_)
    assert MV.KJ.launches == n0                  # CPU tensors: plain only
