"""KF's frame pass on the CPU: the direction search's plain version
``find_dir_plain`` against both numpy ``find_dir_blocks`` (the port's and
the reference's ``ops/cdef.py``) on random blocks and on extreme ones
(constant 0 / 255, stripes along each direction, checkerboards, blocks
whose costs tie); the tiling KF's CTAs rest on (each 64-px luma / 32-px
chroma tile with its 2-px halo alone gives the whole-plane result, at
planes that are no multiple of 64 and mi areas smaller than the plane);
and the frame entry's plain version ``cdef_frame_plain``, directions
included, against the reference's ``cdef_apply_fused`` fed with the numpy
directions, its gate sums against numpy int64 sums. Tolerance: exact
equality."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import cdef as HC_ref
from aom_av1_psy_tpu.ops import cdef_jax as DC
from aom_av1_psy_tpu_torch.ops import cdef as HC
from aom_av1_psy_tpu_torch.ops import cdef_torch as TC
from cdef_cases import LINES, as_plane, blocky, extreme_blocks
from torch_threads import one_torch_thread  # noqa: F401


def _check_dirs(blocks):
    blocks = blocks.astype(np.int32)
    got_d, got_v = TC.find_dir_plain(torch.as_tensor(as_plane(blocks)), 8,
                                     8 * len(blocks))
    for find in (HC.find_dir_blocks, HC_ref.find_dir_blocks):
        want_d, want_v = find(blocks, 0)
        np.testing.assert_array_equal(got_d.numpy(), want_d)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    return got_d.numpy(), got_v.numpy()


@pytest.mark.parametrize("seed", range(4))
def test_find_dir_plain_matches_numpy_on_random_planes(seed):
    rng = np.random.default_rng(seed)
    h, w = [(64, 96), (136, 200), (200, 328), (8, 8)][seed]
    y = rng.integers(0, 256, (h + 8, w + 16)).astype(np.int32)
    if seed == 1:                                 # smooth, low variance
        y = (y // 64) * 3 + 100
    yb = y[:h, :w].reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    got_d, got_v = TC.find_dir_plain(torch.as_tensor(y), h, w)
    for find in (HC.find_dir_blocks, HC_ref.find_dir_blocks):
        want_d, want_v = find(yb, 0)
        np.testing.assert_array_equal(got_d.numpy(), want_d)
        np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_find_dir_plain_on_extreme_blocks():
    blocks = extreme_blocks()
    dirs, var = _check_dirs(blocks)
    assert dirs[0] == dirs[1] == 0 and var[0] == var[1] == 0
    # the stripes and checkerboards reach every direction and a large var
    assert set(dirs) == set(range(8)) and var.max() > 500000


def test_symmetric_blocks_tie_and_take_the_first_direction():
    """On a block symmetric about its diagonal the costs of 1 and 7, 2 and
    6, 3 and 5 are equal: numpy's argmax, and the plain version, take the
    first; the test makes sure such ties win often."""
    blocks = extreme_blocks()[-48:]
    x = blocks.astype(np.int64) - 128
    _, w = TC._dir_tables()
    partial = np.zeros((len(blocks), 8, 15), np.int64)
    ii, jj = np.mgrid[0:8, 0:8]
    for d in range(8):
        np.add.at(partial[:, d], (slice(None), LINES[d](ii, jj)), x)
    cost = (partial ** 2 * w).sum(-1)
    np.testing.assert_array_equal(cost[:, 1], cost[:, 7])
    np.testing.assert_array_equal(cost[:, 2], cost[:, 6])
    np.testing.assert_array_equal(cost[:, 3], cost[:, 5])
    dirs, _ = _check_dirs(blocks)
    assert (dirs == np.argmax(cost, 1)).all()
    assert set(dirs) & {1, 2, 3}                   # tied maxima were taken


# ---------------------------------------------------------------------------
# KF's tiles

# luma plane (H, W) and mi area (mh, mw): exact tiles, planes no multiple
# of 64, mi areas smaller than the plane
GEOMETRIES = [(64, 96, 64, 96), (136, 200, 136, 200), (208, 336, 200, 328),
              (144, 176, 112, 160)]
# (y_pri, y_sec, uv_pri, uv_sec, damping): the 1080p P-frame's at q100
# (1, 1, 0, 1, 4), both on, strong, secondary only
STRENGTHS = [(1, 1, 0, 1, 4), (4, 2, 3, 1, 5), (15, 4, 12, 4, 6),
             (0, 2, 0, 2, 3)]


@functools.cache
def _frame_case(geo):
    H, W, mh, mw = geo
    rng = np.random.default_rng(H + W)
    planes = [blocky(rng, (H, W)), blocky(rng, (H // 2, W // 2)),
              blocky(rng, (H // 2, W // 2))]
    skip8 = rng.random((mh // 8 + 1, mw // 8 + 2)) < .25
    return planes, skip8


def _run(planes, skip8, geo, st):
    H, W, mh, mw = geo
    outs, dirs, var, _ = TC.cdef_frame_plain(
        tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(skip8),
        *st, mi_rows=mh // 4, mi_cols=mw // 4, nplanes=3)
    return [o.numpy() for o in outs], dirs.numpy(), var.numpy()


@functools.cache
def _whole(geo, st):
    planes, skip8 = _frame_case(geo)
    return _run(planes, skip8, geo, st)


def test_kf_tiles_partition_the_planes():
    for H, W, _, _ in GEOMETRIES:
        for bs, (h, w) in ((8, (H, W)), (4, (H // 2, W // 2))):
            cover = np.zeros((h, w), np.int32)
            for y0, y1, x0, x1 in TC.kf_tiles(h, w, bs):
                assert y1 - y0 <= 8 * bs and x1 - x0 <= 8 * bs
                assert y0 % (8 * bs) == 0 and x0 % (8 * bs) == 0
                cover[y0:y1, x0:x1] += 1
            assert (cover == 1).all()


@pytest.mark.parametrize("st", STRENGTHS)
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_each_tile_depends_only_on_its_halo(geo, st):
    """For each of four phases (tile row and column parity) the tiles of
    the phase keep their pixels and their 2-px halo in all three planes,
    everything else is random: the kept tiles, and their blocks'
    directions and variances, equal the whole-frame run."""
    H, W, mh, mw = geo
    planes, skip8 = _frame_case(geo)
    want, want_d, want_v = _whole(geo, st)
    nb_c = mw // 8
    rng = np.random.default_rng(sum(st))
    tiles = [TC.kf_tiles(H, W, 8), TC.kf_tiles(H // 2, W // 2, 4)]
    for phase in ((0, 0), (0, 1), (1, 0), (1, 1)):
        noisy = [blocky(rng, p.shape) for p in planes]
        kept = []
        for p, (pl, bs) in enumerate(zip(planes, (8, 4, 4))):
            T = 8 * bs
            for y0, y1, x0, x1 in tiles[p > 0]:
                if ((y0 // T) % 2, (x0 // T) % 2) != phase:
                    continue
                hy0, hx0 = max(y0 - TC.HALO, 0), max(x0 - TC.HALO, 0)
                noisy[p][hy0:y1 + TC.HALO, hx0:x1 + TC.HALO] = \
                    pl[hy0:y1 + TC.HALO, hx0:x1 + TC.HALO]
                kept.append((p, y0, y1, x0, x1))
        got, got_d, got_v = _run(noisy, skip8, geo, st)
        for p, y0, y1, x0, x1 in kept:
            np.testing.assert_array_equal(got[p][y0:y1, x0:x1],
                                          want[p][y0:y1, x0:x1],
                                          err_msg=f"plane {p} tile "
                                                  f"{(y0, x0)}")
            if p == 0:
                rows = np.arange(y0 // 8, min(y1, mh) // 8)
                cols = np.arange(x0 // 8, min(x1, mw) // 8)
                b = (rows[:, None] * nb_c + cols[None]).reshape(-1)
                np.testing.assert_array_equal(got_d[b], want_d[b])
                np.testing.assert_array_equal(got_v[b], want_v[b])


# ---------------------------------------------------------------------------
# the frame entry against the reference


@pytest.mark.parametrize("with_srcs", [True, False])
@pytest.mark.parametrize("nplanes", [3, 1])
@pytest.mark.parametrize("w,h,st,seed", [
    (176, 144, (1, 1, 0, 1, 4), 0), (96, 64, (9, 1, 6, 2, 5), 1),
    (128, 128, (0, 2, 0, 1, 3), 2), (96, 64, (0, 0, 0, 0, 5), 3),
])
def test_frame_plain_matches_jax(w, h, st, seed, nplanes, with_srcs):
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = h // 4, w // 4
    planes = [blocky(rng, (h + 16, w + 32)),
              blocky(rng, (h // 2 + 8, w // 2 + 16)),
              blocky(rng, (h // 2 + 8, w // 2 + 16))][:nplanes]
    srcs = [np.clip(p + rng.integers(-9, 10, p.shape), 0, 255)
            .astype(np.int32) for p in planes] if with_srcs else None
    skip8 = rng.random((mi_rows // 2, mi_cols // 2)) < 0.3
    yb = planes[0][:h, :w].reshape(h // 8, 8, w // 8, 8) \
        .transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    dirs, var = HC_ref.find_dir_blocks(yb, 0)
    dirs, var = dirs.astype(np.int32), var.astype(np.int32)
    want = DC.cdef_apply_fused(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(skip8),
        jnp.asarray(dirs), jnp.asarray(var), *st, mi_rows=mi_rows,
        mi_cols=mi_cols, nplanes=nplanes)
    outs, got_d, got_v, sums = TC.cdef_frame(
        tuple(torch.as_tensor(p) for p in planes), torch.as_tensor(skip8),
        *st, mi_rows=mi_rows, mi_cols=mi_cols, nplanes=nplanes,
        srcs=None if srcs is None else [torch.as_tensor(s) for s in srcs])
    np.testing.assert_array_equal(got_d.numpy(), dirs)
    np.testing.assert_array_equal(got_v.numpy(), var)
    assert len(outs) == nplanes
    for g, wnt in zip(outs, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    if srcs is None:
        assert sums is None
        return
    assert sums.dtype == torch.int64 and tuple(sums.shape) == (2, nplanes)
    for p in range(nplanes):
        sh, sw = (h, w) if p == 0 else (h // 2, w // 2)
        src = srcs[p][:sh, :sw].astype(np.int64)
        for k, pl in enumerate((planes[p], np.asarray(want[p]))):
            d = pl[:sh, :sw].astype(np.int64) - src
            assert int(sums[k, p]) == int((d * d).sum())
