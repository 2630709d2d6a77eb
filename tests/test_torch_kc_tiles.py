"""The tiling claim kernel KC rests on, held on the CPU with the plain
version: with tile origins half a cell before an edge
(``deblock_torch.kc_tile``), every pixel of a tile after
``deblock_plane_fused`` depends only on pixels of the same tile, so the
kernel's CTAs need no halo. For each geometry, plane and level, the tiles
are taken in four phases (tile row and column parity): the tiles of a phase
keep the plane's values, everything else is replaced with random values,
and the kept tiles must come out of the unchanged plain filter equal to the
whole-plane run. Also: the tiles partition the plane, and every edge's
reach lies in one tile. Tolerance: exact equality."""
import functools

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.ops import deblock_torch as DT
from torch_threads import one_torch_thread  # noqa: F401

# luma buffer (hb, wb) and cropped (h, w): the CASES frames of
# test_torch_deblock.py (buffers padded to 32), the 1080p plane, and a
# buffer that is no multiple of the tile or of 32
GEOMETRIES = [(64, 96, 64, 96), (128, 128, 128, 128), (160, 192, 144, 176),
              (1088, 1920, 1080, 1920), (208, 336, 198, 330)]
LEVELS = [0, 7, 14, 28, 63]


def _blocky(rng, shape):
    """Flat 8x8 blocks of random levels plus a little noise: the wide, the
    narrow and no filter all fire, depending on the level."""
    hb, wb = shape
    blocks = rng.integers(0, 256, (-(-hb // 8), -(-wb // 8)))
    base = np.kron(blocks, np.ones((8, 8), np.int64))[:hb, :wb]
    return np.clip(base + rng.integers(0, 3, shape), 0, 255).astype(np.int32)


@functools.cache
def _case(geo, luma):
    hb, wb, h, w = geo
    rng = np.random.default_rng(hb * 7 + wb + int(luma))
    split16 = rng.random((-(-hb // 16), -(-wb // 16))) < .5
    if luma:
        return _blocky(rng, (hb, wb)), split16, h, w, 16
    return (_blocky(rng, (hb // 2, wb // 2)), split16, (h + 1) // 2,
            (w + 1) // 2, 8)


def _filter(buf, split16, level, h, w, cell):
    return DT.deblock_plane_fused(torch.as_tensor(buf),
                                  torch.as_tensor(split16), level, level,
                                  cell=cell, w=w, h=h, luma=cell == 16).numpy()


@functools.cache
def _whole(geo, luma, level):
    buf, split16, h, w, cell = _case(geo, luma)
    return _filter(buf, split16, level, h, w, cell)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_each_tile_depends_only_on_itself(geo, luma, level):
    buf, split16, h, w, cell = _case(geo, luma)
    want = _whole(geo, luma, level)
    off, side = DT.kc_tile(cell)
    rng = np.random.default_rng(level + 100 * int(luma))
    for phase in ((0, 0), (0, 1), (1, 0), (1, 1)):
        kept = [t for t in DT.kc_tiles(cell, *buf.shape)
                if ((t[0] - off) // side % 2, (t[2] - off) // side % 2)
                == phase]
        noisy = _blocky(rng, buf.shape)
        for y0, y1, x0, x1 in kept:
            noisy[y0:y1, x0:x1] = buf[y0:y1, x0:x1]
        got = _filter(noisy, split16, level, h, w, cell)
        for y0, y1, x0, x1 in kept:
            np.testing.assert_array_equal(got[y0:y1, x0:x1],
                                          want[y0:y1, x0:x1],
                                          err_msg=f"tile {(y0, x0)}")


@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_tiles_partition_the_plane_and_hold_every_edge(geo, luma):
    buf, split16, h, w, cell = _case(geo, luma)
    hb, wb = buf.shape
    off, side = DT.kc_tile(cell)
    assert (off, side) == (-(cell // 2), DT.TILE_CELLS * cell)
    tiles = DT.kc_tiles(cell, hb, wb)
    cover = np.zeros((hb, wb), np.int32)
    for y0, y1, x0, x1 in tiles:
        assert 0 <= y0 < y1 <= hb and 0 <= x0 < x1 <= wb
        cover[y0:y1, x0:x1] += 1
    assert (cover == 1).all()
    # each filtered edge reads e - taps/2 .. e + taps/2 - 1 (luma 14 taps,
    # chroma 6): that reach lies inside one tile's rows and columns
    kv, kh, _, _ = DT._edge_geometry(cell, w, h, (hb, wb))
    half = 7 if luma else 3
    for k in range(1, kv + 1):
        assert len({x0 for _, _, x0, x1 in tiles
                    if x0 <= k * cell - half and k * cell + half <= x1}) == 1
    for k in range(1, kh + 1):
        assert len({y0 for y0, y1, _, _ in tiles
                    if y0 <= k * cell - half and k * cell + half <= y1}) == 1
