"""Kernel KM's decomposition of the 49-point subpel refine, held to its
plain version on the CPU (no card, no jax).

KM (``csrc/mvsearch.cu``) does not predict the 49 candidates one by one.
Per column phase dc it runs one x pass over window rows 0..R+7 of each
chunk of R output rows (R = h rounded up to a power of two, at most 16; a
last chunk of fewer rows reads its window rows clamped and scores only its
own; the raw window column 4 + c where dc = 0), and scores all seven
candidates of that column from it: the 2-D
ones (and the y-only ones at dc = 0) by an 8-tap vertical pass, the
x-only one (dr = 0) by ``round2(im - 2^(bd+3), 4)`` on the 2-D path's
intermediate, the copy from the raw column. It sums the SADs by column
and takes the first-index argmin over the dr-major flat index
``(dr + 3) * 7 + (dc + 3)``. ``km_model`` below is that order in plain
torch. It is held equal, with all 49 SADs, to the reference's candidate
loop (``predict_subpel_plain`` per lattice point, as
``subpel_refine49_plain`` runs it) at the power-of-two sizes 4..64 and at
sizes that are not (2-wide, ragged chunks), bit depths 8 and 10 and every
interp filter, on random, flat and near-flat blocks, blocks planted on a
candidate, and ties between candidates of different columns.
``km_layout`` mirrors the launcher's lane-task arithmetic, and is checked
at every w, h in 2..128: each (block, column phase, chunk) owns whole
shuffle segments, covers every column and row once, and reads only its
block's window. Tolerance: exact equality (integer outputs).
"""
import itertools

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from aom_av1_psy_tpu_torch.ops import convolve as C
from aom_av1_psy_tpu_torch.ops import mvsearch as MV

SIZES = (4, 8, 16, 32, 64)


def _round2(v, bits):
    return (v + (1 << (bits - 1))) >> bits


def _column_phase(j):
    """(fc, sc) of column phase j = dc + 3 (the same for row phases)."""
    c8 = 2 + 2 * j
    return c8 >> 3, (c8 & 7) << 1


def _pow2_up(v, cap):
    p = 2
    while p < v and p < cap:
        p <<= 1
    return p


def km_layout(w, h):
    """The launcher's lane-task layout (``subpel_refine49`` in
    ``csrc/mvsearch.cu``): rows a chunk R, lane columns gw, shuffle segment
    seg, chunks, lane-tasks a block, blocks a CTA nb, threads, and the
    dynamic shared memory in bytes."""
    R = _pow2_up(h, 16)
    gw = _pow2_up(w, 32) if w <= 32 else (w + 31) // 32 * 32
    chunks = -(-h // R)
    tasks = 7 * chunks * gw
    nb = 1 if tasks >= 256 else 256 // tasks
    threads = min(512, (nb * tasks + 31) // 32 * 32)
    smem = 4 * (256 + nb * (49 + (h + 9) * (w + 9) + h * w))
    return dict(R=R, gw=gw, seg=min(gw, 32), chunks=chunks, tasks=tasks,
                nb=nb, threads=threads, smem=smem)


def km_model(src, win, interp, bd):
    """KM's order in plain torch: returns the (B, 7, 7) int64 SADs indexed
    [column phase, row phase], as the kernel scores them."""
    B, h, w = src.shape
    R = km_layout(w, h)["R"]
    kx_tab, ky_tab = C.filter_kernels(interp, w), C.filter_kernels(interp, h)
    win = win[:, :h + 9, :w + 9].to(torch.int32)
    src = src.to(torch.int64)
    maxv = (1 << bd) - 1
    ob = bd + 11
    sub = (1 << (ob - 11)) + (1 << (ob - 12))
    sads = torch.zeros((B, 7, 7), dtype=torch.int64)
    for j in range(7):
        fc, sc = _column_phase(j)
        for r0 in range(0, h, R):
            nr = min(R, h - r0)        # rows past nr: clamped, unscored
            rows = win[:, [r0 + min(q, nr + 7) for q in range(R + 8)]]
            if sc:   # one x pass for the column: R + 8 rows
                acc = sum(int(kx_tab[sc][k]) * rows[:, :, fc + k:fc + k + w]
                          for k in range(8))
                v = _round2(acc + (1 << (bd + 6)), 3)
            else:    # dc = 0: the raw column
                v = rows[:, :, 4:4 + w]
            s = src[:, r0:r0 + nr]
            for i in range(7):
                fr, sr = _column_phase(i)
                if sr:
                    acc = sum(int(ky_tab[sr][k]) * v[:, fr + k:fr + k + R]
                              for k in range(8))
                    p = (_round2(acc + (1 << ob), 11) - sub if sc
                         else _round2(acc, 7)).clamp(0, maxv)
                elif sc:   # x only, from the 2-D intermediate
                    p = _round2(v[:, 4:4 + R] - (1 << (bd + 3)), 4) \
                        .clamp(0, maxv)
                else:      # the copy
                    p = v[:, 4:4 + R]
                sads[:, j, i] += (p[:, :nr].to(torch.int64) - s).abs() \
                    .sum((1, 2))
    return sads


def km_argmin(by_column):
    """The kernel's combine: the 49 sums at the dr-major index, the first
    index on ties. Returns (index (B,), SAD (B,))."""
    flat = by_column.transpose(1, 2).reshape(-1, 49)
    best = flat.argmin(1)
    return best, flat.gather(1, best[:, None])[:, 0]


def plain_sads(src, win, interp, bd):
    """All 49 SADs of the reference's candidate loop, dr-major (B, 49)."""
    B, h, w = src.shape
    src = src.to(torch.int64)
    out = []
    for dr, dc in MV._LATTICE49 // 2:
        r8, c8 = 8 + 2 * int(dr), 8 + 2 * int(dc)
        reg = win[:, r8 >> 3:(r8 >> 3) + h + 7, c8 >> 3:(c8 >> 3) + w + 7]
        p = C.predict_subpel_plain(reg, w, h, (c8 & 7) << 1, (r8 & 7) << 1,
                                   interp, interp, bd)
        out.append((p.to(torch.int64) - src).abs().sum((1, 2)))
    return torch.stack(out, 1)


def _cases(rng, w, h, interp, bd):
    """Random blocks; flat (every SAD tied); near-flat (values a and a + 1:
    small SADs, ties across columns); blocks planted on a candidate of
    each column."""
    maxv = (1 << bd) - 1
    win = rng.integers(0, maxv + 1, (14, h + 9, w + 9))
    src = rng.integers(0, maxv + 1, (14, h, w))
    win[6:8] = maxv // 3
    src[6:8] = maxv // 3
    a = int(rng.integers(0, maxv))
    win[8:10] = a + rng.integers(0, 2, (2, h + 9, w + 9))
    src[8:10] = a
    win[10:] = rng.choice([0, maxv], (4, h + 9, w + 9))   # clip at both ends
    for b, k in zip(range(10, 14), (3, 15, 29, 45)):
        dr, dc = MV._LATTICE49[k] // 2
        r8, c8 = 8 + 2 * int(dr), 8 + 2 * int(dc)
        reg = torch.as_tensor(win[b, r8 >> 3:(r8 >> 3) + h + 7,
                                  c8 >> 3:(c8 >> 3) + w + 7])
        src[b] = C.predict_subpel_plain(reg[None], w, h, (c8 & 7) << 1,
                                        (r8 & 7) << 1, interp, interp,
                                        bd)[0].numpy()
    return torch.as_tensor(src, dtype=torch.int32), \
        torch.as_tensor(win, dtype=torch.int32)


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(s, s) for s in SIZES]
                         + [(4, 16), (16, 4), (8, 64), (64, 8), (32, 16)]
                         + [(2, 2), (2, 4), (4, 2), (6, 10), (12, 20),
                            (20, 12), (3, 37), (36, 5)])
def test_model_matches_plain(w, h, bd, interp):
    rng = np.random.default_rng(w * 131 + h * 7 + bd + interp)
    src, win = _cases(rng, w, h, interp, bd)
    by_column = km_model(src, win, interp, bd)
    want = plain_sads(src, win, interp, bd)
    assert torch.equal(by_column.transpose(1, 2).reshape(-1, 49), want)
    best, sad = km_argmin(by_column)
    ref = MV.subpel_refine49_plain(src, win, interp, bd)
    assert torch.equal(best, ref[0]) and torch.equal(sad, ref[1])
    assert (ref[0][6:8] == 0).all()                     # flat: every tie
    assert (ref[1][10:] == 0).all()                     # planted


@pytest.mark.parametrize("w", range(2, 129))
def test_layout_covers_each_block_once(w):
    """At every h in 2..128 for this w: a CTA's lane-tasks fall into
    shuffle segments of seg lanes (a power of two dividing the warp) that
    never mix two (block, column phase, chunk) triples; each triple covers
    columns 0..w-1 once (lanes past w add zero) and the chunks rows 0..h-1
    once; a segment's first lane (the one that adds its sums) is a column
    below w; the clamped rows stay inside the block's h + 9 window rows;
    a CTA has at most 512 threads and 227 KB of shared memory."""
    for h in range(2, 129):
        L = km_layout(w, h)
        R, gw, seg, chunks, tasks = (L[k] for k in
                                     ("R", "gw", "seg", "chunks", "tasks"))
        assert seg & (seg - 1) == 0 and 32 % seg == 0 and gw % seg == 0
        assert tasks % seg == 0 and L["threads"] <= 512
        assert L["smem"] <= 227 * 1024
        t = np.arange(L["nb"] * tasks)
        blk, u = t // tasks, t % tasks
        c, q = u % gw, u // gw
        key = (blk * 7 + q // chunks) * chunks + q % chunks
        segs = key.reshape(-1, seg)
        assert (segs == segs[:, :1]).all()
        assert (c.reshape(-1, seg)[:, 0] < w).all()
        cols = np.zeros((L["nb"], 7, chunks, w), int)
        np.add.at(cols, (blk[c < w], (q // chunks)[c < w],
                         (q % chunks)[c < w], c[c < w]), 1)
        assert (cols == 1).all()
        r0 = np.arange(chunks) * R
        nr = np.minimum(R, h - r0)
        assert (nr > 0).all() and nr.sum() == h
        assert (r0 + np.minimum(R + 7, nr + 7) <= h + 8).all()


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16)])
def test_argmin_ties_across_columns(w, h):
    """Near-flat windows (values a, a + 1) give SAD ties between candidates
    of different columns and rows; the first dr-major index wins, not the
    first in the order the kernel scores (column-major). The data must
    hold blocks where the two orders disagree."""
    rng = np.random.default_rng(w + 1000)
    B = 256
    win = 100 + rng.integers(0, 2, (B, h + 9, w + 9))
    src = 100 + (rng.random((B, h, w)) < 0.5)
    src, win = (torch.as_tensor(x, dtype=torch.int32) for x in (src, win))
    by_column = km_model(src, win, 0, 8)
    best, sad = km_argmin(by_column)
    ref = MV.subpel_refine49_plain(src, win)
    assert torch.equal(best, ref[0]) and torch.equal(sad, ref[1])
    column_first = by_column.reshape(B, 49).argmin(1)     # j-major order
    j, i = column_first // 7, column_first % 7
    differ = int((i * 7 + j != best).sum())
    assert differ > 0


def test_argmin_on_planted_sad_tables():
    """The combine alone: a tie between (dr, dc) = (-1, 2) and (1, -2) goes
    to (-1, 2) (dr-major first), though the kernel scores column dc = -2
    first; ties within a row go to the smaller dc; all 49 tied to 0."""
    t = torch.full((3, 7, 7), 50, dtype=torch.int64)   # [column, row]
    t[0, 2 + 3, -1 + 3] = t[0, -2 + 3, 1 + 3] = 7
    t[1, 1 + 3, 0 + 3] = t[1, 3 + 3, 0 + 3] = 4
    t[2] = 9
    best, sad = km_argmin(t)
    assert best.tolist() == [(-1 + 3) * 7 + 2 + 3, 3 * 7 + 1 + 3, 0]
    assert sad.tolist() == [7, 4, 9]


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_x_only_identity_over_the_reachable_range(bd):
    """round2(acc + 2^(bd+6), 3) - 2^(bd+3) == round2(acc, 3) for every
    acc an 8-tap (or 4-tap) x pass can reach on bd-bit samples with any of
    the four filters, so the x-only candidate is
    clip(round2(im - 2^(bd+3), 4)) of the 2-D intermediate im."""
    maxv = (1 << bd) - 1
    lo = hi = 0
    for interp, dim in itertools.product(range(4), (4, 8)):
        taps = C.filter_kernels(interp, dim).astype(np.int64)
        lo = min(lo, int((np.minimum(taps, 0).sum(1) * maxv).min()))
        hi = max(hi, int((np.maximum(taps, 0).sum(1) * maxv).max()))
    acc = torch.arange(lo, hi + 1, dtype=torch.int32)
    im = _round2(acc + (1 << (bd + 6)), 3)
    assert torch.equal(im - (1 << (bd + 3)), _round2(acc, 3))
    assert torch.equal(_round2(im - (1 << (bd + 3)), 4).clamp(0, maxv),
                       _round2(_round2(acc, 3), 4).clamp(0, maxv))
    assert lo < 0 and hi >= 128 * maxv
