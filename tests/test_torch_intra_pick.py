"""Kernel KA's pick (``ops/intra_pred.intra_pick``): its plain version
against the composition the wavefronts ran before it (edge gathers,
``intra_pred_sse_plain``, the mode rate, the candidate mask, the float32
RD, the first-index argmin, ``intra_pred_one_plain``), written out here
as the wavefronts had it; the register arithmetic of the directional
sample positions against the gather tables; the kernel's argument blocks
(``_PickArgs``, and KN's ``_KNArgs``) against the C structs. Tolerance:
exact equality.

The ``gpu``-marked tests hold the kernel against the plain version on a
CUDA device and skip without one::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_intra_pick.py
"""
import os
import re

import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.encoder import tpu_intra_dir as DIR
from aom_av1_psy_tpu_torch.normative.blocks import INTRA_MODE_CONTEXT
from aom_av1_psy_tpu_torch.ops import intra_pred as IP
from aom_av1_psy_tpu_torch.ops import metrics as M
from torch_threads import one_torch_thread  # noqa: F401

K61 = len(DIR.candidates())
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "aom_av1_psy_tpu_torch", "csrc")
IMC = torch.as_tensor(np.asarray(INTRA_MODE_CONTEXT, np.int64))
PLAN = torch.as_tensor(TTI.PLAN_MODES)
INF = float("inf")


# ----------------------------------------------------------------------
# the former composition, as the wavefronts ran it
# ----------------------------------------------------------------------
def _rd(sse, rate, rdmult):
    return sse.to(torch.float32) * 2048.0 + \
        rate.to(torch.float32) * (rdmult / 512.0)


def _edges(buf, tt, by, bx, bs):
    ar = torch.arange(bs)
    above = buf[tt[:, None], (by - 1)[:, None], bx[:, None] + ar]
    left = buf[tt[:, None], by[:, None] + ar, (bx - 1)[:, None]]
    return above, left, buf[tt, by - 1, bx - 1]


def _smooth(m):
    return (m >= 9) & (m <= 11)


def _both(x):
    return torch.cat([x, x])


def _choose(cost, allowed=None):
    if allowed is not None:
        cost = torch.where(allowed, cost, torch.full_like(cost, INF))
    return cost.argmin(0)


def _old_luma32(c, tt, rc, cc, src32):
    above, left, tl = _edges(c["buf"], tt, rc * 32 + 1, cc * 32 + 1, 32)
    have_a, have_l = rc > 0, cc > 0
    zero = torch.zeros_like(rc, dtype=torch.int32)
    mode16 = c["mode16"]
    am = torch.where(have_a, mode16[tt, 2 * rc - 1, 2 * cc], zero)
    lm = torch.where(have_l, mode16[tt, 2 * rc, (2 * cc - 1).clamp(min=0)],
                     zero)
    ef = (_smooth(am) & have_a) | (_smooth(lm) & have_l)
    ssep = IP.intra_pred_sse_plain(above, left, tl, have_a, have_l, src32,
                                   K61, ef=ef)
    allowed = DIR.allowed_mask(*(c[f"ok{k}_32"][tt, rc, cc]
                                 for k in (1, 2, 3)), 32)
    rate = c["kf61"][IMC[am.long()], IMC[lm.long()]] + c["angle61"][None, :]
    best = _choose(_rd(ssep, rate.T, c["rd32"][tt, rc, cc]), allowed)
    pred = IP.intra_pred_one_plain(above, left, tl, have_a, have_l, best,
                                   K61, ef=ef)
    return best, rate.gather(1, best[:, None])[:, 0], pred


def _old_quad(c, tt, rc, cc, qr, qc, loc, s16):
    a = loc[:, qr * 16, 1 + qc * 16:17 + qc * 16]
    lf = loc[:, 1 + qr * 16:17 + qr * 16, qc * 16]
    tq = loc[:, qr * 16, qc * 16]
    have_a, have_l = rc > 0, cc > 0
    ha, hl = have_a | (qr > 0), have_l | (qc > 0)
    i16, j16 = 2 * rc + qr, 2 * cc + qc
    zero = torch.zeros_like(rc, dtype=torch.int32)
    mode16, sub = c["mode16"], c["m16"]      # sub: the quads already chosen
    am = torch.where(have_a, mode16[tt, 2 * rc - 1, j16], zero) if qr == 0 \
        else sub[tt, i16 - 1, j16]
    lm = torch.where(have_l, mode16[tt, i16, (2 * cc - 1).clamp(min=0)],
                     zero) if qc == 0 else sub[tt, i16, j16 - 1]
    ef16 = (_smooth(am) & ha) | (_smooth(lm) & hl)
    aext, lext = loc[:, qr * 16, 17:33], loc[:, 17:33, qc * 16]
    trr, blr = c["trreal_16"][tt, i16, j16], c["blreal_16"][tt, i16, j16]
    sp = IP.intra_pred_sse_plain(a, lf, tq, ha, hl, s16, K61, trr, blr,
                                 aext, lext, ef16)
    allowed = DIR.allowed_mask(*(c[f"ok{k}_16"][tt, i16, j16]
                                 for k in (1, 2, 3)), 16)
    rate = c["kf61"][IMC[am.long()], IMC[lm.long()]] + c["angle61"][None, :]
    best = _choose(_rd(sp, rate.T, c["rd16"][tt, i16, j16]), allowed)
    pred = IP.intra_pred_one_plain(a, lf, tq, ha, hl, best, K61, trr, blr,
                                   aext, lext, ef16)
    return best, rate.gather(1, best[:, None])[:, 0], pred


def _old_chroma16(c, tt, rc, cc, sb):
    B = rc.shape[0]
    have_a, have_l = _both(rc > 0), _both(cc > 0)
    edges = [_edges(c["bufs"][p], tt, rc * 16 + 1, cc * 16 + 1, 16)
             for p in range(2)]
    a, lf, tl = (torch.cat([e[i] for e in edges]) for i in range(3))
    s2 = IP.intra_pred_sse_plain(a, lf, tl, have_a, have_l, sb, 7)
    rate = c["uv"][c["y_m32"][tt, rc, cc].long()]
    best = _choose(_rd(s2[:, :B] + s2[:, B:], rate.T, c["rd32"][tt, rc, cc]))
    pred = IP.intra_pred_one_plain(a, lf, tl, have_a, have_l, _both(best), 7)
    return best, rate.gather(1, best[:, None])[:, 0], pred


def _old_chroma8(c, tt, rc, cc, qr, qc, locs, sb8):
    B = rc.shape[0]
    ha, hl = _both(rc > 0) | (qr > 0), _both(cc > 0) | (qc > 0)
    a = locs[:, qr * 8, 1 + qc * 8:9 + qc * 8]
    lf = locs[:, 1 + qr * 8:9 + qr * 8, qc * 8]
    t8 = locs[:, qr * 8, qc * 8]
    s2 = IP.intra_pred_sse_plain(a, lf, t8, ha, hl, sb8, 7)
    i, j = 2 * rc + qr, 2 * cc + qc
    rate = c["uv"][c["y_m16"][tt, i, j].long()]
    best = _choose(_rd(s2[:, :B] + s2[:, B:], rate.T, c["rd16"][tt, i, j]))
    pred = IP.intra_pred_one_plain(a, lf, t8, ha, hl, _both(best), 7)
    return best, rate.gather(1, best[:, None])[:, 0], pred


def _old_uniform_luma(c, tt, rc, cc, sb, bs):
    above, left, tl = _edges(c["ubuf"], tt, rc * bs + 1, cc * bs + 1, bs)
    have_a, have_l = rc > 0, cc > 0
    sse = IP.intra_pred_sse_plain(above, left, tl, have_a, have_l, sb, 7)
    zero = torch.zeros_like(rc, dtype=torch.int32)
    grid = c["grid"][0]
    am = torch.where(have_a, grid[rc - 1, cc], zero)
    lm = torch.where(have_l, grid[rc, (cc - 1).clamp(min=0)], zero)
    rate = c["kf7"][IMC[PLAN[am.long()]], IMC[PLAN[lm.long()]]] + \
        c["angle7"][None, :]
    best = _choose(_rd(sse, rate.T, c["urd"][0][rc, cc]))
    pred = IP.intra_pred_one_plain(above, left, tl, have_a, have_l, best, 7)
    return best, rate.gather(1, best[:, None])[:, 0], pred


def _old_uniform_chroma(c, tt, rc, cc, sb, bs):
    B = rc.shape[0]
    have_a, have_l = _both(rc > 0), _both(cc > 0)
    edges = [_edges(c["ubufs"][p:p + 1], tt, rc * bs + 1, cc * bs + 1, bs)
             for p in range(2)]
    a, lf, tl = (torch.cat([e[i] for e in edges]) for i in range(3))
    s2 = IP.intra_pred_sse_plain(a, lf, tl, have_a, have_l, sb, 7)
    rate = c["uv"][PLAN[c["grid"][0][rc, cc].long()]]
    best = _choose(_rd(s2[:, :B] + s2[:, B:], rate.T, c["urd"][0][rc, cc]))
    pred = IP.intra_pred_one_plain(a, lf, tl, have_a, have_l, _both(best), 7)
    return best, rate.gather(1, best[:, None])[:, 0], pred


# ----------------------------------------------------------------------
# seeded inputs: a 3x4-cell grid of two tile slabs, diagonal 2
# ----------------------------------------------------------------------
R, C, T = 3, 4, 2


def _plane(blocks):
    """(T, R, C, b, b) blocks -> the (T, R*b, C*b) plane they tile."""
    t, r, c, b = blocks.shape[:4]
    return blocks.transpose(2, 3).reshape(t, r * b, c * b).contiguous()


def _case(seed, dev="cpu", bs_u=8):
    rng = np.random.default_rng(seed)
    kf61, angle61, uv = TTI._plan_cost_tables2(FrameContext(100))
    kf7, angle7, _ = TTI._plan_cost_tables(FrameContext(100))
    masks = [DIR.position_masks(8 * R, 8 * C - 4 * t, 8 * C - 4 * t, R, C)
             for t in range(T)]

    def plane(*shape):
        # smooth gradients with noise, so that directional modes win too
        y, x = np.meshgrid(np.arange(shape[-2]), np.arange(shape[-1]),
                           indexing="ij")
        g = rng.uniform(-3, 3, shape[:-2] + (1, 1))
        h = rng.uniform(-3, 3, shape[:-2] + (1, 1))
        v = 128 + g * y + h * x + rng.integers(-12, 13, shape)
        return np.clip(v, 0, 255).astype(np.int32)

    def f32(*shape):
        return rng.uniform(2e3, 6e4, shape).astype(np.float32)

    c = {"buf": plane(T, 32 * R + 34, 32 * C + 34),
         "bufs": plane(2, T, 16 * R + 18, 16 * C + 18),
         "mode16": rng.integers(0, 13, (T, 2 * R, 2 * C)).astype(np.int32),
         "m16": rng.integers(0, 13, (T, 2 * R, 2 * C)).astype(np.int32),
         "y_m32": rng.integers(0, 13, (T, R, C)).astype(np.int32),
         "y_m16": rng.integers(0, 13, (T, 2 * R, 2 * C)).astype(np.int32),
         "rd32": f32(T, R, C), "rd16": f32(T, 2 * R, 2 * C),
         "kf61": kf61, "angle61": angle61, "uv": uv, "kf7": kf7,
         "angle7": angle7,
         "ubuf": plane(1, bs_u * R + bs_u + 2, bs_u * C + bs_u + 2),
         "ubufs": plane(2, bs_u // 2 * R + bs_u // 2 + 2,
                        bs_u // 2 * C + bs_u // 2 + 2),
         "grid": rng.integers(0, 7, (1, R, C)).astype(np.int32),
         "urd": f32(1, R, C),
         "src32": plane(T, R, C, 32, 32), "src16": plane(2, T, R, C, 16, 16),
         "usrc": plane(2, R, C, bs_u, bs_u)}
    for k in masks[0]:
        c[k] = np.stack([m[k] for m in masks])
    out = {k: torch.as_tensor(np.asarray(v), device=dev)
           for k, v in c.items()}
    # the same sources as the pick reads them: whole planes
    h = bs_u // 2
    out["sy"] = _plane(out["src32"])
    out["suv"] = tuple(_plane(out["src16"][p]) for p in range(2))
    out["suy"] = _plane(out["usrc"][0][None])
    out["suuv"] = tuple(_plane(out["usrc"][p][None, ..., :h, :h])
                       for p in range(2))
    tiles, rows, cols, offs = TTI._diagonals(R, C, T)
    cells = tuple(torch.as_tensor(a[offs[2]:offs[3]], device=dev)
                  for a in (tiles, rows, cols))
    return out, cells


def _check(pick, pred, old, modes, K):
    best, rate, want_pred = old
    assert torch.equal(pick[0], best.to(torch.int32))
    assert torch.equal(pick[1], modes[best].to(torch.int32))
    tab = DIR.tables(16)
    delta = tab["DELTA"][best.numpy()] if K == K61 else np.zeros(len(best))
    assert np.array_equal(pick[2].numpy(), delta)
    assert torch.equal(pick[3], rate.to(torch.int32))
    assert torch.equal(pred, want_pred)


def _written(before, after, idx, want):
    exp = before.clone()
    exp[idx] = want.to(exp.dtype)
    assert torch.equal(after, exp)


MODES61 = torch.as_tensor(DIR.tables(16)["MODE"].astype(np.int64))


def test_luma32_pick_equals_old_composition():
    c, (tt, rc, cc) = _case(1)
    src32 = c["src32"][tt, rc, cc]
    m32o, d32o = torch.zeros((T, R, C), dtype=torch.int32), \
        torch.zeros((T, R, C), dtype=torch.int32)
    pick, pred = IP.intra_pick_plain(
        c["buf"], tt, rc, cc, (c["sy"],), 32, K61, c["rd32"],
        mode_cost=c["kf61"],
        angle_cost=c["angle61"], nbr=c["mode16"], nbr_scale=2,
        ok=(c["ok1_32"], c["ok2_32"], c["ok3_32"]), mode_out=m32o,
        delta_out=d32o)
    old = _old_luma32(c, tt, rc, cc, src32)
    _check(pick, pred, old, MODES61, K61)
    _written(torch.zeros_like(m32o), m32o, (tt, rc, cc), MODES61[old[0]])
    d = torch.as_tensor(DIR.tables(16)["DELTA"])[old[0]]
    _written(torch.zeros_like(d32o), d32o, (tt, rc, cc), d)
    assert (old[0] >= IP.N_PLAIN).any()      # a directional winner


@pytest.mark.parametrize("qr,qc", TTI._QUADS)
def test_luma16_quad_pick_equals_old_composition(qr, qc):
    c, (tt, rc, cc) = _case(2 + 2 * qr + qc)
    B = rc.shape[0]
    # each cell's local buffer: its 34x34 window with random quads inside
    loc = c["buf"].unfold(1, 34, 32).unfold(2, 34, 32)[tt, rc, cc]
    loc[:, 1:, 1:] = torch.as_tensor(np.random.default_rng(qr).integers(
        0, 256, (B, 33, 33)).astype(np.int32))
    s16 = c["src32"][tt, rc, cc][:, qr * 16:qr * 16 + 16,
                                 qc * 16:qc * 16 + 16]
    m16 = c["m16"].clone()
    d16 = torch.zeros_like(m16)
    pick, pred = IP.intra_pick_plain(
        loc, tt, rc, cc, (c["sy"],), 16, K61, c["rd16"], local=True, qr=qr,
        qc=qc,
        scale=2, mode_cost=c["kf61"], angle_cost=c["angle61"],
        nbr=c["mode16"], nbr_scale=2,
        ok=(c["ok1_16"], c["ok2_16"], c["ok3_16"]),
        trreal=c["trreal_16"], blreal=c["blreal_16"], mode_out=m16,
        delta_out=d16)
    old = _old_quad(c, tt, rc, cc, qr, qc, loc, s16)
    _check(pick, pred, old, MODES61, K61)
    idx = (tt, 2 * rc + qr, 2 * cc + qc)
    _written(c["m16"], m16, idx, MODES61[old[0]])


def test_quad_cases_reach_real_extensions_and_masks():
    c, (tt, rc, cc) = _case(2)
    i, j = 2 * rc, 2 * cc
    assert c["trreal_16"][tt, i, j].any() and c["blreal_16"][tt, i, j].any()
    assert not c["ok1_32"][tt, rc, cc].all()


def test_chroma16_pair_pick_equals_old_composition():
    c, (tt, rc, cc) = _case(7)
    sb = torch.cat([c["src16"][p][tt, rc, cc] for p in range(2)])
    planes = c["bufs"].reshape(2 * T, *c["bufs"].shape[2:])
    uvm = torch.full((T, R, C), -1, dtype=torch.int32)
    pick, pred = IP.intra_pick_plain(planes, tt, rc, cc, c["suv"], 16, 7,
                                     c["rd32"], uv_cost=c["uv"],
                                     nbr=c["y_m32"], mode_out=uvm)
    old = _old_chroma16(c, tt, rc, cc, sb)
    _check(pick, pred, old, PLAN, 7)
    _written(torch.full_like(uvm, -1), uvm, (tt, rc, cc), old[0])


@pytest.mark.parametrize("qr,qc", TTI._QUADS)
def test_chroma8_quad_pair_pick_equals_old_composition(qr, qc):
    c, (tt, rc, cc) = _case(11 + qr + 2 * qc)
    B = rc.shape[0]
    sb = torch.cat([c["src16"][p][tt, rc, cc] for p in range(2)])
    locs = c["bufs"].unfold(2, 18, 16).unfold(3, 18, 16)[:, tt, rc, cc] \
        .reshape(2 * B, 18, 18)
    sb8 = sb[:, qr * 8:qr * 8 + 8, qc * 8:qc * 8 + 8]
    uvm8 = torch.zeros((T, 2 * R, 2 * C), dtype=torch.int32)
    pick, pred = IP.intra_pick_plain(locs, tt, rc, cc, c["suv"], 8, 7,
                                     c["rd16"], local=True, qr=qr, qc=qc,
                                     scale=2, uv_cost=c["uv"],
                                     nbr=c["y_m16"],
                                     nbr_scale=2, mode_out=uvm8)
    old = _old_chroma8(c, tt, rc, cc, qr, qc, locs, sb8)
    _check(pick, pred, old, PLAN, 7)
    _written(torch.zeros_like(uvm8), uvm8,
             (tt, 2 * rc + qr, 2 * cc + qc), old[0])


@pytest.mark.parametrize("bs", [8, 16])
def test_uniform_picks_equal_old_composition(bs):
    c, (_, rc, cc) = _case(20 + bs, bs_u=bs)
    tt = torch.zeros_like(rc)
    # luma at bs: neighbours and the choice in the PLAN-index grid
    sb = c["usrc"][0][rc, cc]
    grid = c["grid"].clone()
    pick, pred = IP.intra_pick_plain(
        c["ubuf"], tt, rc, cc, (c["suy"],), bs, 7, c["urd"],
        mode_cost=c["kf7"],
        angle_cost=c["angle7"], nbr=grid, nbr_plan=True, mode_out=grid)
    old = _old_uniform_luma(c, tt, rc, cc, sb, bs)
    _check(pick, pred, old, PLAN, 7)
    _written(c["grid"], grid, (tt, rc, cc), old[0])
    # chroma at bs / 2 (the pair), priced by the luma grid's modes
    h = bs // 2
    sbc = torch.cat([c["usrc"][p][rc, cc][:, :h, :h] for p in range(2)])
    uvm = torch.zeros_like(grid)
    pick, pred = IP.intra_pick_plain(
        c["ubufs"], tt, rc, cc, c["suuv"], h, 7, c["urd"], uv_cost=c["uv"],
        nbr=c["grid"], nbr_plan=True, mode_out=uvm)
    old = _old_uniform_chroma(c, tt, rc, cc, sbc, h)
    _check(pick, pred, old, PLAN, 7)
    _written(torch.zeros_like(uvm), uvm, (tt, rc, cc), old[0])


def test_ties_go_to_the_first_index():
    c, (tt, rc, cc) = _case(30)
    flat = torch.full_like(c["buf"], 128)
    src32 = (torch.full((T, 32 * R, 32 * C), 128, dtype=torch.int32),)
    # every candidate predicts 128 from flat edges: all SSEs are 0, and
    # the rates decide; candidates 20 and 30 (Z1, Z2) tie lowest
    cls = DIR.tables(32)["CLS"]
    assert (cls[20], cls[30]) == (DIR.Z1, DIR.Z2)
    angle = torch.full((K61,), 50, dtype=torch.int32)
    angle[20] = angle[30] = 7
    kf = torch.zeros_like(c["kf61"])
    on = torch.ones_like(c["ok1_32"])
    kw = dict(mode_cost=kf, angle_cost=angle, nbr=c["mode16"], nbr_scale=2)
    pick, _ = IP.intra_pick_plain(flat, tt, rc, cc, src32, 32, K61,
                                  c["rd32"], ok=(on, on, on), **kw)
    assert (pick[0] == 20).all()
    # with Z1 masked off, the tie's second member wins
    pick, _ = IP.intra_pick_plain(flat, tt, rc, cc, src32, 32, K61,
                                  c["rd32"], ok=(~on, on, on), **kw)
    assert (pick[0] == 30).all()
    # all equal: the first candidate (DC)
    pick, pred = IP.intra_pick_plain(
        flat, tt, rc, cc, src32, 32, K61, c["rd32"], ok=(on, on, on),
        mode_cost=kf, angle_cost=torch.zeros_like(angle), nbr=c["mode16"],
        nbr_scale=2)
    assert (pick[0] == 0).all() and (pred == 128).all()
    # chroma: rates [5, 3, 3, 3, 4, 4, 3] -> V (index 1)
    uv = torch.tensor([[5, 3, 3, 3, 4, 4, 3]] * 13, dtype=torch.int32)
    sb = tuple(torch.full((T, 16 * R, 16 * C), 128, dtype=torch.int32)
               for _ in range(2))
    planes = torch.full((2 * T, 16 * R + 18, 16 * C + 18), 128,
                        dtype=torch.int32)
    pick, _ = IP.intra_pick_plain(planes, tt, rc, cc, sb, 16, 7, c["rd32"],
                                  uv_cost=uv, nbr=c["y_m32"])
    assert (pick[0] == 1).all() and (pick[3] == 3).all()


@pytest.mark.parametrize("bs", [16, 32])
def test_direction_arithmetic_equals_gather_tables(bs):
    ia, ib, sh = DIR.dir_positions(bs)
    tab = DIR.tables(bs)
    np.testing.assert_array_equal(ia, tab["IDXa"])
    np.testing.assert_array_equal(ib, tab["IDXb"])
    for t in (0, 1):
        np.testing.assert_array_equal(sh[t], tab["SH"])
    consts = DIR.dir_consts(bs)
    dirs = [cl for _, _, cl in DIR.candidates() if cl != DIR.PLAIN]
    np.testing.assert_array_equal(consts[:, 6], dirs)


def test_pick_table_layout():
    tab = IP.pick_table()
    t16 = DIR.tables(16)
    np.testing.assert_array_equal(tab[:61], t16["MODE"])
    np.testing.assert_array_equal(tab[61:122], t16["DELTA"])
    np.testing.assert_array_equal(tab[122:183], t16["CLS"])
    np.testing.assert_array_equal(tab[183:190], TTI.PLAN_MODES)
    np.testing.assert_array_equal(tab[190:203], INTRA_MODE_CONTEXT)
    from aom_av1_psy_tpu_torch.ops import intra as intra_ops
    np.testing.assert_array_equal(tab[203 + 28:203 + 60],
                                  intra_ops.smooth_weights(32))
    d32 = tab[263 + 54 * 8:].reshape(54, 8)
    np.testing.assert_array_equal(d32[:, :7], DIR.dir_consts(32))
    assert tuple(IP.PLAN_MODES) == TTI.PLAN_MODES


def _c_fields(source, struct):
    """Field names of ``struct`` in a csrc file, in order."""
    text = open(os.path.join(CSRC, source)).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.split(r"[\s*]+", part.strip())[-1]
                      for part in decl.split(",")]
    return names


@pytest.mark.parametrize("source,struct,ctype", [
    ("intra_pred.cu", "PickArgs", IP._PickArgs),
    ("metrics.cu", "KNArgs", M._KNArgs)])
def test_argument_blocks_match_the_c_structs(source, struct, ctype):
    assert _c_fields(source, struct) == [f for f, _ in ctype._fields_]


# ----------------------------------------------------------------------
# on the card: kernel == plain version
# ----------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2])
def test_pick_kernel_matches_plain(dev, seed):
    n0 = IP.KA.launches
    for where in ("cpu", dev):
        c, (tt, rc, cc) = _case(seed, where)
        outs = []
        m32o = torch.zeros((T, R, C), dtype=torch.int32, device=where)
        d32o = torch.zeros_like(m32o)
        m16o = c["m16"].clone()
        d16o = torch.zeros_like(m16o)
        outs += IP.intra_pick(
            c["buf"], tt, rc, cc, (c["sy"],), 32, K61, c["rd32"],
            mode_cost=c["kf61"], angle_cost=c["angle61"], nbr=c["mode16"],
            nbr_scale=2, ok=(c["ok1_32"], c["ok2_32"], c["ok3_32"]),
            mode_out=m32o, delta_out=d32o)
        loc = c["buf"].unfold(1, 34, 32).unfold(2, 34, 32)[tt, rc, cc]
        for qr, qc in TTI._QUADS:
            outs += IP.intra_pick(
                loc, tt, rc, cc, (c["sy"],), 16, K61, c["rd16"], local=True,
                qr=qr, qc=qc, scale=2,
                mode_cost=c["kf61"], angle_cost=c["angle61"],
                nbr=c["mode16"], nbr_scale=2,
                ok=(c["ok1_16"], c["ok2_16"], c["ok3_16"]),
                trreal=c["trreal_16"], blreal=c["blreal_16"],
                mode_out=m16o, delta_out=d16o)
        planes = c["bufs"].reshape(2 * T, *c["bufs"].shape[2:])
        uvm = torch.zeros((T, R, C), dtype=torch.int32, device=where)
        outs += IP.intra_pick(planes, tt, rc, cc, c["suv"], 16, 7,
                              c["rd32"], uv_cost=c["uv"], nbr=c["y_m32"],
                              mode_out=uvm)
        locs = c["bufs"].unfold(2, 18, 16).unfold(3, 18, 16)[
            :, tt, rc, cc].reshape(-1, 18, 18)
        uvm8 = torch.zeros((T, 2 * R, 2 * C), dtype=torch.int32,
                           device=where)
        for qr, qc in TTI._QUADS:
            outs += IP.intra_pick(
                locs, tt, rc, cc, c["suv"], 8, 7, c["rd16"],
                local=True, qr=qr, qc=qc, scale=2, uv_cost=c["uv"],
                nbr=c["y_m16"], nbr_scale=2, mode_out=uvm8)
        grid = c["grid"].clone()
        z = torch.zeros_like(rc)
        outs += IP.intra_pick(c["ubuf"], z, rc, cc, (c["suy"],), 8, 7,
                              c["urd"], mode_cost=c["kf7"],
                              angle_cost=c["angle7"], nbr=grid,
                              nbr_plan=True, mode_out=grid)
        outs += [m32o, d32o, m16o, d16o, uvm, uvm8, grid]
        if where == "cpu":
            want = outs
    _same(outs, want)
    assert IP.KA.launches == n0 + 11
