"""Kernel KR's generated 1-D programs and its schedule, on the CPU.

``csrc/kr_programs.cuh`` is generated by ``tools/gen_kr_programs.py``
from the normative stage data. Here:
- the committed header equals the generator's output;
- the generator's operation lists, run in numpy with int32 wraparound
  (``run_ops``), equal the JAX package's ``_run_stages`` for all 14 stage
  programs at every cos bit the tables use (forward 10-13, inverse 12),
  without the stage clamp and with it at each bit depth's range;
- a numpy model of ``csrc/txfm2d.cu``'s schedule, built from the same
  plan (``plan``: the CTA's blocks and threads, the two shared-memory
  tiles and their strides) and the same operation lists, equals the JAX
  package's ``fwd_txfm2d`` / ``inv_txfm2d_add`` for all 193 (tx size, tx
  type) pairs, forward and inverse at bd 8, 10 and 12, on batches that
  leave the last CTA part-filled. The model stages blocks into flat
  shared-memory arrays at the kernel's addresses (a word read before it
  is written fails the test), runs both passes with the kernel's flips,
  shifts, rescale, zeroing and clamps, and adds and clips as it does;
- the plan: every thread has whole vectors in both passes, the tiles fit
  the static shared memory, and the scalar column and row accesses are
  free of bank conflicts (the int4 row accesses at most 2-way);
- the WHT pair's kernel order equals the reference.
Tolerance: exact equality (integer outputs)."""
import importlib.util
import os

import numpy as np
import pytest

from aom_av1_psy_tpu.ops import txfm as JTX
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import txfm as TTX
from test_txfm import ALL_PAIRS
from torch_threads import one_torch_thread  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "gen_kr_programs", os.path.join(os.path.dirname(__file__), os.pardir,
                                    "tools", "gen_kr_programs.py"))
GEN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GEN)

FWD_PROGRAMS = [f for f in GEN.PROGRAMS if f.startswith("av1_f")]
INV_PROGRAMS = [f for f in GEN.PROGRAMS if f.startswith("av1_i")]
UNWRITTEN = 1 << 40          # a shared-memory word no store has reached


def test_committed_header_is_the_generators():
    with open(GEN.HEADER) as f:
        assert f.read() == GEN.render(), \
            "csrc/kr_programs.cuh is stale: python3 tools/gen_kr_programs.py"


def _vectors(rng, n, m=64):
    """Noise, full-range values, values that wrap and that saturate every
    stage clamp."""
    x = rng.integers(-300, 301, (m, n))
    x[: m // 4] = rng.integers(-2**15, 2**15, (m // 4, n))
    x[m // 4: m // 2] = rng.integers(-2**19, 2**19, (m // 4, n))
    x[m // 2] = rng.integers(-2**31, 2**31, n)
    return x.astype(np.int32)


@pytest.mark.parametrize("clamp_bit", [None, 16, 18, 20])
@pytest.mark.parametrize("func,cos_bit",
                         [(f, cb) for f in FWD_PROGRAMS for cb in GEN.COS_BITS]
                         + [(f, 12) for f in INV_PROGRAMS])
def test_op_lists_equal_reference_run_stages(func, cos_bit, clamp_bit):
    n = len(GEN.op_lists(func)[0])
    x = _vectors(np.random.default_rng([n, cos_bit, clamp_bit or 0]), n)
    with np.errstate(over="ignore"):
        want = JTX._run_stages(x, func, cos_bit, clamp_bit)
    np.testing.assert_array_equal(GEN.run_ops(x, func, cos_bit, clamp_bit),
                                  want)


def test_op_lists_cover_the_stage_data():
    """Every entry of the 14 programs is one operation, and the header has
    one function per program."""
    text = GEN.render()
    for func in GEN.PROGRAMS:
        ops = GEN.op_lists(func)
        assert [len(s) for s in ops] == [len(s) for s in
                                         GEN._stage_data()[func]]
        assert f"void kr_{func[4:]}(int (&x)[{len(ops[0])}]" in text


# ----------------------------------------------------------------------
# the kernel's schedule in numpy
# ----------------------------------------------------------------------
def _w32(v):
    return (v + 2**31) % 2**32 - 2**31


def _rs(v, bit):
    return _w32(v + (1 << (bit - 1))) >> bit


def _rsa(v, bit):
    """av1_round_shift_array as txfm.cuh's round_shift_arr."""
    if bit > 0:
        return _rs(v, bit)
    return _w32(v << -bit) if bit < 0 else v


def _clamp(v, bits):
    return np.clip(v, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def _adst4(x, cb, inverse):
    """txfm.cuh's adst4_lane over (M, 4)."""
    s = [int(v) for v in tables.sinpi(cb)]
    x0, x1, x2, x3 = (x[:, i] for i in range(4))
    m = lambda a, b: _w32(a * b)    # noqa: E731
    if not inverse:
        t0 = _w32(m(s[1], x0) + m(s[2], x1))
        t1 = m(s[3], _w32(_w32(x0 + x1) - x3))
        t2 = _w32(m(s[4], x0) - m(s[1], x1))
        t3 = m(s[3], x2)
        t0 = _w32(t0 + m(s[4], x3))
        t2 = _w32(t2 + m(s[2], x3))
        o = [_w32(t0 + t3), t1, _w32(t2 - t3), _w32(_w32(t2 - t0) + t3)]
    else:
        t0 = _w32(m(s[1], x0) + m(s[4], x2))
        t1 = _w32(m(s[2], x0) - m(s[1], x2))
        t3 = m(s[3], x1)
        t2 = m(s[3], _w32(_w32(x0 - x2) + x3))
        t0 = _w32(t0 + m(s[2], x3))
        t1 = _w32(t1 - m(s[4], x3))
        o = [_w32(t0 + t3), _w32(t1 + t3), t2, _w32(_w32(t0 + t1) - t3)]
    return np.stack([_rs(v, cb) for v in o], axis=1)


def _tx1d(x, n, kind, cb, inverse, stage_bits=None):
    """txfm2d.cu's tx1d over (M, n) vectors."""
    assert (x != UNWRITTEN).all(), "read a shared word before any store"
    if kind == TTX.KR_IDTX:
        if n in (4, 16):
            return _rs(_w32(x * (5793 if n == 4 else 2 * 5793)), 12)
        return _w32(x * (2 if n == 8 else 4))
    if kind == TTX.KR_ADST and n == 4:
        return _adst4(x, cb, inverse)
    prog = (f"av1_{'i' if inverse else 'f'}"
            f"{'dct' if kind == TTX.KR_DCT else 'adst'}{n}")
    return GEN.run_ops(x, prog, cb, stage_bits)


def _ctas(b, g):
    """(first block, live blocks) of each CTA of a launch over b blocks."""
    return [(b0, min(g, b - b0)) for b0 in range(0, b, g)]


def _model_fwd_4x4(res, vk, hk, ud, lr):
    p = GEN.plan(0, False)
    m = res.astype(np.int64)[:, ::-1] if ud else res.astype(np.int64)
    cols = m.transpose(0, 2, 1).reshape(-1, 4)
    cols = _rsa(_tx1d(_rsa(cols, -p["SH0"]), 4, vk, p["CB1"], False),
                -p["SH1"])
    rows = cols.reshape(-1, 4, 4).transpose(0, 2, 1)
    rows = (rows[:, :, ::-1] if lr else rows).reshape(-1, 4)
    rows = _rsa(_tx1d(rows, 4, hk, p["CB2"], False), -p["SH2"])
    return rows.reshape(-1, 4, 4).transpose(0, 2, 1)


def _model_inv_4x4(coeff, pred, vk, hk, ud, lr, bd, sb):
    p = GEN.plan(0, True)
    rows = coeff.astype(np.int64).transpose(0, 2, 1).reshape(-1, 4)
    rows = _rsa(_tx1d(_clamp(rows, bd + 8), 4, hk, p["CB1"], True, sb),
                -p["SH0"])
    d = rows.reshape(-1, 4, 4)
    d = d[:, :, ::-1] if lr else d
    cols = _clamp(d.transpose(0, 2, 1).reshape(-1, 4), max(bd + 6, 16))
    cols = _tx1d(cols, 4, vk, p["CB2"], True, sb)
    cols = cols[:, ::-1] if ud else cols
    d = _rsa(cols, -p["SH1"]).reshape(-1, 4, 4).transpose(0, 2, 1)
    return np.clip(_w32(pred + d), 0, (1 << bd) - 1)


def model_fwd(res, ts, tt):
    """csrc/txfm2d.cu's forward launch over res (B, H, W), CTA by CTA."""
    _, vk, hk, ud, lr = TTX.kr_program(ts, tt, False)
    if ts == 0:
        return _model_fwd_4x4(res, vk, hk, ud, lr)
    p = GEN.plan(ts, False)
    w, h, g = p["W"], p["H"], p["G"]
    ba, ra, bb, rb = p["BA"], p["RA"], p["BB"], p["RB"]
    q_ = w * h // 4
    b = res.shape[0]
    src = res.astype(np.int64).reshape(b, -1)
    out = np.full((b, w * h), UNWRITTEN, np.int64)
    for b0, nb in _ctas(b, g):
        sm = np.full(g * (ba + bb), UNWRITTEN, np.int64)
        tb = g * ba
        k = np.arange(nb * q_)
        gg, r, q = k // q_, k % q_ // (w // 4), k % (w // 4)
        rr = h - 1 - r if ud else r
        for j in range(4):
            sm[gg * ba + rr * ra + 4 * q + j] = src[b0 + gg, 4 * (k % q_) + j]
        # column pass
        i = np.arange(nb * w)
        at = (i // w * ba + i % w)[:, None] + np.arange(h)[None] * ra
        x = _rsa(_tx1d(_rsa(sm[at], -p["SH0"]), h, vk, p["CB1"], False),
                 -p["SH1"])
        sm[at] = x
        # row pass
        i = np.arange(nb * h)
        gg, r = i // h, i % h
        at = (gg * ba + r * ra)[:, None] + np.arange(w)[None]
        x = sm[at][:, ::-1] if lr else sm[at]
        x = _rsa(_tx1d(x, w, hk, p["CB2"], False), -p["SH2"])
        if p["RECT"]:
            x = _rs(_w32(x * 5793), 12)
        sm[tb + (gg * bb + r)[:, None] + np.arange(w)[None] * rb] = x
        # store
        k = np.arange(nb * q_)
        gg, c, q = k // q_, k % q_ // (h // 4), k % (h // 4)
        for j in range(4):
            out[b0 + gg, 4 * (k % q_) + j] = sm[tb + gg * bb + c * rb
                                                + 4 * q + j]
    assert (out != UNWRITTEN).all()
    return out.reshape(b, w, h)


def model_inv(coeff, pred, ts, tt, bd):
    """csrc/txfm2d.cu's inverse launch over coeff (B, W, H) and pred (B, H,
    W), CTA by CTA."""
    _, vk, hk, ud, lr, bd_, sb = TTX.kr_program(ts, tt, True, bd)
    if ts == 0:
        return _model_inv_4x4(coeff, pred, vk, hk, ud, lr, bd, sb)
    p = GEN.plan(ts, True)
    w, h, hr, cw, g = p["W"], p["H"], p["HR"], p["CW"], p["G"]
    ba, ra, bb, rb = p["BA"], p["RA"], p["BB"], p["RB"]
    q_, qb = w * h // 4, cw * hr // 4
    b = coeff.shape[0]
    src = coeff.astype(np.int64).reshape(b, -1)
    prd = pred.astype(np.int64).reshape(b, -1)
    out = np.full((b, w * h), UNWRITTEN, np.int64)
    for b0, nb in _ctas(b, g):
        sm = np.full(g * (ba + bb), UNWRITTEN, np.int64)
        tb = g * ba
        k = np.arange(nb * qb)
        gg, c, q = k // qb, k % qb // (hr // 4), k % (hr // 4)
        for j in range(4):
            sm[tb + gg * bb + c * rb + 4 * q + j] = \
                src[b0 + gg, 4 * (c * (h // 4) + q) + j]
        # row pass: HR rows, columns c >= CW are 0
        i = np.arange(nb * hr)
        gg, r = i // hr, i % hr
        x = np.zeros((len(i), w), np.int64)
        x[:, :cw] = sm[tb + (gg * bb + r)[:, None]
                       + np.arange(cw)[None] * rb]
        if p["RECT"]:
            x = _rs(_w32(x * 2896), 12)
        x = _tx1d(_clamp(x, bd + 8), w, hk, p["CB1"], True, sb)
        x = _rsa(x, -p["SH0"])
        sm[(gg * ba + r * ra)[:, None] + np.arange(w)[None]] = \
            x[:, ::-1] if lr else x
        # column pass: rows r >= HR are 0
        i = np.arange(nb * w)
        at = (i // w * ba + i % w)[:, None] + np.arange(h)[None] * ra
        x = np.zeros((len(i), h), np.int64)
        x[:, :hr] = _clamp(sm[at[:, :hr]], max(bd + 6, 16))
        sm[at] = _rsa(_tx1d(x, h, vk, p["CB2"], True, sb), -p["SH1"])
        # recon
        k = np.arange(nb * q_)
        gg, r, q = k // q_, k % q_ // (w // 4), k % (w // 4)
        rr = h - 1 - r if ud else r
        for j in range(4):
            d = sm[gg * ba + rr * ra + 4 * q + j]
            assert (d != UNWRITTEN).all()
            at = 4 * (k % q_) + j
            out[b0 + gg, at] = np.clip(_w32(prd[b0 + gg, at] + d), 0,
                                       (1 << bd) - 1)
    return out.reshape(b, h, w)


def _residuals(rng, b, h, w):
    res = rng.integers(-40, 41, (b, h, w))
    res[: b // 3] = rng.integers(-255, 256, (b // 3, h, w))
    res[b // 3] = 255
    res[b // 3 + 1] = -255
    res[b // 3 + 2] = rng.integers(-2**20, 2**20, (h, w))
    return res.astype(np.int32)


def _coeffs(rng, b, w, h, bd):
    lim = 1 << (bd + 7)
    coeff = rng.integers(-3000, 3001, (b, w, h))
    coeff[0] = lim - 1
    coeff[1] = -lim
    coeff[2] = rng.integers(-2**31, 2**31, (w, h))
    coeff[3:6] = rng.integers(-lim, lim, (3, w, h))
    pred = rng.integers(0, 1 << bd, (b, h, w))
    return coeff.astype(np.int32), pred.astype(np.int32)


@pytest.mark.parametrize("ts,tt", ALL_PAIRS)
def test_kernel_schedule_equals_reference(ts, tt):
    """The model, forward and inverse at bd 8 / 10 / 12, on 2 G + 3
    blocks (the last CTA part-filled), against the JAX package."""
    w, h = TTX._pair(ts, tt)[:2]
    rng = np.random.default_rng([7, ts, tt])
    b = 2 * GEN.plan(ts, False)["G"] + 3 if ts else 7
    res = _residuals(rng, b, h, w)
    with np.errstate(over="ignore"):
        want = JTX.fwd_txfm2d(res, ts, tt)
    np.testing.assert_array_equal(model_fwd(res, ts, tt), want)
    for bd in (8, 10, 12):
        b = 2 * GEN.plan(ts, True)["G"] + 3 if ts else 7
        coeff, pred = _coeffs(rng, b, w, h, bd)
        with np.errstate(over="ignore"):
            want = JTX.inv_txfm2d_add(coeff, pred, ts, tt, bd=bd)
        np.testing.assert_array_equal(model_inv(coeff, pred, ts, tt, bd),
                                      want)


def _banks(addrs):
    """The most lanes of one access that share a bank."""
    banks = np.asarray(addrs) % 32
    return max(np.bincount(banks).max(), 1)


def _quad_banks(addrs):
    """The most lanes of one 8-lane phase of an int4 access that share a
    bank quad."""
    worst = 1
    for ph in range(0, len(addrs), 8):
        quads = np.asarray(addrs[ph: ph + 8]) // 4 % 8
        worst = max(worst, np.bincount(quads).max())
    return worst


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("ts", range(1, 19))
def test_plan_busy_threads_smem_and_banks(ts, inverse):
    p = GEN.plan(ts, inverse)
    w, hr, g, t = p["W"], p["HR"], p["G"], p["T"]
    ba, ra, bb, rb = p["BA"], p["RA"], p["BB"], p["RB"]
    # whole vectors for every thread in both passes (the 64x64 inverse's
    # 32 coded rows a block: half its threads), power-of-two CTAs
    assert (g * w) % t == 0 and t % 32 == 0
    assert (g * hr) % t == 0 or (inverse and ts == 4 and 2 * g * hr == t)
    assert g * (ba + bb) * 4 <= GEN.SMEM_LIMIT
    assert ra % 4 == 0 and ba % 4 == 0 and rb % 4 == 0 and bb % 4 == 0
    assert ba >= p["H"] * ra and bb >= p["CW"] * rb
    # column pass: lanes (g, c) read / write tile A at row r
    for base in range(0, g * w, 32):
        i = np.arange(base, min(base + 32, g * w))
        for r in range(p["H"]):
            assert _banks(i // w * ba + r * ra + i % w) == 1
    # row pass: lanes (g, r) on tile B's column c (forward stores, inverse
    # loads) and on tile A's rows as int4
    for base in range(0, g * hr, 32):
        i = np.arange(base, min(base + 32, g * hr))
        for c in range(p["CW"]):
            assert _banks(i // hr * bb + c * rb + i % hr) == 1
        for q in range(w // 4):
            assert _quad_banks(i // hr * ba + i % hr * ra + 4 * q) <= 2


# ----------------------------------------------------------------------
# the WHT pair in the kernel's order
# ----------------------------------------------------------------------
def _model_fwht(res):
    x = res.astype(np.int64).reshape(-1, 16)
    inter = np.zeros_like(x)
    y = np.zeros_like(x)

    def bf(x0, x1, x2, x3):
        a1, d1 = _w32(x0 + x1), _w32(x3 - x2)
        e1 = _w32(a1 - d1) >> 1
        b1, c1 = _w32(e1 - x1), _w32(e1 - x2)
        return _w32(a1 - c1), c1, _w32(d1 + b1), b1
    for c in range(4):
        for k, v in enumerate(bf(*(x[:, 4 * j + c] for j in range(4)))):
            inter[:, c * 4 + k] = v
    for i in range(4):
        for j, v in enumerate(bf(*(inter[:, 4 * k + i] for k in range(4)))):
            y[:, j * 4 + i] = _w32(v * 4)
    return y.reshape(-1, 4, 4)


def _model_iwht(coeff, pred, bd):
    x = coeff.astype(np.int64).reshape(-1, 16) >> 2
    p = pred.astype(np.int64).reshape(-1, 16).copy()
    inter = np.zeros_like(x)

    def bf(x0, x1, x2, x3):
        a1, d1 = _w32(x0 + x1), _w32(x2 - x3)
        e1 = _w32(a1 - d1) >> 1
        b1, c1 = _w32(e1 - x3), _w32(e1 - x1)
        return _w32(a1 - b1), b1, c1, _w32(d1 + c1)
    for k in range(4):
        for j, v in enumerate(bf(*(x[:, 4 * i + k] for i in range(4)))):
            inter[:, j * 4 + k] = v
    for i in range(4):
        for j, v in enumerate(bf(*(inter[:, i * 4 + k] for k in range(4)))):
            p[:, j * 4 + i] = np.clip(_w32(p[:, j * 4 + i] + v), 0,
                                      (1 << bd) - 1)
    return p.reshape(-1, 4, 4)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_wht_kernel_order_equals_reference(bd):
    rng = np.random.default_rng([11, bd])
    res = rng.integers(-255, 256, (300, 4, 4)).astype(np.int32)
    res[0] = rng.integers(-2**29, 2**29, (4, 4))
    with np.errstate(over="ignore"):
        want = np.asarray(JTX.fwht4x4(res))
    np.testing.assert_array_equal(_model_fwht(res), want)
    coeff = rng.integers(-2**16, 2**16, (300, 4, 4)).astype(np.int32)
    coeff[0] = rng.integers(-2**31, 2**31, (4, 4))
    pred = rng.integers(0, 1 << bd, (300, 4, 4)).astype(np.int32)
    with np.errstate(over="ignore"):
        want = np.asarray(JTX.iwht4x4_add(coeff, pred, bd=bd))
    np.testing.assert_array_equal(_model_iwht(coeff, pred, bd), want)
