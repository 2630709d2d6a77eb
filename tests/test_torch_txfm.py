"""Port parity: the torch transform stage interpreter and the sinpi ADST4,
quantize/dequantize, TQ+recon (4x4 to 32x32; with and without the skip
decision) and the skip-RD helpers of ``aom_av1_psy_tpu_torch`` against the
JAX reference on the same seeded inputs. Tolerance: exact equality (every
output is an integer, or a float32 computed in the reference's order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aom_av1_psy_tpu.ec.context import FrameContext
from aom_av1_psy_tpu.encoder import tpu_intra as JTI
from aom_av1_psy_tpu.normative import tables
from aom_av1_psy_tpu.ops import txfm as JTX
from aom_av1_psy_tpu_torch.encoder import tpu_intra as TTI
from aom_av1_psy_tpu_torch.ops import txfm as TTX
from aom_av1_psy_tpu_torch.ops import txq as TQ

TX = {4: 0, 8: 1, 16: 2, 32: 3}    # TX_4X4, TX_8X8, TX_16X16, TX_32X32
TYPES = [(8, t) for t in range(4)] + [(16, t) for t in range(4)] + [(32, 0)] \
    + [(4, t) for t in range(4)]


def _residuals(rng, n, bs):
    """Mixed residuals: small noise plus full-range (+-255) blocks, the
    int32 wraparound-sensitive extreme."""
    res = rng.integers(-40, 41, (n, bs, bs))
    res[: n // 3] = rng.integers(-255, 256, (n // 3, bs, bs))
    res[n // 3] = 255
    res[n // 3 + 1] = -255
    return res.astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("bs,tx_type", TYPES)
def test_fwd_txfm2d_matches_jax(bs, tx_type):
    rng = np.random.default_rng(bs * 10 + tx_type)
    res = _residuals(rng, 12, bs)
    want = np.asarray(JTX.fwd_txfm2d(jnp.asarray(res), TX[bs], tx_type))
    got = TTX.fwd_txfm2d(_t(res), TX[bs], tx_type).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bs,tx_type", TYPES)
def test_inv_txfm2d_add_matches_jax(bs, tx_type):
    rng = np.random.default_rng(100 + bs * 10 + tx_type)
    coeff = rng.integers(-3000, 3001, (12, bs, bs)).astype(np.int32)
    coeff[0] = 32767                     # saturating input clamp
    coeff[1] = -32768
    pred = rng.integers(0, 256, (12, bs, bs)).astype(np.int32)
    want = np.asarray(JTX.inv_txfm2d_add(jnp.asarray(coeff),
                                         jnp.asarray(pred), TX[bs], tx_type))
    got = TTX.inv_txfm2d_add(_t(coeff), _t(pred), TX[bs], tx_type).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [20, 100, 255])
def test_quantize_dequantize_match_jax(q):
    rng = np.random.default_rng(q)
    flat = rng.integers(-20000, 20001, (6, 256)).astype(np.int32)
    flat[:, 5:] //= 50
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    for shift in (0, 1, 2):
        lv = JTI._quantize(jnp.asarray(flat), dc_q, ac_q, shift)
        got = TTI._quantize(_t(flat), dc_q, ac_q, shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(lv))
        np.testing.assert_array_equal(
            TTI._dequantize(got, dc_q, ac_q, shift).numpy(),
            np.asarray(JTI._dequantize(lv, dc_q, ac_q, shift)))


@pytest.mark.parametrize("bs,q", [(8, 60), (16, 100), (32, 30), (32, 200),
                                  (4, 100)])
def test_tq_recon_matches_jax(bs, q):
    rng = np.random.default_rng(bs + q)
    src = rng.integers(0, 256, (10, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-30, 31, src.shape), 0, 255)
    pred[:3] = rng.integers(0, 256, (3, bs, bs))
    pred = pred.astype(np.int32)
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    scan = tables.scan_table(TX[bs], 0)
    want = JTI._tq_recon(jnp.asarray(src), jnp.asarray(pred), dc_q, ac_q,
                         TX[bs], jnp.asarray(scan))
    got = TTI._tq_recon(_t(src), _t(pred), dc_q, ac_q, TX[bs],
                        _t(scan.astype(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # KB's no-skip wrapper (the uniform grid's) returns the same three
    got = TQ.txq_recon(_t(src), _t(pred), dc_q, ac_q,
                       _t(scan.astype(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bs,q", [(8, 60), (16, 100), (8, 200), (4, 60),
                                  (4, 200)])
def test_tq_recon_uv_matches_jax(bs, q):
    rng = np.random.default_rng(7 * bs + q)
    n = 26
    src = rng.integers(0, 256, (n, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-50, 51, src.shape), 0,
                   255).astype(np.int32)
    uv_mode = np.resize(np.asarray(JTI.PLAN_MODES, np.int32), n)
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    scan = tables.scan_table(TX[bs], 0)
    want = JTI._tq_recon_uv(jnp.asarray(src), jnp.asarray(pred), dc_q, ac_q,
                            TX[bs], jnp.asarray(scan), jnp.asarray(uv_mode))
    got = TTI._tq_recon_uv(_t(src), _t(pred), dc_q, ac_q, TX[bs],
                           _t(scan.astype(np.int32)), _t(uv_mode))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    va, ha = TTI._uv_adst(_t(uv_mode))
    got = TQ.txq_recon(_t(src), _t(pred), dc_q, ac_q,
                       _t(scan.astype(np.int32)), va, ha)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adst4_wraps_like_jax_at_full_range():
    """The sinpi ADST4, forward and inverse, on int32 inputs far past the
    transform's range: every product and sum wraps as jnp's int32 does."""
    rng = np.random.default_rng(4)
    x = rng.integers(-2**31, 2**31, (64, 4)).astype(np.int32)
    x[:8] = rng.integers(-2**15, 2**15, (8, 4))
    for cb in (12, 13):
        np.testing.assert_array_equal(TTX.fadst4(_t(x), cb).numpy(),
                                      np.asarray(JTX._fadst4(jnp.asarray(x),
                                                             cb)))
        np.testing.assert_array_equal(TTX.iadst4(_t(x), cb).numpy(),
                                      np.asarray(JTX._iadst4(jnp.asarray(x),
                                                             cb)))


def _rate_inputs(rng, n, bs):
    levels = rng.integers(-3, 4, (n, bs * bs)) * (rng.random((n, bs * bs))
                                                 < 0.3)
    levels[0, :40] = rng.integers(-400, 401, 40)    # golomb tail (>= 15)
    levels[1] = 0                                   # skipped block
    levels[2, 0] = 1
    eob = np.where(levels != 0, np.arange(1, bs * bs + 1), 0).max(1)
    eob[3] = bs * bs                                # eob past the last nz
    return levels.astype(np.int32), eob.astype(np.int32)


@pytest.mark.parametrize("key,bs", [("y32", 32), ("y16", 16), ("uv16", 16),
                                    ("uv8", 8)])
def test_coeff_rate_est_matches_jax(key, bs):
    fc = FrameContext(100)
    lvl, eobt = TTI._rate_tables(fc)[key]
    jl, je = JTI._rate_tables(fc)[key]
    np.testing.assert_array_equal(lvl, np.asarray(jl))
    np.testing.assert_array_equal(eobt, np.asarray(je))
    # the exact half-unit summation relies on these two properties
    assert np.array_equal(lvl * 2, np.round(lvl * 2))
    rng = np.random.default_rng(bs)
    levels, eob = _rate_inputs(rng, 8, bs)
    per = lvl[np.clip(np.abs(levels), 0, 15)] * (levels != 0)
    assert per.sum(1).max() < 2 ** 23
    want = JTI._coeff_rate_est(jnp.asarray(levels), jnp.asarray(eob),
                               jnp.asarray(jl), jnp.asarray(je))
    got = TTI._coeff_rate_est(_t(levels), _t(eob), _t(lvl), _t(eobt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs,q", [(32, 100), (16, 60), (8, 200)])
def test_skip_rd_matches_jax(bs, q):
    rng = np.random.default_rng(3 * bs + q)
    n = 12
    fc = FrameContext(q)
    key = {32: "y32", 16: "y16", 8: "uv8"}[bs]
    lvl, eobt = TTI._rate_tables(fc)[key]
    src = rng.integers(0, 256, (n, bs, bs)).astype(np.int32)
    pred = np.clip(src + rng.integers(-12, 13, src.shape), 0,
                   255).astype(np.int32)
    dc_q, ac_q = tables.dc_quant(q), tables.ac_quant(q)
    scan = tables.scan_table(TX[bs], 0)
    lv, e, rec = TTI._tq_recon(_t(src), _t(pred), dc_q, ac_q, TX[bs],
                               _t(scan.astype(np.int32)))
    rdm = rng.uniform(2e3, 8e4, n).astype(np.float32)
    want = JTI._skip_rd(jnp.asarray(lv.numpy()), jnp.asarray(e.numpy()),
                        jnp.asarray(rec.numpy()), jnp.asarray(pred),
                        jnp.asarray(src), jnp.asarray(rdm), jnp.asarray(lvl),
                        jnp.asarray(eobt))
    got = TTI._skip_rd(lv, e, rec, _t(pred), _t(src), _t(rdm), _t(lvl),
                       _t(eobt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the fused KB plain path returns the same five outputs
    fused = TQ.txq_recon_skip(_t(src), _t(pred), dc_q, ac_q,
                              _t(scan.astype(np.int32)), _t(rdm), _t(lvl),
                              _t(eobt))
    for g, w in zip(fused, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_floor_log2_is_integer_bit_length():
    x = np.arange(1, 40000)
    got = TQ.floor_log2(_t(x)).numpy()
    np.testing.assert_array_equal(got, [int(v).bit_length() - 1 for v in x])



def test_golomb_rate_matches_jax_at_every_level():
    """One 32x32 block per |level| in 15..40000 with a single non-zero
    coefficient: the port's rate equals the jitted reference's, including
    |level| = 8206 and 32782, where the reference's float32 floor(log2)
    of the golomb tail lands one below the bit length."""
    import jax
    fc = FrameContext(100)
    lvl, eobt = TTI._rate_tables(fc)["y32"]
    ref = jax.jit(JTI._coeff_rate_est)
    n, chunk = 1024, 4000
    mags = np.arange(15, 40001)
    for i in range(0, len(mags), chunk):
        m = mags[i:i + chunk]
        pos = m % n                                # vary the position
        levels = np.zeros((chunk, n), np.int32)
        sign = np.where(m % 2 == 0, 1, -1)
        levels[np.arange(len(m)), pos] = sign * m
        eob = np.zeros(chunk, np.int32)
        eob[:len(m)] = pos + 1
        want = np.asarray(ref(jnp.asarray(levels), jnp.asarray(eob),
                              jnp.asarray(lvl), jnp.asarray(eobt)))
        got = TQ.coeff_rate_est(_t(levels), _t(eob), _t(lvl),
                                _t(eobt)).numpy()
        np.testing.assert_array_equal(got[:len(m)], want[:len(m)],
                                      err_msg=f"levels {m[0]}..{m[-1]}")
    fl = TQ.golomb_floor_log2(_t(np.array([8192, 8193, 32767, 32768])))
    assert fl.tolist() == [12, 13, 14, 14]
