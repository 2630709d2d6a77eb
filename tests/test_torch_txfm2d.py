"""Port parity of the general AV1 2-D transforms (``ops/txfm.py`` of
``aom_av1_psy_tpu_torch``, the plain versions of kernel KR) against the
JAX package's ``ops/txfm.py``: every one of the 193 valid (tx_size,
tx_type) pairs forward, and inverse at bd 8, 10 and 12, against the
reference's functions on int32 numpy arrays (its numpy branch runs the
int32 operations of its jnp branch and wraps as jnp's int32 does) on mixed
residuals (+-255 blocks, and values past the transforms' range that wrap)
and extreme coefficient blocks; the libaom golden vectors
(``tests/golden/golden_txfm.npz``, read as ``tests/test_txfm.py`` reads
them); the jitted reference (``jax.jit`` of ``fwd_txfm2d`` /
``inv_txfm2d_add``, its device path) for one pair per tx size and
direction; the WHT pair; the ``ValueError`` of every invalid pair (also
from ``kr_program``, kernel KR's launch arguments; KR's schedule is held
against the reference by ``tests/test_torch_kr_programs.py``).
Tolerance: exact equality (integer outputs)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import txfm as JTX
from aom_av1_psy_tpu_torch.normative.enums import TX_HEIGHT, TX_WIDTH
from aom_av1_psy_tpu_torch.ops import txfm as TTX
from test_txfm import ALL_PAIRS, GOLDEN
from torch_threads import one_torch_thread  # noqa: F401

INVALID = [(ts, tt) for ts in range(19) for tt in range(16)
           if (ts, tt) not in ALL_PAIRS]


def _wh(ts):
    return int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])


def _residuals(rng, h, w, n=7):
    """Small noise, full-range +-255 blocks and a block far past the
    transforms' range (its products and sums wrap in int32)."""
    res = rng.integers(-40, 41, (n, h, w))
    res[:2] = rng.integers(-255, 256, (2, h, w))
    res[2] = 255
    res[3] = -255
    res[4] = rng.integers(-2**20, 2**20, (h, w))
    return res.astype(np.int32)


def _coeffs(rng, w, h, bd, n=7):
    """Coefficients (B, W, H) and predictions (B, H, W): noise, the
    saturating input clamp both ways and raw int32 values."""
    lim = 1 << (bd + 7)
    coeff = rng.integers(-3000, 3001, (n, w, h))
    coeff[0] = lim - 1
    coeff[1] = -lim
    coeff[2] = rng.integers(-lim, lim, (w, h))
    coeff[3] = rng.integers(-2**31, 2**31, (w, h))
    pred = rng.integers(0, 1 << bd, (n, h, w))
    return coeff.astype(np.int32), pred.astype(np.int32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _seed(*k):
    return np.random.default_rng(list(k))


def test_valid_pairs_are_the_references():
    assert [(ts, tt) for ts in range(19) for tt in range(16)
            if TTX.valid_pair(ts, tt)] == ALL_PAIRS
    assert len(ALL_PAIRS) == 193


@pytest.mark.parametrize("ts,tt", ALL_PAIRS)
def test_fwd_matches_reference_int32(ts, tt):
    w, h = _wh(ts)
    res = _residuals(_seed(1, ts, tt), h, w)
    want = JTX.fwd_txfm2d(res, ts, tt)
    assert want.dtype == np.int32
    got = TTX.fwd_txfm2d(_t(res), ts, tt)
    assert got.dtype == torch.int32 and got.shape == (7, w, h)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("ts,tt", ALL_PAIRS)
def test_inv_matches_reference_int32(ts, tt, bd):
    w, h = _wh(ts)
    coeff, pred = _coeffs(_seed(2, ts, tt, bd), w, h, bd)
    want = JTX.inv_txfm2d_add(coeff, pred, ts, tt, bd=bd)
    got = TTX.inv_txfm2d_add(_t(coeff), _t(pred), ts, tt, bd=bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("ts,tt", ALL_PAIRS)
def test_golden_vectors(golden, ts, tt):
    """libaom's av1_fwd_txfm2d / av1_inv_txfm2d_add outputs (bd 8)."""
    w, h = _wh(ts)
    inp = golden[f"fwd_in_ts{ts}_tt{tt}"].astype(np.int32)
    want = golden[f"fwd_out_ts{ts}_tt{tt}"]
    got = TTX.fwd_txfm2d(_t(inp), ts, tt).numpy()
    cw, ch = min(w, 32), min(h, 32)
    b = want.shape[0]
    # libaom packs a 64-point size's surviving <= 32x32 coefficients
    # compactly; the rest of its buffer is stale scratch
    np.testing.assert_array_equal(
        got[:, :cw, :ch].reshape(b, cw * ch),
        want.reshape(b, w * h)[:, :cw * ch])
    coeff = golden[f"inv_in_ts{ts}_tt{tt}"].astype(np.int32)
    pred = golden[f"inv_pred_ts{ts}_tt{tt}"].astype(np.int32)
    got = TTX.inv_txfm2d_add(_t(coeff), _t(pred), ts, tt, bd=8)
    np.testing.assert_array_equal(
        got.numpy(), golden[f"inv_recon_ts{ts}_tt{tt}"].astype(np.int32))


def test_wht_golden_vectors(golden):
    got = TTX.fwht4x4(_t(golden["wht_in"].astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), golden["wht_out"])
    got = TTX.iwht4x4_add(_t(golden["iwht_in"].astype(np.int32)),
                          _t(golden["iwht_pred"].astype(np.int32)), bd=8)
    np.testing.assert_array_equal(got.numpy(),
                                  golden["iwht_recon"].astype(np.int32))


def _jit_pair(ts):
    """One valid tx type per size, the sizes walking through all 16."""
    types = [tt for s, tt in ALL_PAIRS if s == ts]
    return types[(5 * ts) % len(types)]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("ts", range(19))
def test_matches_jitted_reference(ts, inverse):
    w, h = _wh(ts)
    tt = _jit_pair(ts)
    if inverse:
        bd = (8, 10, 12)[ts % 3]
        coeff, pred = _coeffs(_seed(3, ts, bd), w, h, bd)
        ref = jax.jit(functools.partial(JTX.inv_txfm2d_add, tx_size=ts,
                                        tx_type=tt, bd=bd))
        want = np.asarray(ref(jnp.asarray(coeff), jnp.asarray(pred)))
        got = TTX.inv_txfm2d_add(_t(coeff), _t(pred), ts, tt, bd=bd)
    else:
        res = _residuals(_seed(4, ts), h, w)
        ref = jax.jit(functools.partial(JTX.fwd_txfm2d, tx_size=ts,
                                        tx_type=tt))
        want = np.asarray(ref(jnp.asarray(res)))
        got = TTX.fwd_txfm2d(_t(res), ts, tt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_wht_pair_matches_reference(bd):
    rng = np.random.default_rng(bd)
    res = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    res[0] = 255
    res[1] = rng.integers(-2**29, 2**29, (4, 4))
    want = np.asarray(JTX.fwht4x4(jnp.asarray(res)))
    np.testing.assert_array_equal(TTX.fwht4x4(_t(res)).numpy(), want)
    coeff = rng.integers(-2**16, 2**16, (64, 4, 4)).astype(np.int32)
    coeff[0] = rng.integers(-2**31, 2**31, (4, 4))
    pred = rng.integers(0, 1 << bd, (64, 4, 4)).astype(np.int32)
    want = np.asarray(JTX.iwht4x4_add(jnp.asarray(coeff), jnp.asarray(pred),
                                      bd=bd))
    got = TTX.iwht4x4_add(_t(coeff), _t(pred), bd=bd)
    np.testing.assert_array_equal(got.numpy(), want)
    # pred's dtype is the recon's, as in the reference
    assert TTX.iwht4x4_add(_t(coeff), _t(pred.astype(np.int16)),
                           bd=bd).dtype == torch.int16


@pytest.mark.parametrize("ts,tt", INVALID)
def test_invalid_pair_raises_value_error(ts, tt):
    w, h = _wh(ts)
    with pytest.raises(ValueError, match=f"tx_size {ts}, tx_type {tt}"):
        TTX.fwd_txfm2d(torch.zeros((1, h, w), dtype=torch.int32), ts, tt)
    with pytest.raises(ValueError, match=f"tx_size {ts}, tx_type {tt}"):
        TTX.inv_txfm2d_add(torch.zeros((1, w, h), dtype=torch.int32),
                           torch.zeros((1, h, w), dtype=torch.int32), ts, tt)
    with pytest.raises(ValueError, match=f"tx_size {ts}, tx_type {tt}"):
        TTX.kr_program(ts, tt, False)


def test_bad_shapes_and_bit_depths_raise():
    x = torch.zeros((2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="want \\(B, 8, 16\\)"):
        TTX.fwd_txfm2d(x, 8, 0)       # TX_16X8: (B, 8, 16) residuals
    with pytest.raises(ValueError, match="bd must be"):
        TTX.inv_txfm2d_add(x, x, 1, 0, bd=9)
    with pytest.raises(ValueError, match="integer"):
        TTX.fwht4x4(torch.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="tx_size 19"):
        TTX.fwd_txfm2d(x, 19, 0)
