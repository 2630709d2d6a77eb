"""Kernel KR (``csrc/txfm2d.cu``, the general AV1 2-D transforms) of
``aom_av1_psy_tpu_torch`` against its plain PyTorch version on a CUDA
device and on the CPU: every one of the 193 valid (tx_size, tx_type)
pairs forward and inverse at bd 8, the inverse at bd 10 and 12 for every
tx size, and the WHT pair, on mixed residuals (+-255 blocks, values that
wrap in int32) and extreme coefficient blocks, at batch sizes that leave
the last CTA part-filled; each call one launch; an invalid pair raises
before any launch. Tolerance: exact equality (integer outputs).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kr_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.normative.enums import TX_HEIGHT, TX_WIDTH
from aom_av1_psy_tpu_torch.ops import txfm as T

pytestmark = pytest.mark.gpu

PAIRS = [(ts, tt) for ts in range(19) for tt in range(16)
         if T.valid_pair(ts, tt)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wh(ts):
    return int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])


def _residuals(rng, b, h, w):
    res = rng.integers(-40, 41, (b, h, w))
    res[: b // 3] = rng.integers(-255, 256, (b // 3, h, w))
    res[b // 3] = 255
    res[b // 3 + 1] = -255
    res[b // 3 + 2] = rng.integers(-2**20, 2**20, (h, w))
    return torch.as_tensor(res.astype(np.int32))


def _coeffs(rng, b, w, h, bd):
    lim = 1 << (bd + 7)
    coeff = rng.integers(-3000, 3001, (b, w, h))
    coeff[0] = lim - 1
    coeff[1] = -lim
    coeff[2] = rng.integers(-2**31, 2**31, (w, h))
    coeff[3:6] = rng.integers(-lim, lim, (3, w, h))
    pred = rng.integers(0, 1 << bd, (b, h, w))
    return (torch.as_tensor(coeff.astype(np.int32)),
            torch.as_tensor(pred.astype(np.int32)))


def _same(got, *wants):
    for want in wants:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("ts,tt", PAIRS)
def test_kr_fwd_and_inv_bd8_equal_plain(dev, ts, tt):
    w, h = _wh(ts)
    rng = np.random.default_rng([ts, tt])
    b = 2 * (128 // max(w, h)) + 3            # the last CTA part-filled
    res = _residuals(rng, b, h, w)
    n0 = T.KR.launches
    got = T.fwd_txfm2d(res.to(dev), ts, tt)
    assert T.KR.launches == n0 + 1
    _same(got, T.fwd_txfm2d_plain(res.to(dev), ts, tt),
          T.fwd_txfm2d(res, ts, tt))
    coeff, pred = _coeffs(rng, b, w, h, 8)
    got = T.inv_txfm2d_add(coeff.to(dev), pred.to(dev), ts, tt)
    assert T.KR.launches == n0 + 2
    _same(got, T.inv_txfm2d_add_plain(coeff.to(dev), pred.to(dev), ts, tt),
          T.inv_txfm2d_add(coeff, pred, ts, tt))


@pytest.mark.parametrize("bd", [10, 12])
@pytest.mark.parametrize("ts", range(19))
def test_kr_inv_high_bit_depth_equals_plain(dev, ts, bd):
    w, h = _wh(ts)
    types = [tt for s, tt in PAIRS if s == ts]
    for tt in types[ts % 3::3]:
        rng = np.random.default_rng([ts, tt, bd])
        coeff, pred = _coeffs(rng, 37, w, h, bd)
        got = T.inv_txfm2d_add(coeff.to(dev), pred.to(dev), ts, tt, bd=bd)
        _same(got, T.inv_txfm2d_add(coeff, pred, ts, tt, bd=bd))


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kr_wht_pair_equals_plain(dev, bd):
    rng = np.random.default_rng(bd)
    res = torch.as_tensor(rng.integers(-255, 256, (1000, 4, 4)),
                          dtype=torch.int32)
    res[0] = torch.as_tensor(rng.integers(-2**29, 2**29, (4, 4)))
    n0 = T.KR.launches
    _same(T.fwht4x4(res.to(dev)), T.fwht4x4_plain(res.to(dev)),
          T.fwht4x4(res))
    coeff = torch.as_tensor(rng.integers(-2**16, 2**16, (1000, 4, 4)),
                            dtype=torch.int32)
    coeff[0] = torch.as_tensor(rng.integers(-2**31, 2**31, (4, 4)))
    pred = torch.as_tensor(rng.integers(0, 1 << bd, (1000, 4, 4)),
                           dtype=torch.int32)
    _same(T.iwht4x4_add(coeff.to(dev), pred.to(dev), bd),
          T.iwht4x4_add_plain(coeff.to(dev), pred.to(dev), bd),
          T.iwht4x4_add(coeff, pred, bd))
    assert T.KR.launches == n0 + 2


def test_kr_takes_other_integer_types(dev):
    """uint8 predictions give a uint8 recon; int16 residuals are read as
    int32; empty batches launch nothing."""
    rng = np.random.default_rng(9)
    pred = torch.as_tensor(rng.integers(0, 256, (40, 8, 16)),
                           dtype=torch.uint8)
    coeff = torch.as_tensor(rng.integers(-900, 900, (40, 16, 8)),
                            dtype=torch.int32)
    got = T.inv_txfm2d_add(coeff.to(dev), pred.to(dev), 8, 4)
    assert got.dtype == torch.uint8
    _same(got, T.inv_txfm2d_add(coeff, pred, 8, 4))
    res = torch.as_tensor(rng.integers(-255, 256, (40, 16, 4)),
                          dtype=torch.int16)
    _same(T.fwd_txfm2d(res.to(dev), 13, 6), T.fwd_txfm2d(res, 13, 6))
    n0 = T.KR.launches
    assert T.fwd_txfm2d(torch.zeros((0, 4, 4), dtype=torch.int32,
                                    device=dev), 0, 0).shape == (0, 4, 4)
    assert T.KR.launches == n0


def test_kr_raises_on_an_invalid_pair_before_launching(dev):
    n0 = T.KR.launches
    with pytest.raises(ValueError, match="tx_size 3, tx_type 1"):
        T.fwd_txfm2d(torch.zeros((2, 32, 32), dtype=torch.int32,
                                 device=dev), 3, 1)
    with pytest.raises(ValueError, match="tx_size 4, tx_type 9"):
        T.inv_txfm2d_add(torch.zeros((2, 64, 64), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((2, 64, 64), dtype=torch.int32,
                                     device=dev), 4, 9)
    with pytest.raises(ValueError, match="bd must be"):
        T.inv_txfm2d_add(torch.zeros((2, 4, 4), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((2, 4, 4), dtype=torch.int32,
                                     device=dev), 0, 0, bd=9)
    assert T.KR.launches == n0
