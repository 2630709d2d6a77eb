"""Kernel KO's lane layout (``csrc/metrics.cu`` ``ko_kernel``), modelled in
numpy and held to the reference's ``hadamard8x8`` / ``satd``
(``aom_av1_psy_tpu/ops/metrics.py:62,97``) on the CPU (no card).

KO gives each row of an 8x8 block one lane (8 lanes a block, 4 blocks a
warp). A lane reads its row as 32-bit words (two 16-byte loads at int32,
one at int16, one 8-byte load at 8 bits) and splits them with the
kernel's shifts; it runs the row butterflies in registers; the column
butterflies are three xor-shuffle rounds (masks 1, 2, 4) among the
block's lanes, lane r keeping ``mine + other`` where bit s of r is clear
and taking ``other - mine`` where it is set, in wrapping uint32; satd is
each lane's int64 sum of its 8 int32 |t| (INT32_MIN stays negative, as
numpy's abs wraps), added over the 8 lanes by three more xor rounds.
``ko_model`` is that order; it must equal the reference on seeded random
blocks of all four input types, on blocks at INT32_MIN / INT32_MAX that
wrap, and on a batch that does not fill its last warp.
Tolerance: exact equality (integer outputs)."""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import metrics as RM
from aom_av1_psy_tpu_torch.ops import metrics as M
from torch_threads import one_torch_thread  # noqa: F401

U32 = np.uint32


def _words(x):
    """Each lane's row as the 32-bit little-endian words its vector loads
    bring: (lanes, 8 * itemsize / 4) uint32."""
    rows = np.ascontiguousarray(x).reshape(-1, 8)
    return rows.view("<u4").reshape(rows.shape[0], -1)


def _split(words, dtype):
    """The kernel's ``ko_load``: words to 8 int32 values (as uint32) per
    lane, by its shifts (arithmetic right shifts of int32 for the signed
    types)."""
    w = words.astype(U32)
    s = w.view(np.int32)
    if dtype == np.int32:
        return w
    if dtype == np.int16:
        lo = ((w << U32(16)).view(np.int32) >> 16).view(U32)
        hi = (s >> 16).view(U32)
        return np.stack([lo, hi], -1).reshape(len(w), 8)
    out = []
    for i in range(8):
        wi = w[:, i // 4]
        if dtype == np.int8:
            sh = U32(24 - 8 * (i % 4))
            out.append(((wi << sh).view(np.int32) >> 24).view(U32))
        else:
            out.append((wi >> U32(8 * (i % 4))) & U32(0xFF))
    return np.stack(out, -1)


def _wht8_rows(v):
    """The row pass in registers: strides 1, 2, 4, (j, j + s) -> (sum,
    difference), uint32."""
    v = v.copy()
    for s in (1, 2, 4):
        for base in range(0, 8, 2 * s):
            for j in range(base, base + s):
                p, q = v[:, j].copy(), v[:, j + s].copy()
                v[:, j], v[:, j + s] = p + q, p - q
    return v


def ko_model(x):
    """KO's order over (B, 8, 8) blocks: (transform (B, 8, 8) int32, satd
    (B,) int64). Lanes are block-major, row-minor; the batch is padded to
    whole warps (4 blocks) with zero lanes, as the kernel's lanes past B
    load zeros."""
    B = x.shape[0]
    pad = -B % 4
    xp = np.concatenate([x, np.zeros((pad, 8, 8), x.dtype)])
    v = _wht8_rows(_split(_words(xp), x.dtype))        # (lanes, 8)
    lane = np.arange(len(v)) & 7
    for s in (1, 2, 4):
        other = v[np.arange(len(v)) ^ s]
        v = np.where(((lane & s) != 0)[:, None], other - v, v + other)
    t = v.view(np.int32)
    mag = np.where(t < 0, (U32(0) - v), v).view(np.int32).astype(np.int64)
    sums = mag.sum(1)
    for s in (1, 2, 4):
        sums = sums + sums[np.arange(len(sums)) ^ s]
    return t.reshape(-1, 8, 8)[:B], sums[::8][:B]


def _blocks(dtype, B, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, int(info.max) + 1, (B, 8, 8)).astype(dtype)
    if dtype == np.int32:                           # residual-sized blocks
        x[: B // 2] = rng.integers(-255, 256, (B // 2, 8, 8))
    return x


@pytest.mark.parametrize("B", [1, 3, 5, 64])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.int32])
def test_model_equals_the_reference(dtype, B):
    x = _blocks(dtype, B, B * 7 + np.dtype(dtype).itemsize)
    t, s = ko_model(x)
    np.testing.assert_array_equal(t, RM.hadamard8x8(x))
    np.testing.assert_array_equal(s, RM.satd(x))
    assert s.dtype == np.int64


def test_model_wraps_as_the_reference():
    """INT32_MIN / INT32_MAX blocks: the butterflies wrap, an output of
    INT32_MIN keeps its sign in the sum (numpy's abs of it wraps)."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    x = np.zeros((6, 8, 8), np.int32)
    x[0] = hi
    x[1] = lo
    x[2, ::2] = hi
    x[2, 1::2] = lo
    x[3] = np.where(np.indices((8, 8)).sum(0) % 2, hi, lo)
    x[4, 0, 0] = lo                       # a lone INT32_MIN: 64 of them out
    x[5] = np.random.default_rng(0).choice([lo, hi, -1, 1], (8, 8))
    t, s = ko_model(x)
    want_t, want_s = RM.hadamard8x8(x), RM.satd(x)
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(s, want_s)
    assert (want_t == lo).any() and (want_s < 0).any()


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.int32])
def test_plain_version_equals_the_model(dtype):
    """The plain version (what CPU tensors run, and what the card's kernel
    is held against) equals the model, so the three agree."""
    x = _blocks(dtype, 37, 99)
    t, s = ko_model(x)
    xt = torch.as_tensor(x)
    assert torch.equal(M.hadamard8x8(xt), torch.as_tensor(t))
    assert torch.equal(M.satd(xt), torch.as_tensor(s))
