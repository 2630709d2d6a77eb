"""Port parity of the subpel refinement: ``subpel_refine`` (three levels of
9 neighbours, each level one ``subpel_predict``) and
``batched_subpel_refine`` (the 49-point quarter-pel lattice, the plain
version of kernel KM) of ``aom_av1_psy_tpu_torch.ops.mvsearch`` on CPU
tensors against the reference's jnp branch (the device program KM
replaces) and its numpy branch: the reference's planted half- and
quarter-pel cases (``tests/test_mvsearch.py:75-107``), flat blocks on which
every candidate ties (the first-index rule), random blocks, and blocks
planted at every lattice point, at 4x4 to 16x16 and at 128x128 and
128x64 (AV1's largest blocks, which KM takes on the card since it was
repaired), every interp filter; the block sizes KM's wrapper takes on the
card.
Tolerance: exact equality (MVs and SADs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import convolve as RC
from aom_av1_psy_tpu.ops import mvsearch as RMV
from aom_av1_psy_tpu_torch.ops import mvsearch as MV
from torch_threads import one_torch_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def test_refine_recovers_half_pel():
    """The reference's planted case: src is the ref at +1/2 pel across."""
    rng = np.random.default_rng(23)
    h = w = 16
    big = rng.integers(0, 256, (h + 32, w + 32), np.int32)
    reg = big[16 - 3:16 + h + 4, 16 - 3:16 + w + 4]
    src = np.asarray(RC.predict_subpel(reg, w, h, 8, 0))
    ref_pad = big[16 - 4:16 + h + 5, 16 - 4:16 + w + 5]
    got = MV.subpel_refine(t(src), t(ref_pad), (0, 0))
    assert got == ((0, 4), 0)
    assert got == RMV.subpel_refine(src, ref_pad, (0, 0))


def test_batched_refine_recovers_planted_phases():
    """The reference's planted case: phases (0, 0), (4, 0), (0, 12)."""
    rng = np.random.default_rng(29)
    h = w = 8
    B = 3
    big = rng.integers(0, 256, (B, h + 32, w + 32), np.int32)
    phases = [(0, 0), (4, 0), (0, 12)]
    src = np.stack([np.asarray(RC.predict_subpel(
        big[b, 16 - 3:16 + h + 4, 16 - 3:16 + w + 4], w, h, sx, sy))
        for b, (sy, sx) in enumerate(phases)])
    win = big[:, 16 - 4:16 + h + 5, 16 - 4:16 + w + 5]
    mv8, sads = MV.batched_subpel_refine(t(src), t(win),
                                         torch.zeros((B, 2), dtype=torch.int32))
    assert (sads == 0).all()
    np.testing.assert_array_equal(
        mv8.numpy(), [[sy // 2, sx // 2] for (sy, sx) in phases])


def refine_cases(h, w, seed, interp=0, B=12):
    """src (B, h, w), windows (B, h+9, w+9), full-pel MVs (B, 2), numpy
    int32: blocks planted at lattice points (0-3), flat blocks in flat
    windows where every candidate ties (4-5), noise (6+)."""
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 256, (B, h + 9, w + 9)).astype(np.int32)
    src = rng.integers(0, 256, (B, h, w)).astype(np.int32)
    for b, k in enumerate(rng.integers(0, 49, 4)):
        r8, c8 = 8 + 2 * (k // 7 - 3), 8 + 2 * (k % 7 - 3)
        reg = win[b, r8 >> 3:(r8 >> 3) + h + 7, c8 >> 3:(c8 >> 3) + w + 7]
        src[b] = np.asarray(RC.predict_subpel(reg, w, h, (c8 & 7) << 1,
                                              (r8 & 7) << 1, interp, interp))
    win[4:6] = 128
    src[4] = 128                           # ties at SAD 0
    src[5] = 60                            # ties at 68 * h * w
    mvs = rng.integers(-16, 17, (B, 2)).astype(np.int32)
    return src, win, mvs


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (8, 16),
                                 (128, 128), (64, 128)])
def test_batched_refine_matches_jnp_and_numpy(h, w, interp):
    src, win, mvs = refine_cases(h, w, h * 10 + w + interp, interp)
    got = MV.batched_subpel_refine(t(src), t(win), t(mvs), interp)
    assert all(g.dtype == torch.int32 for g in got)
    for wrap in (jnp.asarray, np.asarray):
        want = RMV.batched_subpel_refine(wrap(src), wrap(win), wrap(mvs),
                                         interp)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[1][:4] == 0).all()
    # flat: all 49 tie; the first lattice point (-6, -6) wins
    np.testing.assert_array_equal(got[0][4:6].numpy(), mvs[4:6] * 8 - 6)


@pytest.mark.parametrize("interp", [0, 2])
@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16)])
def test_refine_matches_reference(h, w, interp):
    src, win, _ = refine_cases(h, w, h + w + 100 * interp, interp)
    for b in range(src.shape[0]):
        got = MV.subpel_refine(t(src[b]), t(win[b]), (b - 3, 5 - b),
                               interp=interp)
        assert got == RMV.subpel_refine(src[b], win[b], (b - 3, 5 - b),
                                        interp=interp)
        assert got == RMV.subpel_refine(jnp.asarray(src[b]),
                                        jnp.asarray(win[b]), (b - 3, 5 - b),
                                        interp=interp)


def test_refine_first_index_on_flat_blocks():
    """Every neighbour ties at every level: the centre moves to the first
    (-1, -1) neighbour each time, and ``best`` keeps the first SAD."""
    win = np.full((17, 17), 90, np.int32)
    src = np.full((8, 8), 100, np.int32)
    got = MV.subpel_refine(t(src), t(win), (0, 0))
    assert got == RMV.subpel_refine(src, win, (0, 0))
    assert got == ((-8 + 8 - 4 - 2 - 1, -8 + 8 - 4 - 2 - 1), 640)


def test_card_sizes_are_the_powers_of_two_4_to_128():
    """``check_km_block``, the predicate KM's wrapper applies on the card,
    accepts every w and h in 2..128 (powers of two or not: the kernel's
    last row chunk may be ragged and its lane columns padded) and raises,
    naming the limit, on every other size; a meta tensor (the wrapper's
    kernel branch) raises before any launch."""
    for w in range(0, 260):
        for h in range(0, 260, 3):
            if 2 <= w <= 128 and 2 <= h <= 128:
                MV.check_km_block(w, h)
            else:
                with pytest.raises(ValueError, match="in 2..128"):
                    MV.check_km_block(w, h)
    n0 = MV.KM.launches
    for h, w in ((1, 16), (128, 256), (129, 8)):
        src = torch.zeros((2, h, w), dtype=torch.int32, device="meta")
        win = torch.zeros((2, h + 9, w + 9), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="w and h in 2..128"):
            MV.subpel_refine49(src, win)
    assert MV.KM.launches == n0
