"""Port parity of the normative subpel convolve: ``predict_subpel``,
``convolve_2d_sr`` / ``_x_sr`` / ``_y_sr`` and the per-item
``subpel_predict`` of ``aom_av1_psy_tpu_torch.ops.convolve`` on CPU tensors
(the plain version of kernel KL) against the reference's jnp branch (the
device program KL replaces) and its numpy branch: every interp filter x
the 16 x 16 phase pairs at w, h in {4, 8, 16} and at the sizes KL takes on
the card since its redesign (2x2, 12x20 and 20x12, which are not powers of
two, 128x128, 128x64 and 64x128), on random regions and on regions of 0
and 255 only (the clip at both ends), and the libaom golden cases of
``tests/golden/golden_convolve.npz``; KL's one-code design (a skipped pass
as identity taps) through a numpy model; the block sizes KL's wrapper
takes on the card.
Tolerance: exact equality (int32 pixels)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import convolve as RC
from aom_av1_psy_tpu_torch.ops import convolve as C
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_convolve.npz")
DIMS = (4, 8, 16)


def regions(w, h, seed, B=3):
    rng = np.random.default_rng(seed)
    reg = rng.integers(0, 256, (B, h + 7, w + 7))
    reg[-1] = rng.choice([0, 255], (h + 7, w + 7))
    return reg.astype(np.int32)


# the sizes KL takes on the card beside AV1's powers of two: the 2-wide
# chroma blocks of 4:2:0, sizes that are not powers of two, AV1's largest
WIDE = [(2, 2), (12, 20), (20, 12), (128, 128), (128, 64), (64, 128)]


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("w,h", [(w, h) for w in DIMS for h in DIMS] + WIDE)
def test_every_phase_pair_matches_jnp(w, h, interp):
    reg = regions(w, h, seed=w * 31 + h * 7 + interp)
    wants = []
    for sx in range(16):
        for sy in range(16):
            want = np.asarray(RC.predict_subpel(jnp.asarray(reg), w, h, sx,
                                                sy, interp, interp))
            got = C.predict_subpel(torch.as_tensor(reg), w, h, sx, sy,
                                   interp, interp)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"phases {sx}, {sy}")
            wants.append(want)
    # all 256 pairs again in one per-item call (KL's batch)
    B = reg.shape[0]
    ph = np.repeat(np.arange(256), B)
    got = C.subpel_predict(torch.as_tensor(np.tile(reg, (256, 1, 1))), w, h,
                           torch.as_tensor(ph // 16, dtype=torch.int32),
                           torch.as_tensor(ph % 16, dtype=torch.int32),
                           interp, interp)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(wants))


@pytest.mark.parametrize("w,h", [(8, 8), (16, 4), (4, 16)])
def test_convolve_paths_match_numpy(w, h):
    reg = regions(w, h, seed=w + h, B=5)
    t = torch.as_tensor(reg)
    for interp in range(4):
        kx = RC.filter_kernels(interp, w)[5]
        ky = RC.filter_kernels(interp, h)[11]
        for got, want in (
                (C.convolve_2d_sr(t, w, h, kx, ky),
                 RC.convolve_2d_sr(reg, w, h, kx, ky)),
                (C.convolve_x_sr(t[:, 3:3 + h], w, h, kx),
                 RC.convolve_x_sr(reg[:, 3:3 + h], w, h, kx)),
                (C.convolve_y_sr(t[:, :, 3:3 + w], w, h, ky),
                 RC.convolve_y_sr(reg[:, :, 3:3 + w], w, h, ky))):
            np.testing.assert_array_equal(got.numpy(), want)
        # the host branch is the reference's numpy code
        np.testing.assert_array_equal(
            C.predict_subpel(reg, w, h, 5, 11, interp, interp),
            RC.predict_subpel(reg, w, h, 5, 11, interp, interp))


def test_golden_cases_through_the_tensor_branch():
    g = dict(np.load(GOLDEN))
    checked = 0
    for stem in sorted(k[:-4] for k in g if k.endswith("_out")):
        parts = stem.split("_")
        filt = int(parts[1][1:])
        w, h = map(int, parts[2].split("x"))
        sx = int(parts[3][1:])
        sy = int(parts[4])
        src = g[f"{stem}_src"].astype(np.int32)
        ref = torch.as_tensor(src[13:16 + h + 4, 13:16 + w + 4].copy())
        got = C.predict_subpel(ref, w, h, sx, sy, filt, filt)
        np.testing.assert_array_equal(got.numpy(),
                                      g[f"{stem}_out"].astype(np.int32),
                                      err_msg=stem)
        checked += 1
    assert checked >= 170


def test_kernel_inputs_are_checked_before_a_launch():
    """On a tensor that is not on the card nothing is launched: the plain
    version runs. The wrapper's own checks raise on what KL does not take
    (phases outside 0..15, sizes outside 2..128)."""
    n0 = C.KL.launches
    reg = torch.zeros((2, 15, 15), dtype=torch.int32)
    ph = torch.zeros(2, dtype=torch.int32)
    C.subpel_predict(reg, 8, 8, ph, ph)
    assert C.KL.launches == n0
    meta = torch.zeros((2, 15, 15), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="subpel phase"):
        C.predict_subpel(meta, 8, 8, 16, 0)
    for w, h in ((8, 130), (1, 8), (129, 4)):
        with pytest.raises(ValueError, match="2..128"):
            C.subpel_predict(meta, w, h, ph.to("meta"), ph.to("meta"))
    with pytest.raises(ValueError, match="2..128"):
        C.predict_subpel(meta, 8, 200, 3, 5)


def test_card_sizes_are_exactly_2_to_128():
    """``check_kl_block``, the predicate KL's wrapper applies on the card,
    accepts every w and h in 2..128 and raises on every other size."""
    for w in range(0, 260):
        for h in (0, 1, 2, 3, 64, 127, 128, 129, 255):
            if 2 <= w <= 128 and 2 <= h <= 128:
                C.check_kl_block(w, h)
                C.check_kl_block(h, w)
            else:
                with pytest.raises(ValueError, match="2..128"):
                    C.check_kl_block(w, h)
                with pytest.raises(ValueError, match="2..128"):
                    C.check_kl_block(h, w)


def _i32(x):
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _one_code_model(reg, w, h, px, py, tabx, taby, bd):
    """KL's arithmetic (csrc/convolve.cu ``block_path`` and the row loop) in
    numpy: a pass that the phases skip takes the identity taps (1 at tap
    3) and no rounding, so every path runs the same x pass over the h + 7
    region rows and y pass over 8 of its outputs; int32 wrapping sums."""
    fb, r0 = C.FILTER_BITS, C.ROUND0_BITS
    eye = np.eye(8, dtype=np.int64)[3]
    kx = tabx[px].astype(np.int64) if px else eye
    ky = taby[py].astype(np.int64) if py else eye
    r1, ob = 2 * fb - r0, bd + 2 * fb - r0
    hadd = ((1 << (bd + fb - 1)) if py else 0) + (1 << (r0 - 1)) if px \
        else 0
    hsh = r0 if px else 0
    if py:
        vadd = (1 << ob) + (1 << (r1 - 1)) if px else 1 << (fb - 1)
        vsh = r1 if px else fb
        vsub = (1 << (ob - r1)) + (1 << (ob - r1 - 1)) if px else 0
    else:
        vadd, vsh, vsub = (1 << (fb - r0 - 1), fb - r0, 0) if px \
            else (0, 0, 0)
    reg = reg.astype(np.int64)
    im = np.stack([_i32(_i32(sum(int(kx[k]) * reg[r, k:k + w]
                                  for k in range(8))) + hadd) >> hsh
                   for r in range(h + 7)])
    out = np.stack([_i32((_i32(_i32(sum(int(ky[k]) * im[o + k]
                                         for k in range(8))) + vadd)
                          >> vsh) - vsub) for o in range(h)])
    return np.clip(out, 0, (1 << bd) - 1) if px or py else out


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("w,h", [(2, 2), (4, 16), (12, 20), (33, 5)])
def test_one_code_design_equals_the_plain_paths(w, h, bd):
    """The premise of KL's redesign: one code with per-block taps and
    roundings gives each of the reference's four paths, at every phase
    pair, filter and bit depth 8 / 12 (regions of 0 and the top value
    only for the bilinear filter)."""
    rng = np.random.default_rng(w * 13 + h + bd)
    for interp in range(4):
        tabx, taby = C.filter_kernels(interp, w), C.filter_kernels(interp, h)
        reg = rng.integers(0, 1 << bd, (h + 7, w + 7)).astype(np.int32)
        if interp == 3:
            reg = rng.choice([0, (1 << bd) - 1], (h + 7, w + 7)) \
                .astype(np.int32)
        t = torch.as_tensor(reg)
        for px in range(16):
            for py in range(16):
                want = C.predict_subpel_plain(t, w, h, px, py, interp,
                                              interp, bd)
                np.testing.assert_array_equal(
                    _one_code_model(reg, w, h, px, py, tabx, taby, bd),
                    want.numpy(), err_msg=f"interp {interp} phases {px}, "
                                          f"{py}")
