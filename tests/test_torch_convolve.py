"""Port parity of the normative subpel convolve: ``predict_subpel``,
``convolve_2d_sr`` / ``_x_sr`` / ``_y_sr`` and the per-item
``subpel_predict`` of ``aom_av1_psy_tpu_torch.ops.convolve`` on CPU tensors
(the plain version of kernel KL) against the reference's jnp branch (the
device program KL replaces) and its numpy branch: every interp filter x
the 16 x 16 phase pairs at w, h in {4, 8, 16}, on random regions and on
regions of 0 and 255 only (the clip at both ends), and the libaom golden
cases of ``tests/golden/golden_convolve.npz``.
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


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("w,h", [(w, h) for w in DIMS for h in DIMS])
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
    (phases outside 0..15, sizes outside 4..64)."""
    n0 = C.KL.launches
    reg = torch.zeros((2, 15, 15), dtype=torch.int32)
    ph = torch.zeros(2, dtype=torch.int32)
    C.subpel_predict(reg, 8, 8, ph, ph)
    assert C.KL.launches == n0
    meta = torch.zeros((2, 15, 15), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="subpel phase"):
        C.predict_subpel(meta, 8, 8, 16, 0)
    with pytest.raises(ValueError, match="not in 4..64"):
        C.subpel_predict(meta, 8, 12, ph.to("meta"), ph.to("meta"))
