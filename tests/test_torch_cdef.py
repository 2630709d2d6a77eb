"""Port parity of the device CDEF: the plain version of kernel KF
(``aom_av1_psy_tpu_torch/ops/cdef_torch.py``) against the reference's
``ops/cdef_jax.cdef_apply_fused`` on the cases of test_cdef_jax.py plus
primary-only / secondary-only / off mixes, the strength helpers at every
msb of ``var >> 6``, and ``apply_cdef_refs`` (strengths, direction search,
A/B gate) against the reference's on a frame where the gate keeps CDEF and
one where it drops it. Tolerance: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.bitstream.headers import FrameHeader
from aom_av1_psy_tpu.encoder import tpu_frame as JF
from aom_av1_psy_tpu.ops import cdef as HC
from aom_av1_psy_tpu.ops import cdef_jax as DC
from aom_av1_psy_tpu_torch.encoder import tpu_frame as TF
from aom_av1_psy_tpu_torch.ops import cdef_torch as TC
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("w,h,yp,ys,up,us,seed", [
    (176, 144, 4, 2, 3, 1, 0), (96, 64, 9, 1, 6, 2, 1),
    (352, 288, 2, 0, 1, 0, 2), (128, 128, 0, 2, 0, 1, 3),
    (176, 144, 15, 3, 12, 3, 4),
    # mixes: primary only, secondary only (luma), all off, chroma only
    (96, 64, 7, 0, 0, 0, 5), (96, 64, 0, 4, 0, 0, 6), (96, 64, 0, 0, 0, 0, 7),
    (96, 64, 0, 0, 5, 2, 8),
])
def test_cdef_apply_fused_matches_jax(w, h, yp, ys, up, us, seed):
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = h // 4, w // 4
    # planes larger than the mi area: the padding must pass through
    y = rng.integers(0, 256, (h + 16, w + 32)).astype(np.int32)
    u = rng.integers(0, 256, (h // 2 + 8, w // 2 + 16)).astype(np.int32)
    v = rng.integers(0, 256, (h // 2 + 8, w // 2 + 16)).astype(np.int32)
    skip8 = rng.random((mi_rows // 2, mi_cols // 2)) < 0.3
    nbr, nbc = h // 8, w // 8
    yb = y[:h, :w].reshape(nbr, 8, nbc, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    dirs, var = HC.find_dir_blocks(yb, 0)
    dirs, var = dirs.astype(np.int32), var.astype(np.int32)
    want = DC.cdef_apply_fused(
        tuple(jnp.asarray(p) for p in (y, u, v)), jnp.asarray(skip8),
        jnp.asarray(dirs), jnp.asarray(var), yp, ys, up, us, 5,
        mi_rows=mi_rows, mi_cols=mi_cols, nplanes=3)
    got = TC.cdef_apply_fused(
        tuple(_t(p) for p in (y, u, v)), _t(skip8), _t(dirs), _t(var), yp, ys,
        up, us, 5, mi_rows=mi_rows, mi_cols=mi_cols, nplanes=3)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_strength_helpers_match_jax_at_every_msb():
    """``_adjust_strength`` over var >> 6 at and around every power of two
    up to 2**24 (the clip at 12 hides the reference's float32 mis-floors),
    and ``_constrain`` over every threshold the strengths can give."""
    p = 2 ** np.arange(0, 25)
    v6 = np.unique(np.concatenate([p - 1, p, p + 1, [0]]))
    var = np.concatenate([v6 << 6, (v6 << 6) + 63, [1, 63]]).astype(np.int32)
    for strength in (1, 4, 15):
        want = np.asarray(DC._adjust_strength(strength, jnp.asarray(var)))
        got = TC._adjust_strength(strength, _t(var)).numpy()
        np.testing.assert_array_equal(got, want)
    diff = np.arange(-300, 301, dtype=np.int32)
    for t in range(0, 64):
        for damping in (2, 3, 5, 6):
            want = np.asarray(DC._constrain(jnp.asarray(diff),
                                            jnp.int32(t), damping))
            got = TC._constrain(_t(diff), t, damping).numpy()
            np.testing.assert_array_equal(got, want)


def _gate_case(helps: bool, seed: int):
    """Post-LPF planes and sources at 96x64: noisy planes over a smooth
    source (CDEF helps, the gate keeps it) or planes equal to the source
    (any filtering hurts, the gate drops it)."""
    rng = np.random.default_rng(seed)
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    src_y = (100 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.int32)
    src_u = np.full((h // 2, w // 2), 120, np.int32)
    src_v = (128 + (xx[::2, ::2] // 8) * 3).astype(np.int32)
    srcs = [src_y, src_u, src_v]
    if helps:
        planes = [np.clip(s + rng.normal(0, 4, s.shape).round(), 0, 255)
                  .astype(np.int32) for s in srcs]
    else:
        planes = [s.copy() for s in srcs]
    mi_skip = (rng.random((h // 4, w // 4)) < 0.2).astype(np.int32)
    return planes, srcs, mi_skip, h // 4, w // 4


@pytest.mark.parametrize("helps,q", [(True, 200), (False, 200),
                                     (True, 100)])
def test_apply_cdef_refs_matches_jax(helps, q):
    planes, srcs, mi_skip, mi_rows, mi_cols = _gate_case(helps, q)
    fh_j, fh_t = FrameHeader(width=96, height=64), \
        FrameHeader(width=96, height=64)
    JF.cdef_fixed_strengths(fh_j, q)
    TF.cdef_fixed_strengths(fh_t, q)
    want = JF.apply_cdef_refs([jnp.asarray(p) for p in planes], mi_skip,
                              fh_j, mi_rows, mi_cols, 3, srcs=srcs)
    got = TF.apply_cdef_refs([_t(p) for p in planes], mi_skip, fh_t,
                             mi_rows, mi_cols, 3, srcs=srcs)
    c_j, c_t = fh_j.cdef, fh_t.cdef
    assert (c_t.y_pri, c_t.y_sec, c_t.uv_pri, c_t.uv_sec, c_t.damping) == \
        (c_j.y_pri, c_j.y_sec, c_j.uv_pri, c_j.uv_sec, c_j.damping)
    kept = c_j.y_pri[0] != 0 or c_j.y_sec[0] != 0
    assert kept == helps                   # both gate branches are covered
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
