"""Port parity of the motion-compensation building blocks: the plain
version of kernel KD (``ops/mc.py``), the MV clamp, the clamp-bound grids
and the subpel refinement of ``aom_av1_psy_tpu_torch/encoder/tpu_inter.py``
against the JAX reference (``aom_av1_psy_tpu/encoder/tpu_inter.py``) on
the same seeded inputs. Tolerance: exact equality (integers only)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder import tpu_inter as JI
from aom_av1_psy_tpu.ops import convolve as CONV
from aom_av1_psy_tpu_torch.encoder import tpu_inter as TI
from aom_av1_psy_tpu_torch.ops import mc as MC
from torch_threads import one_torch_thread  # noqa: F401

H, W = 96, 128          # padded plane
CROP_H, CROP_W = 90, 117  # true crop: clamps stop short of the padding
KERNELS = np.stack([CONV.filter_kernels(f, 16)
                    for f in (0, 1, 2)]).astype(np.int32)

_mc_jit = jax.jit(JI._mc_blocks, static_argnames=("bw", "crop_h", "crop_w"))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@functools.cache
def _plane():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (H, W)).astype(np.int32)


def _every_phase_past_every_border(bw, rng):
    """One block per (row phase, col phase): 256 blocks whose origins sit
    on the four frame edges and whose MVs reach up to 3 blocks past the
    border on either side (negative positions included)."""
    ny, nx = H // bw, W // bw
    n = 256
    ph_y = np.repeat(np.arange(16), 16)
    ph_x = np.tile(np.arange(16), 16)
    edge = rng.integers(0, 4, n)
    by = np.where(edge == 0, 0, np.where(edge == 1, (ny - 1) * bw,
                                         rng.integers(0, ny, n) * bw))
    bx = np.where(edge == 2, 0, np.where(edge == 3, (nx - 1) * bw,
                                         rng.integers(0, nx, n) * bw))
    iy = rng.integers(-3 * bw - 8, 3 * bw + 8, n)
    ix = rng.integers(-3 * bw - 8, 3 * bw + 8, n)
    qr = 16 * iy + ph_y
    qc = 16 * ix + ph_x
    return [a.astype(np.int32) for a in (by, bx, qr, qc)]


@pytest.mark.parametrize("bw", [8, 16, 32])
def test_mc_blocks_plain_matches_jax(bw):
    rng = np.random.default_rng(bw)
    ref = _plane()
    by, bx, qr, qc = _every_phase_past_every_border(bw, rng)
    src = rng.integers(0, 256, (len(by), bw, bw)).astype(np.int32)
    preds = []
    for f in range(3):
        want = np.asarray(_mc_jit(jnp.asarray(ref), jnp.asarray(by),
                                  jnp.asarray(bx), jnp.asarray(qr),
                                  jnp.asarray(qc), bw=bw, crop_h=CROP_H,
                                  crop_w=CROP_W,
                                  kernels=jnp.asarray(KERNELS[f])))
        got = MC.mc_blocks_plain(_t(ref), _t(by), _t(bx), _t(qr), _t(qc), bw,
                                 CROP_H, CROP_W, _t(KERNELS[f]))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"f{f}")
        preds.append(want)
    # KD's plain version: the 3 families as candidates, with SAD / SSE
    K = 3
    pred, sad, sse = MC.mc_8tap(_t(ref), _t(by), _t(bx),
                                _t(np.tile(qr, (K, 1))),
                                _t(np.tile(qc, (K, 1))), bw, CROP_H, CROP_W,
                                _t(KERNELS), src=_t(src))
    want = np.stack(preds)
    np.testing.assert_array_equal(pred.numpy(), want)
    d = want - src[None]
    np.testing.assert_array_equal(sad.numpy(), np.abs(d).sum((-1, -2)))
    np.testing.assert_array_equal(sse.numpy(), (d * d).sum((-1, -2)))


@pytest.mark.parametrize("ss", [0, 1])
def test_clamp_and_edge_grids_match_jax(ss):
    rng = np.random.default_rng(11 + ss)
    R2, C2, mi_rows, mi_cols = 6, 8, 22, 30
    for bs in (16, 32):
        want = JI._edge_grids(R2, C2, mi_rows, mi_cols, bs, ss)
        got = TI._edge_grids(R2, C2, mi_rows, mi_cols, bs, ss)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        lo_r, hi_r, lo_c, hi_c = [x.reshape(-1) for x in want]
        mr = rng.integers(-600, 600, lo_r.shape).astype(np.int32)
        mc = rng.integers(-600, 600, lo_r.shape).astype(np.int32)
        w = JI._clamp_mv_q4(jnp.asarray(mr), jnp.asarray(mc), lo_r, hi_r,
                            lo_c, hi_c, ss)
        g = TI._clamp_mv_q4(_t(mr), _t(mc), _t(lo_r), _t(hi_r), _t(lo_c),
                            _t(hi_c), ss)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_subpel_refine_matches_jax():
    """Two 9-candidate steps with exact-MC SAD, ties to the first
    candidate of the dr-major order (a flat region ties everywhere)."""
    rng = np.random.default_rng(3)
    ref = _plane().copy()
    ref[:32, :64] = 77                               # flat: every SAD ties
    R2, C2 = H // 16, W // 16
    B = R2 * C2
    gy = (16 * (np.arange(B) // C2)).astype(np.int32)
    gx = (16 * (np.arange(B) % C2)).astype(np.int32)
    src = np.stack([ref[y:y + 16, x:x + 16] for y, x in zip(gy, gx)])
    src = np.clip(src + rng.integers(-9, 10, src.shape), 0, 255) \
        .astype(np.int32)
    mv_r = rng.integers(-40, 41, B).astype(np.int32)
    mv_c = rng.integers(-40, 41, B).astype(np.int32)
    grids = JI._edge_grids(R2, C2, H // 4, W // 4, 16, 0)
    lo = [x.reshape(-1) for x in grids]
    ref_fn = jax.jit(JI._subpel_refine, static_argnames=("crop_h", "crop_w"))
    want = ref_fn(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(gy),
                  jnp.asarray(gx), jnp.asarray(mv_r), jnp.asarray(mv_c),
                  *[jnp.asarray(x) for x in lo], crop_h=CROP_H,
                  crop_w=CROP_W, kernels=jnp.asarray(KERNELS[0]))
    got = TI._subpel_refine(_t(src), _t(ref), _t(gy), _t(gx), _t(mv_r),
                            _t(mv_c), *[_t(x) for x in lo], CROP_H, CROP_W,
                            _t(KERNELS[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
