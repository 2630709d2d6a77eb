"""Port parity of the batched analysis pipeline
(``aom_av1_psy_tpu_torch.ops.analyze``, the plain version of kernel KP) on
CPU tensors against the jitted reference ``aom_av1_psy_tpu.ops.analyze.
analyze_plane``, and of ``parallel/mesh.batched_analyze_step`` against
``sharded_analyze_step`` on 1, 2 and 8 of the virtual CPU devices of
``tests/conftest.py``; and the helpers ``blockify`` / ``unblockify``,
``_edges_from_source``, ``predict_modes`` and ``quantize_fp`` against the
reference's on the same inputs.

Planes are 64x96 (random, flat and a radial ramp on which PAETH and the
SMOOTH modes win), at (n, tx) = (4, TX_4X4) ... (32, TX_32X32) and q 20,
100, 255. The step's totals are int32 and wrap as the reference's psum
does: 1024 32x32 checkerboard blocks give tot_sse = -133693440 at q100.
Tolerance: exact equality (integer arrays and their dtypes)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.normative import tables as RT
from aom_av1_psy_tpu.normative.enums import TxSize
from aom_av1_psy_tpu.ops import analyze as RA
from aom_av1_psy_tpu.parallel import mesh as RM
from aom_av1_psy_tpu_torch.ops import analyze as A
from aom_av1_psy_tpu_torch.parallel.mesh import batched_analyze_step
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(4, TxSize.TX_4X4), (8, TxSize.TX_8X8), (16, TxSize.TX_16X16),
         (32, TxSize.TX_32X32)]
QS = (20, 100, 255)
H, W = 64, 96


def _plane(kind):
    if kind == "random":
        return np.random.default_rng(7).integers(0, 256, (H, W)) \
            .astype(np.uint8)
    if kind == "flat":
        return np.full((H, W), 77, np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    return ((np.hypot(yy - 20, xx - 40) * 4) % 256).astype(np.uint8)


def _equal(got, want, what):
    want = np.asarray(want)
    assert got.dtype == getattr(torch, want.dtype.name), what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("kind", ["random", "flat", "radial"])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("n,tx", SIZES)
def test_analyze_plane_matches_jax(n, tx, q, kind):
    p = _plane(kind)
    dq, aq = RT.dc_quant(q), RT.ac_quant(q)
    want = RA.analyze_plane(jnp.asarray(p), dq, aq, n=n, tx_size=int(tx))
    got = A.analyze_plane(torch.as_tensor(p), dq, aq, n=n, tx_size=int(tx),
                          device="cpu")
    assert set(got) == set(want) == {"mode", "sse", "levels", "eob"}
    for k in want:
        _equal(got[k], want[k], f"{k} n={n} q={q} {kind}")
    # an int32 plane and a numpy plane give the same result
    again = A.analyze_plane(p.astype(np.int32), dq, aq, n=n,
                            tx_size=int(tx), device="cpu")
    for k in want:
        assert torch.equal(again[k], got[k])


def test_flat_plane_ties_to_dc_inside():
    """Inside a flat plane the 7 predictions tie at SSE 0: mode 0 (DC)."""
    for n, tx in SIZES:
        out = A.analyze_plane(torch.as_tensor(_plane("flat")), 40, 50, n=n,
                              tx_size=int(tx), device="cpu")
        inner = A.blockify(torch.arange(H * W).reshape(H, W), n)[:, 0, 0]
        inner = (inner // W >= n) & (inner % W >= n)
        assert (out["mode"][inner] == 0).all()
        assert (out["sse"][inner] == 0).all() and (out["eob"][inner] == 0) \
            .all()


@pytest.mark.parametrize("n,tx", SIZES[:3])
def test_radial_plane_makes_paeth_and_smooth_win(n, tx):
    out = A.analyze_plane(torch.as_tensor(_plane("radial")), 40, 50, n=n,
                          tx_size=int(tx), device="cpu")
    won = set(out["mode"].tolist())
    assert 6 in won and won & {3, 4, 5}


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_blockify_round_trip(n):
    p = np.random.default_rng(n).integers(0, 256, (H, W)).astype(np.int32)
    got = A.blockify(torch.as_tensor(p), n)
    _equal(got, RA.blockify(jnp.asarray(p), n), "blockify")
    assert torch.equal(A.unblockify(got, H, W), torch.as_tensor(p))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_edges_from_source(n, dtype):
    p = np.random.default_rng(n + 1).integers(0, 256, (H, W)).astype(dtype)
    got = A._edges_from_source(torch.as_tensor(p), n)
    want = RA._edges_from_source(jnp.asarray(p), n)
    for g, w, name in zip(got, want, ("above", "left", "corner")):
        _equal(g, w, name)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_predict_modes(n):
    rng = np.random.default_rng(n + 2)
    B = 12
    above, left = (rng.integers(0, 256, (B, n)).astype(np.uint8)
                   for _ in range(2))
    corner = rng.integers(0, 256, B).astype(np.uint8)
    got = A.predict_modes(*map(torch.as_tensor, (above, left, corner)), n)
    want = RA.predict_modes(*map(jnp.asarray, (above, left, corner)), n)
    assert got.shape == (7, B, n, n)
    _equal(got, want, "predict_modes")


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_quantize_fp_at_the_largest_coefficients(shift):
    """Down to the int32 extremes, where |F| << shift and the rounding add
    wrap as jnp's int32 does, and floor division meets negatives."""
    rng = np.random.default_rng(shift)
    big = [0, 1, -1, 2**20, -2**20, 2**30 - 1, -2**30, 2**30, 2**31 - 1,
           -2**31 + 1, -2**31]
    flat = np.concatenate([
        np.array(big * 3, np.int64)[:32],
        rng.integers(-2**31, 2**31, 4 * 32 - 32)]).astype(np.int32) \
        .reshape(4, 32)
    for dq, aq in ((4, 4), (RT.dc_quant(100), RT.ac_quant(100)),
                   (RT.dc_quant(255), RT.ac_quant(255))):
        want = jax.jit(RA.quantize_fp, static_argnums=(1, 2, 3))(
            jnp.asarray(flat), dq, aq, shift)
        got = A.quantize_fp(torch.as_tensor(flat), dq, aq, shift)
        _equal(got, want, f"quantize_fp dq={dq} aq={aq} shift={shift}")


def test_analyze_plane_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple"):
        A.analyze_plane(torch.zeros((60, 96), dtype=torch.uint8), 4, 4, n=16,
                        device="cpu")
    with pytest.raises(ValueError, match="square"):
        A.analyze_plane(torch.zeros((64, 96), dtype=torch.uint8), 4, 4, n=8,
                        tx_size=int(TxSize.TX_16X16), device="cpu")


@functools.cache
def _ref_step(k, n):
    return RM.sharded_analyze_step(RM.make_mesh(k), n=n, qindex=100)


def _check_step(k, n, args):
    want = _ref_step(k, n)(*args)
    got = batched_analyze_step(n, 100, device="cpu")(*args)
    assert len(got) == 5
    for g, w, name in zip(got, want, ("modes", "levels", "eob", "tot_sse",
                                      "tot_coeff")):
        _equal(g, w, f"{name} k={k} n={n}")
    return got


@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_batched_step_matches_sharded(k, n):
    rng = np.random.default_rng(k * 10 + n)
    B = 64 if n == 8 else 16
    blocks = rng.integers(0, 256, (B, n, n)).astype(np.uint8)
    above, left = (rng.integers(0, 256, (B, n)).astype(np.uint8)
                   for _ in range(2))
    corner = rng.integers(0, 256, B).astype(np.uint8)
    _check_step(k, n, (blocks, above, left, corner))


@pytest.mark.parametrize("k", [1, 2, 8])
def test_batched_step_totals_wrap_like_psum(k):
    """1024 checkerboard 32x32 blocks (255 at the origin, default edges):
    the SSE total passes 2**31 and wraps to -133693440 in both."""
    B, n = 1024, 32
    r, c = np.mgrid[0:n, 0:n]
    blocks = np.broadcast_to(((r + c + 1) % 2 * 255).astype(np.uint8),
                             (B, n, n)).copy()
    edges = (np.full((B, n), 127, np.uint8), np.full((B, n), 129, np.uint8),
             np.full(B, 128, np.uint8))
    got = _check_step(k, n, (blocks, *edges))
    assert int(got[3]) == -133693440
    exact = int(A.analyze_blocks_plain(
        torch.as_tensor(blocks), *map(torch.as_tensor, edges),
        RT.dc_quant(100), RT.ac_quant(100), int(TxSize.TX_32X32))["sse"]
        .to(torch.int64).sum())
    assert exact > 2**31 and (exact - int(got[3])) % 2**32 == 0


@pytest.mark.parametrize("n,tx", SIZES)
def test_plane_and_step_agree_on_the_plane_edges(n, tx):
    """The step on a plane's blocks and source edges gives the plane's
    analysis, and the totals of two halves add up to the whole's."""
    p = torch.as_tensor(_plane("radial"))
    edges = A._edges_from_source(p, n)
    blocks = A.blockify(p, n)
    qidx = 100
    out = A.analyze_plane(p, RT.dc_quant(qidx), RT.ac_quant(qidx), n=n,
                          tx_size=int(tx), device="cpu")
    fn = batched_analyze_step(n, qidx, device="cpu")
    whole = fn(blocks, *edges)
    for g, k in zip(whole[:3], ("mode", "levels", "eob")):
        assert torch.equal(g, out[k])
    half = blocks.shape[0] // 2
    parts = [fn(*(t[s] for t in (blocks, *edges)))
             for s in (slice(None, half), slice(half, None))]
    for i in (3, 4):
        assert int(parts[0][i]) + int(parts[1][i]) == int(whole[i])
    assert int(whole[3]) == int(out["sse"].sum())
