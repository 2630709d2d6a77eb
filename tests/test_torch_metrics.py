"""Port parity of the batched metric reducers of
``aom_av1_psy_tpu_torch.ops.metrics`` on CPU tensors (the plain versions of
kernels KN and KO) against the reference's jnp branch (the device programs
they replace) and its numpy branch: ``sad``, ``sad_x4``, ``sse``,
``variance``, ``block_error``, ``hadamard8x8`` / ``satd``, the bilinear
``subpel_project`` / ``sub_pixel_variance`` / ``sub_pixel_avg_variance``,
``obmc_sad`` / ``obmc_variance`` and ``masked_sad``; the libaom golden
values of ``tests/golden/golden_metrics2.npz`` and the satd golden value
(``tests/test_metrics.py:30``); and the host-only ``psnr``, ``ssim`` and
``psnr_hvs`` copies.

JAX runs without x64, so the jnp branch's ``astype(int64)`` is int32 and
its sums wrap where they do not fit; the port sums in int64, as the numpy
branch does. The port is held against the jnp branch at shapes where int32
does not wrap, and against the numpy branch everywhere, including a
``block_error`` case whose sum wraps in int32.
Tolerance: exact equality (integer sums; the host metrics' floats too)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.ops import metrics as RM
from aom_av1_psy_tpu_torch.ops import metrics as M
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN2 = "tests/golden/golden_metrics2.npz"


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def check(name, args, kw=None, jnp_too=True):
    """The port on CPU tensors == the numpy branch (and the jnp branch)."""
    kw = kw or {}
    got = getattr(M, name)(*(t(a) for a in args), **kw)
    got = got if isinstance(got, tuple) else (got,)
    wraps = [np.asarray] + ([jnp.asarray] if jnp_too else [])
    for wrap in wraps:
        want = getattr(RM, name)(*(wrap(a) for a in args), **kw)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype in (torch.int64, torch.int32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} {wrap.__name__}")
    return got


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (8, 32)])
def test_reducers_match_reference(h, w):
    rng = np.random.default_rng(h * 100 + w)
    B = 6
    a = rng.integers(0, 256, (B, h, w)).astype(np.uint8)
    b = rng.integers(0, 256, (B, h, w)).astype(np.uint8)
    small = np.clip(a.astype(np.int32) + rng.integers(-9, 10, (B, h, w)), 0,
                    255).astype(np.uint8)
    check("sad", (a, b))
    check("sad", (a, b[:1]))                         # broadcast
    check("sad_x4", (a, rng.integers(0, 256, (B, 4, h, w)).astype(np.uint8)))
    check("sse", (a, b))
    # variance's s * s wraps in int32 at large differences: jnp on small ones
    check("variance", (a, small))
    check("variance", (a, b), jnp_too=h * w <= 16)
    pre = rng.integers(0, 256, (B, h, w)).astype(np.int32)
    wsrc = rng.integers(0, 255 * 4096, (B, h, w)).astype(np.int32)
    mask = rng.integers(0, 4097, (B, h, w)).astype(np.int32)
    check("obmc_sad", (pre, wsrc, mask))
    check("obmc_variance", (pre, wsrc, mask), jnp_too=h * w <= 16)
    m64 = rng.integers(0, 65, (B, h, w)).astype(np.int32)
    for invert in (False, True):
        check("masked_sad", (a, b, small, m64), {"invert": invert})


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_block_error_matches_reference(shift):
    rng = np.random.default_rng(shift)
    c = rng.integers(-2000, 2000, (3, 5, 64)).astype(np.int32)
    dq = (c + rng.integers(-40, 41, c.shape)).astype(np.int32)
    check("block_error", (c, dq), {"shift": shift})
    # large coefficients: the sums pass 2^31, int32 (jnp) would wrap
    big = rng.integers(-40000, 40000, (2, 1024)).astype(np.int32)
    err, ssz = check("block_error", (big, -big), {"shift": shift},
                     jnp_too=False)
    assert int(ssz.max()) << (2 * shift) > 2 ** 31


@pytest.mark.parametrize("xo,yo", [(0, 0), (4, 0), (0, 7), (3, 5)])
@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16)])
def test_bilinear_matches_reference(h, w, xo, yo):
    rng = np.random.default_rng(h + xo * 8 + yo)
    B = 4
    ext = rng.integers(0, 256, (B, h + 1, w + 1)).astype(np.uint8)
    ref = np.clip(ext[:, :h, :w].astype(np.int32)
                  + rng.integers(-5, 6, (B, h, w)), 0, 255).astype(np.uint8)
    sec = rng.integers(0, 256, (B, h, w)).astype(np.uint8)
    check("subpel_project", (ext,), {"w": w, "h": h, "xoffset": xo,
                                     "yoffset": yo})
    check("sub_pixel_variance", (ext, ref, xo, yo))
    check("sub_pixel_avg_variance", (ext, ref, xo, yo, ref),
          jnp_too=h * w <= 64)
    check("sub_pixel_avg_variance", (ext, ref, xo, yo, sec),
          jnp_too=h * w <= 16)


def test_hadamard_and_satd_match_reference():
    rng = np.random.default_rng(7)
    x = rng.integers(-255, 256, (2, 30, 8, 8)).astype(np.int32)
    check("hadamard8x8", (x,))
    check("satd", (x,))


def test_satd_reference_value():
    """aom_hadamard_8x8_c + aom_satd_c on the reference's LCG block."""
    st = [7]

    def lcg():
        st[0] = (st[0] * 1103515245 + 12345) & 0xFFFFFFFF
        return st[0] >> 16

    src = np.array([(lcg() % 511) - 255 for _ in range(64)],
                   np.int32).reshape(8, 8)
    assert int(M.satd(t(src[None]))[0]) == 52796


def test_golden_metrics2_through_the_tensor_branch():
    g = dict(np.load(GOLDEN2))
    for c in range(8):
        xo, yo, var, sse, var2, sse2 = (int(v) for v in g[f"sp{c}_misc"])
        src = t(g[f"sp{c}_src"].astype(np.int64)[:17, :17].astype(np.int32))
        ref = t(g[f"sp{c}_ref"].astype(np.int32))
        assert tuple(map(int, M.sub_pixel_variance(src, ref, xo, yo))) == \
            (var, sse), f"sp{c}"
        sec = t(g[f"sp{c}_sec"].astype(np.int32))
        assert tuple(map(int, M.sub_pixel_avg_variance(
            src, ref, xo, yo, sec))) == (var2, sse2), f"sp{c} avg"
    for c in range(6):
        s, var, sse = (int(v) for v in g[f"ob{c}_misc"])
        pre, wsrc, mask = (t(g[f"ob{c}_{k}"].astype(np.int32))
                           for k in ("pre", "wsrc", "mask"))
        assert int(M.obmc_sad(pre, wsrc, mask)) == s, f"ob{c} sad"
        assert tuple(map(int, M.obmc_variance(pre, wsrc, mask))) == \
            (var, sse), f"ob{c} var"
    for c in range(4):
        s, invert = (int(v) for v in g[f"mk{c}_misc"])
        full = g[f"mk{c}_src"].astype(np.int32)
        src = full.reshape(-1)[:16 * 32].reshape(16, 32)[:, :16]
        ref, sec, mask = (t(g[f"mk{c}_{k}"].astype(np.int32))
                          for k in ("ref", "sec", "mask"))
        assert int(M.masked_sad(t(src), ref, sec, mask,
                                invert=bool(invert))) == s, f"mk{c}"


def test_host_metrics_equal_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (64, 80)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-12, 13, a.shape), 0,
                255).astype(np.uint8)
    assert M.psnr(a, b) == RM.psnr(a, b)
    assert M.ssim(a, b) == RM.ssim(a, b)
    ca = rng.integers(0, 256, (32, 40)).astype(np.uint8)
    cb = np.clip(ca.astype(np.int32) + 3, 0, 255).astype(np.uint8)
    assert M.psnr_hvs((a, ca, ca), (b, cb, cb)) == \
        RM.psnr_hvs((a, ca, ca), (b, cb, cb))
    with pytest.raises(TypeError):
        M.sse(jnp.asarray(a), jnp.asarray(b))


def test_kernel_inputs_pass_through_or_convert_once():
    """What KN / KO are handed: an int32 (or uint8, int16) contiguous input
    as it is, with its type code; inputs of different types as int32; a
    non-contiguous input as a contiguous copy; no type wider than 32
    bits."""
    a = torch.arange(64, dtype=torch.int32).reshape(4, 4, 4)
    b8 = a.to(torch.uint8)
    (x,), code = M._kernel_inputs([a])
    assert x is a and code == 3
    (x, y), code = M._kernel_inputs([b8, b8.to(torch.int16)])
    assert code == 3 and x.dtype == y.dtype == torch.int32
    assert torch.equal(x, a) and torch.equal(y, a)
    (x,), code = M._kernel_inputs([b8])
    assert x is b8 and code == 0
    (x,), _ = M._kernel_inputs([a.transpose(1, 2)])
    assert x.is_contiguous() and torch.equal(x, a.transpose(1, 2))
    with pytest.raises(ValueError):
        M._kernel_inputs([a.to(torch.int64)])
