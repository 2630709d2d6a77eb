"""The premises of KI's and KG's designs (``csrc/tune_vmaf.cu``), held on
the CPU through plain PyTorch models of the kernels' order of work.

- KI sums each of its five box quantities (r, d and the float32 products
  r*r, d*d, r*d) as running 9-sums in float64 (the entering value less the
  leaving one added at each step), down the rows and then along the
  columns, unscaled; it multiplies by f32(1/81) once and rounds to
  float32 once. On ``vif_lite``'s pyramid (8-bit pixels times 16^-s) every
  such value is a multiple of 2^-24 below 2^16, so the sums are exact in any
  order: the model equals the plain version's direct 81-tap float64 sums bit
  for bit at all four scales, and its (num, den) are within ``VIF_RTOL``
  (1e-4) of ``vif_scale_plain`` and of the JAX reference's; off that grid
  (normals times 100) the model stays within ``VIF_RTOL``.
- KG blurs each strip (``KG_ROWS`` rows of a band of ``KG_BAND`` columns)
  from its own edge-replicated 2-px halo (taps 0, 6 and 7 are 0) and sums
  the moments per strip: the model equals ``gaussian_blur_plain`` and
  ``blur_moments_plain`` at the strips' edge sizes, and a strip's sums fit
  the int32 the kernel keeps them in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu.encoder import tune_vmaf as JT
from aom_av1_psy_tpu_torch.encoder import tune_vmaf as TT
from test_torch_tune_vmaf import SERVO
from torch_threads import one_torch_thread  # noqa: F401

VIF_RTOL = 1e-4
K81 = float(np.float32(1.0 / 81.0))


def _running9(x, dim):
    """Running 9-sums of float64 ``x`` along ``dim`` (VALID), as KI forms
    them: add the entering value less the one that leaves."""
    x = x.movedim(dim, 0)
    acc, out = torch.zeros_like(x[0]), []
    for i in range(x.shape[0]):
        acc = acc + (x[i] - x[i - TT.VIF_WIN] if i >= TT.VIF_WIN else x[i])
        if i >= TT.VIF_WIN - 1:
            out.append(acc)
    return torch.stack(out).movedim(0, dim)


def _box_model(x):
    """KI's box mean of float32 ``x``: float64 running sums down the rows,
    then along the columns, unscaled; times f32(1/81), then float32."""
    v = _running9(_running9(x.to(torch.float64), 0), 1)
    return (v * K81).to(torch.float32)


def _quantities(r, d):
    return r, d, r * r, d * d, r * d


def _vif_model(r, d):
    """(num, den) of one scale from the model's box means; the rest as
    ``vif_scale_plain`` (and KI) form it in float32."""
    mr, md, mrr, mdd, mrd = (_box_model(q) for q in _quantities(r, d))
    var_r = torch.clamp(mrr - mr * mr, min=0.0)
    var_d = torch.clamp(mdd - md * md, min=0.0)
    cov = mrd - mr * md
    g = cov / (var_r + 1e-10)
    sv = torch.clamp(var_d - g * cov, min=0.0)
    num = torch.log2(1.0 + g * g * var_r / (sv + 2.0)).sum()
    den = torch.log2(1.0 + var_r / 2.0).sum()
    return torch.stack([num, den])


def _jax_sums(r, d):
    """The reference's (num, den) of one scale (``_vif_scale`` returns only
    their ratio): its ``_moments`` and its box convolution of r*d."""
    r, d = jnp.asarray(r.numpy()), jnp.asarray(d.numpy())
    mu_r, var_r = JT._moments(r)
    mu_d, var_d = JT._moments(d)
    k = jnp.ones((9, 9), jnp.float32) / 81.0
    rd = jax.lax.conv_general_dilated((r * d)[None, None], k[None, None],
                                      (1, 1), "VALID")[0, 0]
    cov = rd - mu_r * mu_d
    g = cov / (var_r + 1e-10)
    sv = jnp.maximum(var_d - g * cov, 0.0)
    num = jnp.log2(1.0 + g * g * var_r / (sv + 2.0)).sum()
    den = jnp.log2(1.0 + var_r / 2.0).sum()
    return np.asarray([num, den], np.float32)


def _pyramid(name):
    """vif_lite's four scales of (frame, its blur) for a SERVO frame."""
    y = torch.as_tensor(SERVO[name])
    r = y.to(torch.float32)
    d = TT.gaussian_blur_plain(y).to(torch.float32)
    out = [(r, d)]
    for _ in range(3):
        r, d = TT.down2_plain(r), TT.down2_plain(d)
        out.append((r, d))
    return out


@pytest.mark.parametrize("name", sorted(SERVO))
def test_ki_order_equals_direct_sums_on_the_pyramid(name):
    for s, (r, d) in enumerate(_pyramid(name)):
        assert r.shape[0] >= TT.VIF_WIN and r.shape[1] >= TT.VIF_WIN
        for q in _quantities(r, d):
            # the premise: multiples of 2^-24 below 2^16
            q64 = q.to(torch.float64) * 2.0 ** 24
            assert torch.equal(q64, torch.round(q64)), (name, s)
            assert float(q.abs().max()) < 2.0 ** 16
            assert torch.equal(_box_model(q), TT._box(q)), (name, s)


@pytest.mark.parametrize("name", sorted(SERVO))
def test_ki_order_sums_within_tolerance_of_plain_and_jax(name):
    for s, (r, d) in enumerate(_pyramid(name)):
        got = _vif_model(r, d)
        torch.testing.assert_close(got, TT.vif_scale_plain(r, d),
                                   rtol=VIF_RTOL, atol=0)
        want = _jax_sums(r, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=VIF_RTOL)
        ratio = float(JT._vif_scale(jnp.asarray(r.numpy()),
                                    jnp.asarray(d.numpy())))
        assert float(got[0] / max(float(got[1]), 1e-10)) == \
            pytest.approx(ratio, rel=VIF_RTOL), (name, s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ki_order_off_the_grid_within_tolerance(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = (rng.standard_normal((61, 83)) for _ in range(2))
    r = torch.as_tensor(n1 * 100.0, dtype=torch.float32)
    for d in (torch.as_tensor(n2 * 100.0, dtype=torch.float32),
              torch.as_tensor(70.0 * n1 + 30.0 * n2, dtype=torch.float32)):
        torch.testing.assert_close(_vif_model(r, d),
                                   TT.vif_scale_plain(r, d),
                                   rtol=VIF_RTOL, atol=0)


def _blur_strips(y):
    """KG's partition on the CPU: each strip of ``KG_ROWS`` rows of a band
    of ``KG_BAND`` columns blurred from its own halo of 2 rows and columns
    (clamped to the frame: edge replicate), its moments summed alone."""
    H, W = y.shape
    out = torch.empty((H, W), dtype=torch.int32)
    mom = torch.zeros(4, dtype=torch.int64)
    for r0 in range(0, H, TT.KG_ROWS):
        for c0 in range(0, W, TT.KG_BAND):
            r1, c1 = min(r0 + TT.KG_ROWS, H), min(c0 + TT.KG_BAND, W)
            rows = torch.arange(r0 - 2, r1 + 2).clamp(0, H - 1)
            cols = torch.arange(c0 - 2, c1 + 2).clamp(0, W - 1)
            strip = TT.gaussian_blur_plain(y[rows][:, cols])[
                2:2 + r1 - r0, 2:2 + c1 - c0]
            out[r0:r1, c0:c1] = strip
            mom += TT.blur_moments_plain(y[r0:r1, c0:c1], strip)
    return out, mom


def test_kg_strip_sums_fit_int32():
    """A warp's strip (KG_BAND columns, KG_ROWS rows) sums s^2 and d^2 of
    up to 255^2 each in int32."""
    assert TT.KG_BAND * TT.KG_ROWS * 255 ** 2 < 2 ** 31


@pytest.mark.parametrize("h", [1, 7, 8, 9, 16, 17, 65])
@pytest.mark.parametrize("w", [1, 3, 5, 127, 129])
def test_kg_strips_equal_plain(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    y[: (h + 3) // 4, : (w + 3) // 4] = 255
    for t in (torch.as_tensor(y), torch.as_tensor(y.astype(np.int32))):
        want = TT.gaussian_blur_plain(t)
        got, mom = _blur_strips(t)
        assert torch.equal(got, want)
        assert torch.equal(mom, TT.blur_moments_plain(t, want))
