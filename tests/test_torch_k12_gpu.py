"""Kernels KP (``analyze_blocks``) and KQ (``palette_indices``) of
``aom_av1_psy_tpu_torch`` against their plain PyTorch versions on a CUDA
device: KP at the 1080p KEY frame's shapes (the luma padded to 1088 rows
at n = 4, 8, 16, 32; the chroma planes padded to 544 rows at n = 8), on
its blocks entry with the totals (the wrapping checkerboard too); KQ at
N = 4096, K = 8, dims 1 and 2, against the plain version and the numpy
branch, and on each data type it reads (uint8, int16, int32, int64) at N
up to 4096 (one CTA) and 16384 (several, the last adding the partials),
with duplicate centroids, values past its 32-bit keys' range, data off a
16-byte boundary and N that is not whole vectors. Tolerance: exact
equality (integer outputs).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k12_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import analyze as A
from aom_av1_psy_tpu_torch.ops import palette as P
from aom_av1_psy_tpu_torch.ops.txfm import SQUARE_TX
from aom_av1_psy_tpu_torch.parallel.mesh import batched_analyze_step
from aom_av1_psy_tpu_torch.utils import testframes

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _padded(plane, rows):
    out = np.empty((rows, plane.shape[1]), np.int32)
    out[:plane.shape[0]] = plane
    out[plane.shape[0]:] = plane[-1]
    return out


def _equal(got, want):
    assert set(got) >= set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


@pytest.mark.parametrize("plane,n", [(0, 4), (0, 8), (0, 16), (0, 32),
                                     (1, 8), (2, 8)])
@pytest.mark.parametrize("q", [20, 100, 255])
def test_kp_matches_plain_at_1080p(dev, plane, n, q):
    planes = testframes.make_frame(1920, 1080).planes()
    p = torch.as_tensor(_padded(planes[plane], 1088 if plane == 0 else 544),
                        device=dev)
    dq, aq = tables.dc_quant(q), tables.ac_quant(q)
    n0 = A.KP.launches
    got = A.analyze_plane(p, dq, aq, n=n, tx_size=SQUARE_TX[n])
    assert A.KP.launches == n0 + 1
    _equal(got, A.analyze_plane_plain(p, dq, aq, n=n, tx_size=SQUARE_TX[n]))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kp_blocks_entry_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    B = 4096 // n
    args = [torch.as_tensor(rng.integers(0, 256, s), device=dev)
            .to(torch.uint8) for s in ((B, n, n), (B, n), (B, n), (B,))]
    args[0][:8] = 90                                    # flat: every tie
    fn = batched_analyze_step(n, 100, device=dev)
    n0 = A.KP.launches
    got = fn(*args)
    assert A.KP.launches == n0 + 1
    want = batched_analyze_step(n, 100, device="cpu")(*(a.cpu()
                                                        for a in args))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


# blocks a CTA of KP takes at a time (KPShape<n>::G in csrc/analyze.cu)
_KP_PER_CTA = {4: 32, 8: 32, 16: 8, 32: 1}


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kp_small_batches_on_both_entries(dev, n):
    """B = 1, 2, 3 and the blocks a CTA takes - 1, + 0, + 1 on the plane
    entry (one block row and one block column) and on the blocks entry
    with its totals."""
    G = _KP_PER_CTA[n]
    rng = np.random.default_rng(n + 77)
    dq, aq = tables.dc_quant(100), tables.ac_quant(100)
    step = batched_analyze_step(n, 100, device=dev)
    plain = batched_analyze_step(n, 100, device="cpu")
    for B in sorted({1, 2, 3, max(1, G - 1), G, G + 1}):
        for shape in ((n, B * n), (B * n, n)):
            p = rng.integers(0, 256, shape).astype(np.int32)
            n0 = A.KP.launches
            got = A.analyze_plane(torch.as_tensor(p, device=dev), dq, aq,
                                  n=n, tx_size=SQUARE_TX[n])
            assert A.KP.launches == n0 + 1
            _equal(got, A.analyze_plane_plain(torch.as_tensor(p), dq, aq,
                                              n=n, tx_size=SQUARE_TX[n]))
        args = [rng.integers(0, 256, s).astype(np.uint8)
                for s in ((B, n, n), (B, n), (B, n), (B,))]
        got = step(*(torch.as_tensor(a, device=dev) for a in args))
        want = plain(*(torch.as_tensor(a) for a in args))
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), B


@pytest.mark.parametrize("n,B", [(4, 130561), (8, 32641), (16, 8161),
                                 (32, 2041), (16, 99)])
def test_kp_totals_at_odd_batches(dev, n, B):
    """The blocks entry at odd B, past one wave of the persistent grid at
    the 1080p counts: per-block outputs and the two int32 totals."""
    rng = np.random.default_rng(B)
    args = [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((B, n, n), (B, n), (B, n), (B,))]
    args[0][::7] = 0                                    # flat blocks: eob 0
    got = batched_analyze_step(n, 100, device=dev)(
        *(torch.as_tensor(a, device=dev) for a in args))
    want = batched_analyze_step(n, 100, device="cpu")(
        *(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_kp_totals_wrap_like_the_reference(dev):
    B, n = 1024, 32
    r, c = np.mgrid[0:n, 0:n]
    blocks = np.broadcast_to(((r + c + 1) % 2 * 255).astype(np.uint8),
                             (B, n, n)).copy()
    edges = (np.full((B, n), 127, np.uint8), np.full((B, n), 129, np.uint8),
             np.full(B, 128, np.uint8))
    got = batched_analyze_step(n, 100, device=dev)(blocks, *edges)
    assert int(got[3]) == -133693440 and got[3].dtype == torch.int32


@pytest.mark.parametrize("dim", [1, 2])
def test_kq_matches_plain_and_numpy(dev, dim):
    rng = np.random.default_rng(dim)
    data = rng.integers(0, 256, 4096 * dim)
    for cents in (rng.integers(0, 256, 8 * dim),
                  np.repeat(rng.integers(0, 256, 4 * dim), 2),   # duplicates
                  np.arange(8 * dim) * 32):                       # ties
        n0 = P.KQ.launches
        got = P.calc_indices(torch.as_tensor(data, device=dev),
                             torch.as_tensor(cents, device=dev), dim)
        assert P.KQ.launches == n0 + 1
        assert got[0].dtype == torch.uint8 and got[0].device.type == "cuda"
        plain = P.calc_indices_plain(
            torch.as_tensor(data, device=dev).reshape(-1, dim),
            torch.as_tensor(cents, device=dev).reshape(-1, dim), dim)
        host = P.calc_indices(data, cents, dim)
        assert torch.equal(got[0], plain[0]) and got[1] == plain[1]
        np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
        assert got[1] == host[1]


def test_kq_raises_above_256_centroids(dev):
    data = torch.zeros(64, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        P.calc_indices(data, torch.arange(257, device=dev), 1)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32,
                                   torch.int64])
@pytest.mark.parametrize("dim", [1, 2])
def test_kq_reads_each_dtype_at_every_n(dev, dtype, dim):
    """N = 1, 4095 (not whole 16-byte vectors), 4096 (one CTA), 4097 and
    16384 (several CTAs); 8-bit samples, then values past the 32-bit keys'
    range [-1023, 1023] (the int64 distances), each with a duplicate
    centroid; the data at an offset of one point (off a 16-byte boundary);
    one launch a call."""
    rng = np.random.default_rng(dim * 10 + KQ_CODE[dtype])
    hi = {torch.uint8: 256, torch.int16: 32768, torch.int32: 1 << 24,
          torch.int64: 1 << 40}[dtype]
    lo = 0 if dtype == torch.uint8 else -hi
    for n in (1, 4095, 4096, 4097, 16384):
        for vlo, vhi in ((0, 256), (lo, hi)):
            data = torch.as_tensor(rng.integers(vlo, vhi, (n + 1) * dim)) \
                .to(dtype)
            cents = torch.as_tensor(rng.integers(vlo, vhi, 8 * dim))
            cents[dim:2 * dim] = cents[:dim]
            for d in (data[:n * dim], data[dim:]):
                for c in (cents, cents.to(dtype)):
                    n0 = P.KQ.launches
                    got = P.calc_indices(d.to(dev), c.to(dev), dim)
                    assert P.KQ.launches == n0 + 1
                    want = P.calc_indices_plain(d, c, dim)
                    assert torch.equal(got[0].cpu(), want[0]), (n, vhi)
                    assert got[1] == want[1], (n, vhi)
                    assert 1 not in set(got[0].tolist())


KQ_CODE = {torch.uint8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3}


def test_kq_raises_on_other_dtypes(dev):
    data = torch.zeros(64, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        P.calc_indices(data, torch.arange(8, device=dev), 1)
    with pytest.raises(ValueError, match="dtype"):
        P.calc_indices(data.int(), torch.arange(8., device=dev), 1)
