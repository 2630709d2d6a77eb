"""Kernel KF's frame pass on a CUDA device: its direction search against
the plain version (at 1080p, at sizes no multiple of 64, on the extreme
blocks of ``cdef_cases``), the frame pass against its plain version for
phase 3b's (pri, sec) mixes with 1 and 3 planes, with and without sources,
the launches per frame of a GOP, and ``apply_cdef_refs``'s waits for the
device. Tolerance: exact equality (integer outputs only).

Every test needs the card: it carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of jax
or of the reference package::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cdef_gpu.py
"""
import numpy as np
import pytest
import torch

from aom_av1_psy_tpu_torch.bitstream.headers import FrameHeader
from aom_av1_psy_tpu_torch.encoder import tpu_frame as TF
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.encoder.tpu_interframe import encode_video
from aom_av1_psy_tpu_torch.ops import cdef_torch as CT
from cdef_cases import as_plane, blocky, extreme_blocks
from test_torch_inter_kernels_gpu import _pan
from test_torch_kernels_gpu import _sync_count

pytestmark = pytest.mark.gpu

# phase 3b's (pri, sec) mixes as frame strengths (y_pri, y_sec, uv_pri,
# uv_sec, damping), and the 1080p P-frame's at q100
MIXES = [(4, 2, 3, 2, 5), (0, 2, 0, 2, 5), (5, 0, 4, 0, 5), (0, 0, 0, 0, 5),
         (15, 4, 12, 4, 6), (1, 1, 0, 1, 4)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _search(y, ph, pw):
    """The frame pass on one plane: its directions and variances."""
    skip8 = torch.zeros((ph // 8, pw // 8), dtype=torch.bool,
                        device=y.device)
    return CT.cdef_frame((y,), skip8, 1, 1, 0, 0, 4, mi_rows=ph // 4,
                         mi_cols=pw // 4, nplanes=1)[1:3]


@pytest.mark.parametrize("H,W,ph,pw", [(1088, 1920, 1080, 1920),
                                       (136, 200, 136, 200),
                                       (208, 336, 200, 328)])
def test_direction_search_matches_plain(dev, H, W, ph, pw):
    rng = np.random.default_rng(H)
    y = torch.as_tensor(blocky(rng, (H, W)), device=dev)
    n0 = CT.KF.variants["frame search"]
    got = _search(y, ph, pw)
    assert CT.KF.variants["frame search"] == n0 + 1
    for g, w in zip(got, CT.find_dir_plain(y, ph, pw)):
        assert torch.equal(g, w)


def test_direction_search_on_extreme_blocks(dev):
    y = torch.as_tensor(as_plane(extreme_blocks()), device=dev)
    for g, w in zip(_search(y, 8, y.shape[1]),
                    CT.find_dir_plain(y.cpu(), 8, y.shape[1])):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("with_srcs", [True, False])
@pytest.mark.parametrize("nplanes", [1, 3])
@pytest.mark.parametrize("st", MIXES)
def test_frame_kernel_matches_plain(dev, st, nplanes, with_srcs):
    rng = np.random.default_rng(sum(st) + nplanes)
    h, w = 144, 176
    planes = [blocky(rng, (h + 16, w + 32)),
              blocky(rng, (h // 2 + 8, w // 2 + 16)),
              blocky(rng, (h // 2 + 8, w // 2 + 16))][:nplanes]
    srcs = [np.clip(p + rng.integers(-9, 10, p.shape), 0, 255)
            .astype(np.int32)[:p.shape[0] - 4] for p in planes]
    skip8 = rng.random((h // 8 + 1, w // 8)) < .3
    c = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    kw = dict(mi_rows=h // 4, mi_cols=w // 4, nplanes=nplanes,
              srcs=[c(s) for s in srcs] if with_srcs else None)
    n0 = CT.KF.launches
    got = CT.cdef_frame(tuple(c(p) for p in planes), c(skip8), *st, **kw)
    assert CT.KF.launches == n0 + 1
    want = CT.cdef_frame_plain(tuple(c(p) for p in planes), c(skip8), *st,
                               **kw)
    for g, wnt in zip(got[0] + got[1:3], want[0] + want[1:3]):
        assert torch.equal(g, wnt)
    if with_srcs:
        assert torch.equal(got[3], want[3])
    else:
        assert got[3] is None
    # the entry with the directions given: the same planes
    fused = CT.cdef_apply_fused(tuple(c(p) for p in planes), c(skip8),
                                got[1], got[2], *st, mi_rows=h // 4,
                                mi_cols=w // 4, nplanes=nplanes)
    for g, wnt in zip(fused, want[0]):
        assert torch.equal(g, wnt)


def test_at_most_two_kf_launches_per_frame(dev):
    """A GOP with CDEF on every frame: one frame pass per frame that
    applies CDEF (the P-frames at least), and no other KF entry."""
    frames = _pan(96, 64, 3)
    cfg = EncoderConfig(base_q_idx=160)
    encode_video(frames, cfg, device=dev)
    CT.KF.reset()
    encode_video(frames, cfg, device=dev)
    torch.cuda.synchronize()
    assert set(CT.KF.variants) == {"frame search"}
    assert len(frames) - 1 <= CT.KF.launches <= len(frames)


def test_apply_cdef_refs_waits_for_the_device_once(dev):
    """The same number of synchronizing calls (the upload of skip8, the
    one copy of the gate's sums) whatever the frame size: no plane goes
    to the host."""
    counts = []
    for w, h in ((96, 64), (352, 288)):
        rng = np.random.default_rng(w)
        srcs = [blocky(rng, (h, w)), blocky(rng, (h // 2, w // 2)),
                blocky(rng, (h // 2, w // 2))]
        planes = [torch.as_tensor(np.clip(s + rng.integers(-8, 9, s.shape),
                                          0, 255).astype(np.int32),
                                  device=dev) for s in srcs]
        srcs = [torch.as_tensor(s, device=dev) for s in srcs]
        mi_skip = (rng.random((h // 4, w // 4)) < .2).astype(np.int32)

        def run():
            fh = FrameHeader(width=w, height=h)
            TF.cdef_fixed_strengths(fh, 200)
            TF.apply_cdef_refs(planes, mi_skip, fh, h // 4, w // 4, 3,
                               srcs=srcs)
        run()
        counts.append(_sync_count(run))
    # skip8 up, the sums down
    assert counts[0] == counts[1] and counts[0] <= 2, counts
